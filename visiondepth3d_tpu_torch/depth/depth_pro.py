"""Apple Depth Pro: a multi-scale patched DINOv2 encoder, a DPT-style
fusion with transposed-conv upsampling, a depth head and a field-of-view
head.

Counterpart of ``visiondepth3d_tpu/depth/depth_pro.py``. The image is
rescaled to ``scaled_images_ratios``, each scale is cut into overlapping
``patch_size`` windows, and every window of every scale runs through one
shared DINOv2 (the patch encoder) as one batch; the windows are merged back
with ``merge_padding_value`` trimmed at their seams. A second DINOv2 (the
image encoder) sees the whole image at its native size, a third one feeds
the field-of-view head. The three ViTs are the port's ``dinov2.py`` blocks,
so each reaches K7 through ``ops/attention.py:multi_head_attention``.

Parameter names are transformers' ``DepthProForDepthEstimation``
(``depth_pro.encoder.*``, ``depth_pro.neck.*``, ``fusion_stage.*``,
``head.layers.*``, ``fov_model.*``), the names the JAX package's
``convert_depth_pro`` reads, so one state dict loads into both. Tensors are
NCHW.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.resize import resize_bilinear
from ..utils.observability import count, span
from .configs import ViTConfig
from .dinov2 import Embeddings, Encoder
from .dpt import PreActResidual, _conv3

# transformers keys the port's model does not hold: the masked-image tokens
UNUSED_HF_KEYS = ("depth_pro.encoder.patch_encoder.model.embeddings.mask_token",
                  "depth_pro.encoder.image_encoder.model.embeddings.mask_token",
                  "fov_model.fov_encoder.model.embeddings.mask_token")

# the most elements a tensor of one frame group holds in the decoder
# (``frame_groups``, ``DepthPro.forward``)
MAX_ELEMENTS = 2 ** 31 - 1

# DINOv2-L/16 at 384^2, the three encoders of apple/DepthPro-hf (config.json)
_VIT_L16_384 = ViTConfig(hidden_size=1024, num_layers=24, num_heads=16, patch_size=16,
                         image_size=384)


@dataclasses.dataclass(frozen=True)
class DepthProConfig:
    """Depth Pro at the published widths of ``apple/DepthPro-hf``
    (``config.json``): three DINOv2-L/16 encoders at 384^2 (hidden 1024, 24
    layers, 16 heads), 384^2 windows over the image at ratios 0.25, 0.5 and
    1 with overlaps 0, 0.5 and 0.25, hooks on blocks 11 and 5, fusion width
    256. The JAX catalog's ``DepthProConfig()`` holds ViT-S/14 encoders
    instead, which no published checkpoint fits (ROADMAP Queue 3, F10)."""

    patch_model: ViTConfig = _VIT_L16_384
    image_model: ViTConfig = _VIT_L16_384
    fov_model: ViTConfig = _VIT_L16_384
    patch_size: int = 384  # the window over the scaled images
    scaled_images_ratios: tuple = (0.25, 0.5, 1.0)
    scaled_images_overlap_ratios: tuple = (0.0, 0.5, 0.25)
    scaled_images_feature_dims: tuple = (1024, 1024, 512)
    intermediate_hook_ids: tuple = (11, 5)
    intermediate_feature_dims: tuple = (256, 256)
    fusion_hidden_size: int = 256
    merge_padding_value: int = 3
    num_fov_head_layers: int = 2
    use_fov_model: bool = True


_VIT_TINY = ViTConfig(hidden_size=32, num_layers=4, num_heads=2, patch_size=16, image_size=32,
                      layerscale=True)
# the JAX package's tiny config (tests)
DEPTH_PRO_TINY = DepthProConfig(
    patch_model=_VIT_TINY, image_model=_VIT_TINY, fov_model=_VIT_TINY, patch_size=32,
    scaled_images_ratios=(0.5, 1.0), scaled_images_overlap_ratios=(0.0, 0.25),
    scaled_images_feature_dims=(16, 16), intermediate_hook_ids=(1,),
    intermediate_feature_dims=(16,), fusion_hidden_size=16, merge_padding_value=1,
    num_fov_head_layers=1)


class _Holder(nn.Module):
    """A named container: transformers' nesting of the submodules."""

    def __init__(self, **modules: nn.Module):
        super().__init__()
        for name, module in modules.items():
            setattr(self, name, module)


class Dinov2Trunk(nn.Module):
    """DINOv2 returning the last hidden state after the final LayerNorm and
    the raw outputs of the blocks in ``taps`` (0-based; Depth Pro taps raw
    intermediates), in the order of ``taps``. Only those are kept: a block's
    output is freed once the next block has read it."""

    def __init__(self, cfg: ViTConfig, taps: tuple = ()):
        super().__init__()
        self.cfg = cfg
        self.taps = tuple(taps)
        self.embeddings = Embeddings(cfg)
        self.encoder = Encoder(cfg)
        self.layernorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, pixels):  # [B, 3, H, W] -> [B, N, C], [[B, N, C]] * len(taps)
        p = self.cfg.patch_size
        x = self.embeddings(pixels, (pixels.shape[2] // p, pixels.shape[3] // p))
        tapped = {}
        for i, block in enumerate(self.encoder.layer):
            x = block(x)
            if i in self.taps:
                tapped[i] = x
        return self.layernorm(x), [tapped[i] for i in self.taps]


def split_to_patches(x: torch.Tensor, patch: int, overlap_ratio: float):
    """[B, C, H, W] -> ([n * B, C, patch, patch], n): windows row-major,
    each window's batch contiguous."""
    h, w = x.shape[2], x.shape[3]
    if h == patch and w == patch:
        return x, 1
    stride = int(patch * (1 - overlap_ratio))
    tiles = [x[:, :, y: y + patch, xx: xx + patch]
             for y in range(0, h - patch + 1, stride) for xx in range(0, w - patch + 1, stride)]
    return torch.cat(tiles, dim=0), len(tiles)


def reshape_features(tokens: torch.Tensor) -> torch.Tensor:
    """[N, seq, C] -> [N, C, s, s], the special tokens dropped."""
    n, seq, c = tokens.shape
    s = math.isqrt(seq)
    return tokens[:, -(s * s):].reshape(n, s, s, c).permute(0, 3, 1, 2)


def merge_patches(patches: torch.Tensor, batch_size: int, padding: int) -> torch.Tensor:
    """[k * k * B, C, s, s] -> [B, C, S, S], ``padding`` trimmed at the
    inner seams (none under 4 windows, at most s // 4)."""
    nb, _, s, _ = patches.shape
    if nb == batch_size:
        return patches
    n_per = nb // batch_size
    k = math.isqrt(n_per)
    padding = 0 if n_per < 4 else min(s // 4, padding)
    rows = []
    for hh in range(k):
        row = []
        for ww in range(k):
            i = hh * k + ww
            box = patches[batch_size * i: batch_size * (i + 1)]
            top = padding if hh != 0 else 0
            bottom = padding if hh != k - 1 else 0
            left = padding if ww != 0 else 0
            right = padding if ww != k - 1 else 0
            row.append(box[:, :, top: s - bottom, left: s - right])
        rows.append(torch.cat(row, dim=3))
    return torch.cat(rows, dim=2)


def reconstruct(tokens, batch_size: int, padding: int, out_hw) -> torch.Tensor:
    f = merge_patches(reshape_features(tokens), batch_size, padding)
    return resize_bilinear(f, tuple(out_hw), align_corners=False, channel_last=False)


def frame_groups(frames: int, per_frame: int) -> list[slice]:
    """Consecutive slices of ``frames`` frames, near-equal, so that no group
    of a tensor of ``per_frame`` elements a frame passes ``MAX_ELEMENTS``:
    the fewest groups of at most that many frames, ``ceil(frames / n)``
    frames each, then the rest."""
    n = math.ceil(frames / max(1, MAX_ELEMENTS // per_frame))
    size = math.ceil(frames / n)
    return [slice(i, min(i + size, frames)) for i in range(0, frames, size)]


def _deconv(cin: int, cout: int, bias: bool) -> nn.ConvTranspose2d:
    return nn.ConvTranspose2d(cin, cout, 2, stride=2, bias=bias)


class UpsampleBlock(nn.Module):
    """An optional bias-free 1x1 projection, then ``n_layers`` 2x transposed
    convs (``layers.*``)."""

    def __init__(self, cin: int, intermediate: int, out: int, n_layers: int,
                 use_proj: bool = True, bias: bool = False):
        super().__init__()
        layers = [nn.Conv2d(cin, intermediate, 1, bias=bias)] if use_proj else []
        c = intermediate if use_proj else cin
        for _ in range(n_layers):
            layers.append(_deconv(c, out, bias))
            c = out
        self.layers = nn.ModuleList(layers)

    def forward(self, x):
        for layer in self.layers:
            x = layer(x)
        return x


class FusionLayer(nn.Module):
    """The first layer has no residual input (its ``residual_layer1`` is in
    the checkpoint, unused)."""

    def __init__(self, features: int, use_deconv: bool = True):
        super().__init__()
        self.residual_layer1 = PreActResidual(features)
        self.residual_layer2 = PreActResidual(features)
        if use_deconv:
            self.deconv = _deconv(features, features, False)
        self.use_deconv = use_deconv
        self.projection = nn.Conv2d(features, features, 1)

    def forward(self, x, residual=None):
        if residual is not None:
            x = x + self.residual_layer1(residual)
        x = self.residual_layer2(x)
        if self.use_deconv:
            x = self.deconv(x)
        return self.projection(x)


class DepthPro(nn.Module):
    """[B, 3, S, S] pixels (the HF standard 0.5 / 0.5 normalization, S =
    the image encoder's size times a power of two) -> (depth [B, S, S],
    field of view [B] or None)."""

    def __init__(self, cfg: DepthProConfig = DepthProConfig()):
        super().__init__()
        self.cfg = cfg
        dims = cfg.scaled_images_feature_dims
        inter = cfg.intermediate_feature_dims
        f = cfg.fusion_hidden_size
        hid = cfg.patch_model.hidden_size
        n_scaled = len(cfg.scaled_images_ratios)
        upsample = _Holder(
            image_block=UpsampleBlock(cfg.image_model.hidden_size, 0, dims[0], 1,
                                      use_proj=False, bias=True),
            scaled_images=nn.ModuleList(UpsampleBlock(hid, dims[i], dims[i], 1)
                                        for i in range(n_scaled)),
            intermediate=nn.ModuleList(UpsampleBlock(hid, f if i == 0 else inter[i], inter[i],
                                                     2 + i)
                                       for i in range(len(inter))))
        all_dims = tuple(dims) + tuple(inter)
        projections = nn.ModuleList(
            nn.Identity() if i == len(all_dims) - 1 and d == f else _conv3(d, f, bias=False)
            for i, d in enumerate(all_dims))
        self.depth_pro = _Holder(
            encoder=_Holder(patch_encoder=_Holder(model=Dinov2Trunk(cfg.patch_model,
                                                                    cfg.intermediate_hook_ids)),
                            image_encoder=_Holder(model=Dinov2Trunk(cfg.image_model))),
            neck=_Holder(feature_upsample=upsample,
                         fuse_image_with_low_res=nn.Conv2d(2 * dims[0], dims[0], 1),
                         feature_projection=_Holder(projections=projections)))
        self.fusion_stage = _Holder(
            intermediate=nn.ModuleList(FusionLayer(f) for _ in range(len(all_dims) - 1)),
            final=FusionLayer(f, use_deconv=False))
        self.head = _Holder(layers=nn.Sequential(
            _conv3(f, f // 2), _deconv(f // 2, f // 2, True), _conv3(f // 2, 32), nn.ReLU(),
            nn.Conv2d(32, 1, 1), nn.ReLU()))
        if cfg.use_fov_model:
            fov_layers: list[nn.Module] = []
            for i in range(cfg.num_fov_head_layers):
                fov_layers += [_conv3(math.ceil(f / 2 ** (i + 1)), math.ceil(f / 2 ** (i + 2)),
                                      stride=2), nn.ReLU()]
            out_size = cfg.image_model.image_size // cfg.image_model.patch_size
            k = int((out_size - 1) / 2 ** cfg.num_fov_head_layers + 1)
            fov_layers.append(nn.Conv2d(math.ceil(f / 2 ** (cfg.num_fov_head_layers + 1)), 1, k))
            self.fov_model = _Holder(
                fov_encoder=_Holder(model=Dinov2Trunk(cfg.fov_model),
                                    neck=nn.Linear(cfg.fov_model.hidden_size, f // 2)),
                conv=_conv3(f, f // 2, stride=2),
                head=_Holder(layers=nn.Sequential(*fov_layers)))

    def _decoder_elements(self, h: int, w: int) -> int:
        """The most elements a frame's tensor holds in ``_decode``, the last
        fusion level being h x w: that level's, or the head's at 2h x 2w."""
        f = self.cfg.fusion_hidden_size
        c = max(f, self.cfg.intermediate_feature_dims[-1])
        return max(c * h * w, max(f // 2, 32) * 4 * h * w)

    def _decode(self, features):
        """Neck, fusion stage and head over the encoders' features ->
        (depth [B, S, S], the projected global features [B, f, s, s]). The
        list is consumed: each entry is dropped after its last use."""
        cfg = self.cfg
        n_scaled = len(cfg.scaled_images_ratios)
        neck = self.depth_pro.neck
        # neck: upsample each, fuse the image features with the lowest scale, project
        up = neck.feature_upsample
        features[0] = up.image_block(features[0])
        for i in range(n_scaled):
            features[i + 1] = up.scaled_images[i](features[i + 1])
        for i in range(len(cfg.intermediate_hook_ids)):
            features[n_scaled + i + 1] = up.intermediate[i](features[n_scaled + i + 1])
        fused_low = neck.fuse_image_with_low_res(torch.cat([features[1], features[0]], dim=1))
        features = [fused_low, *features[2:]]
        del fused_low
        projections = neck.feature_projection.projections
        projected = []
        for i, proj in enumerate(projections):
            projected.append(proj(features[i]))
            features[i] = None
        del features
        global_features = projected[0]  # the FOV head's input too

        # fusion, lowest resolution first, 2x transposed conv each step
        fused = None
        for i, layer in enumerate(self.fusion_stage.intermediate):
            hs, projected[i] = projected[i], None
            fused = layer(hs) if fused is None else layer(fused, hs)
            del hs
        hs, projected[-1] = projected[-1], None
        fused = self.fusion_stage.final(fused, hs)
        del hs, projected
        x, fused = fused, None
        for layer in self.head.layers:
            x = layer(x)
        depth = x[:, 0]
        del x
        return depth, global_features

    def forward(self, pixels):
        """Each stage in a span of its own (``utils/observability``), every
        device operation in one of them: ``depth.windows`` (the rescales and
        the split), ``depth.patch_encoder``, ``depth.merge`` (the
        ``reconstruct`` calls of the two encoders), ``depth.image_encoder``
        (its rescale too), ``depth.fusion`` (neck, fusion stage and head) and
        ``depth.fov`` (the FOV encoder, its merge and its head); the counter
        ``depth.windows`` counts the windows the patch encoder ran. Each
        intermediate is dropped after its last use, so a chunk of frames
        holds little more than one stage's activations.

        The encoders take the whole chunk in one batch; the decoder
        (``_decode``) runs over consecutive groups of its frames, as few as
        keep each of a group's tensors under ``MAX_ELEMENTS`` (2^31 - 1),
        and the counter ``depth.fusion_groups`` counts them. At 1536^2 a
        chunk of 16 frames holds 2.4e9 elements in each 768^2 x 256 tensor,
        and past 2^31 their 3x3 convolutions left cuDNN's implicit GEMMs for
        its generic engine, at 2.6x the time; under the limit they run the
        implicit GEMMs again. The head's 1536^2 x 128 tensors are the
        largest, so they set the groups (6, 6 and 4 frames of 16; up to 7
        frames are one group): groups of 8, which keep only the 768^2
        tensors under the limit, were as fast and peaked 9 GiB higher."""
        cfg = self.cfg
        b, _, h, w = pixels.shape
        out_size = cfg.image_model.image_size // cfg.image_model.patch_size
        exp = int(math.log2(w / out_size))
        base_h, base_w = h // 2 ** exp, w // 2 ** exp
        n_scaled = len(cfg.scaled_images_ratios)
        top = 2 ** (n_scaled - 1)
        enc = self.depth_pro.encoder

        # the patch encoder over every window of every scale, one batch
        with span("depth.windows"):
            scaled, counts = [], []
            for r, overlap in zip(cfg.scaled_images_ratios, cfg.scaled_images_overlap_ratios):
                img = resize_bilinear(pixels, (int(h * r), int(w * r)), channel_last=False)
                tiles, n = split_to_patches(img, cfg.patch_size, overlap)
                scaled.append(tiles)
                counts.append(n * b)
            del img, tiles
            windows = torch.cat(scaled[::-1], dim=0)  # high res first
            del scaled
        count("depth.windows", windows.shape[0])
        with span("depth.patch_encoder"):
            last, taps = enc.patch_encoder.model(windows)
        del windows
        with span("depth.merge"):
            per_scale_last = torch.split(last, counts[::-1], dim=0)[::-1]
            del last
            feats = []
            for i in range(n_scaled):
                pad = int(cfg.merge_padding_value * (1 / cfg.scaled_images_ratios[i]))
                feats.append(reconstruct(per_scale_last[i], b, pad,
                                         (base_h * 2 ** i, base_w * 2 ** i)))
            del per_scale_last
            pad = int(cfg.merge_padding_value * (1 / cfg.scaled_images_ratios[-1]))
            for i in range(len(taps)):  # raw block outputs of the highest-res scale
                hs = torch.split(taps[i], counts[::-1], dim=0)[0]
                taps[i] = None
                feats.append(reconstruct(hs, b, pad, (base_h * top, base_w * top)))
                del hs
            del taps

        # the image encoder (global context)
        with span("depth.image_encoder"):
            img_small = resize_bilinear(pixels, (cfg.image_model.image_size,) * 2,
                                        channel_last=False)
            image_last, _ = enc.image_encoder.model(img_small)
            del img_small
        with span("depth.merge"):
            features = [reconstruct(image_last, b, 0, (base_h, base_w)), *feats]
            del image_last, feats

        # the decoder in frame groups, each tensor of a group under MAX_ELEMENTS
        side = top * 2 ** (len(cfg.intermediate_hook_ids) + 1)  # the last fusion level
        groups = frame_groups(b, self._decoder_elements(base_h * side, base_w * side))
        count("depth.fusion_groups", len(groups))
        with span("depth.fusion"):
            parts = [self._decode([f[g] for f in features]) for g in groups]
            del features
            depth = torch.cat([d for d, _ in parts])
            global_features = torch.cat([gf for _, gf in parts])
            del parts

        fov = None
        if cfg.use_fov_model:
            with span("depth.fov"):
                fm = self.fov_model
                fov_in = resize_bilinear(pixels, (cfg.fov_model.image_size,) * 2,
                                         channel_last=False)
                fov_last, _ = fm.fov_encoder.model(fov_in)
                fov_feat = reconstruct(fm.fov_encoder.neck(fov_last), b, 0, (base_h, base_w))
                # transformers feeds the neck-projected global features
                gf = F.relu(fm.conv(global_features))
                if gf.shape[2:] != fov_feat.shape[2:]:
                    gf = resize_bilinear(gf, tuple(fov_feat.shape[2:]), channel_last=False)
                ff = resize_bilinear(fov_feat + gf, (out_size, out_size), channel_last=False)
                fov = fm.head.layers(ff).reshape(b, -1)[:, 0]
        return depth, fov
