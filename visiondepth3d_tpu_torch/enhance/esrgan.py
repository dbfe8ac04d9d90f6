"""Real-ESRGAN (RRDBNet) super-resolution as ``nn.Module``s.

Counterpart of ``visiondepth3d_tpu/enhance/esrgan.py``: conv_first -> nb x
RRDB (3 dense blocks of 5 convs, residual scaling 0.2) -> trunk conv -> 2x
nearest-neighbour upsample convs -> HR convs. Real-ESRGAN x2/x1 checkpoints
pixel-unshuffle the input so the trunk runs at 1/4 output resolution;
KAIR/BSRGAN checkpoints do not. Tensors are NHWC floats in [0, 1], as in
the JAX package. Module and parameter names are Real-ESRGAN's state-dict
names (``conv_first``, ``body.N.rdbM.convK``, ``conv_body``, ``conv_up1``,
``conv_up2``, ``conv_hr``, ``conv_last``; OIHW weights), so a checkpoint
canonicalised by ``convert_esrgan`` loads with ``load_state_dict``.

Every 3x3 conv is ``Conv3x3``: on a CUDA tensor it always runs the hand
kernel K5 (``kernels/conv.py``), on a CPU tensor its plain version.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from ..kernels.conv import PackedConv, conv3x3, pack_conv3x3


class Conv3x3(nn.Module):
    """3x3 stride-1 SAME conv with a fused activation (None, "relu",
    "lrelu" at slope 0.2) on NHWC input. Parameters ``weight`` [O, C, 3, 3]
    and ``bias`` [O], as ``nn.Conv2d`` names them. The kernel's weight
    layout is built once per input type and device and kept until the
    weights change."""

    def __init__(self, cin: int, cout: int, act: str | None = None, bias: bool = True):
        super().__init__()
        self.act = act
        self.weight = nn.Parameter(torch.empty(cout, cin, 3, 3))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None
        self._packed: tuple | None = None

    def _pack(self, dtype: torch.dtype) -> PackedConv:
        key = (dtype, self.weight.data_ptr(), self.weight.dtype,
               None if self.bias is None else self.bias.data_ptr())
        if self._packed is None or self._packed[0] != key:
            self._packed = (key, pack_conv3x3(self.weight.permute(2, 3, 1, 0), self.bias, dtype))
        return self._packed[1]

    def _load_from_state_dict(self, *args, **kwargs):
        self._packed = None
        super()._load_from_state_dict(*args, **kwargs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        packed = self._pack(x.dtype) if x.device.type == "cuda" else None
        return conv3x3(x, self.weight.permute(2, 3, 1, 0), self.bias, self.act, packed=packed)


def _cat(*xs):
    return torch.cat(xs, dim=-1)


class ResidualDenseBlock(nn.Module):
    def __init__(self, nf: int = 64, gc: int = 32):
        super().__init__()
        for k in range(1, 6):
            setattr(self, f"conv{k}", Conv3x3(nf + (k - 1) * gc, gc if k < 5 else nf,
                                              act="lrelu" if k < 5 else None))

    def forward(self, x):
        x1 = self.conv1(x)
        x2 = self.conv2(_cat(x, x1))
        x3 = self.conv3(_cat(x, x1, x2))
        x4 = self.conv4(_cat(x, x1, x2, x3))
        x5 = self.conv5(_cat(x, x1, x2, x3, x4))
        return x + 0.2 * x5


class RRDB(nn.Module):
    def __init__(self, nf: int = 64, gc: int = 32):
        super().__init__()
        self.rdb1 = ResidualDenseBlock(nf, gc)
        self.rdb2 = ResidualDenseBlock(nf, gc)
        self.rdb3 = ResidualDenseBlock(nf, gc)

    def forward(self, x):
        return x + 0.2 * self.rdb3(self.rdb2(self.rdb1(x)))


def _nearest_up2(x: torch.Tensor) -> torch.Tensor:
    b, h, w, c = x.shape
    return x[:, :, None, :, None, :].expand(b, h, 2, w, 2, c).reshape(b, h * 2, w * 2, c)


def _pixel_unshuffle(x: torch.Tensor, r: int) -> torch.Tensor:
    """NHWC pixel-unshuffle in torch/basicsr channel order: output channel
    c * r^2 + i * r + j."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // r, r, w // r, r, c).permute(0, 1, 3, 5, 2, 4)
    return x.reshape(b, h // r, w // r, c * r * r)


class RRDBNet(nn.Module):
    """RRDB super-resolution net, both released lineages:

    - Real-ESRGAN style (``unshuffle=True``, ``n_up=2``): scale < 4
      pixel-unshuffles the input so the trunk runs at 1/4 output resolution;
    - KAIR/BSRGAN style (``unshuffle=False``): output scale is 2**n_up.

    ``forward``: [B, H, W, 3] in [0, 1] -> [B, H*scale, W*scale, 3], the
    ``trunk`` (the JAX package's ``_RRDBTrunk``) then the ``tail``
    (``_RRDBTail``); the staged route calls the two apart.
    """

    def __init__(self, nf: int = 64, nb: int = 23, gc: int = 32, scale: int = 4,
                 n_up: int = 2, unshuffle: bool = True):
        super().__init__()
        self.nf, self.nb, self.gc = nf, nb, gc
        self.scale, self.n_up, self.unshuffle = scale, n_up, unshuffle
        in_c = 3 * {4: 1, 2: 4, 1: 16}[scale] if unshuffle else 3
        self.conv_first = Conv3x3(in_c, nf)
        self.body = nn.ModuleList([RRDB(nf, gc) for _ in range(nb)])
        self.conv_body = Conv3x3(nf, nf)
        for i in range(n_up):
            setattr(self, f"conv_up{i + 1}", Conv3x3(nf, nf, act="lrelu"))
        self.conv_hr = Conv3x3(nf, nf, act="lrelu")
        self.conv_last = Conv3x3(nf, 3)

    def trunk(self, x: torch.Tensor) -> torch.Tensor:
        """conv_first -> nb x RRDB -> conv_body (+ skip), at trunk resolution."""
        if self.unshuffle and self.scale < 4:
            x = _pixel_unshuffle(x, 4 // self.scale)
        feat = self.conv_first(x)
        trunk = feat
        for blk in self.body:
            trunk = blk(trunk)
        return feat + self.conv_body(trunk)

    def tail(self, feat: torch.Tensor) -> torch.Tensor:
        """n_up x (nearest up2 -> conv + lrelu) -> conv_hr + lrelu -> conv_last."""
        for i in range(self.n_up):
            feat = getattr(self, f"conv_up{i + 1}")(_nearest_up2(feat))
        return self.conv_last(self.conv_hr(feat))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.tail(self.trunk(x))


@torch.no_grad()
def apply_rrdbnet_staged(model: RRDBNet, x: torch.Tensor, tail_tile_hw: tuple[int, int],
                         halo: int = 2) -> torch.Tensor:
    """RRDBNet with the x4 upsample tail tiled: the trunk runs whole-frame at
    input resolution, then conv_up1/up2/hr/last run per spatial tile with a
    ``halo``-pixel context, and the 4x-scaled halo is cropped off.

    Exact against ``model(x)``: the tail's receptive field is 2 trunk pixels,
    so ``halo >= 2`` of real neighbours reproduces every interior pixel, and
    windows are clamped inside the image so the convs' own zero padding
    lands exactly at the true border. The tail's [B, 4H, 4W, nf]
    activations never exist whole. Tile sizes must divide the trunk output
    and satisfy th + 2*halo <= H, tw + 2*halo <= W.
    """
    return staged_tail(model, model.trunk(x), tail_tile_hw, halo)


@torch.no_grad()
def staged_tail(model: RRDBNet, feat: torch.Tensor, tail_tile_hw: tuple[int, int],
                halo: int = 2) -> torch.Tensor:
    """The x4 tail of ``apply_rrdbnet_staged`` on the trunk's output."""
    if model.n_up != 2:
        raise ValueError("the staged tail assumes the 2-up (4x-factor) tail")
    b, h, w, _ = feat.shape
    th, tw = tail_tile_hw
    if h % th or w % tw or th + 2 * halo > h or tw + 2 * halo > w:
        raise ValueError(f"tail tiles {th}x{tw} (halo {halo}) do not fit trunk {h}x{w}")

    def win(i, t, size):
        """Clamped window start and in-window crop offset."""
        s = min(max(i * t - halo, 0), size - t - 2 * halo)
        return s, i * t - s

    out = None
    for ti in range(h // th):
        sy, cy = win(ti, th, h)
        for tj in range(w // tw):
            sx, cx = win(tj, tw, w)
            up = model.tail(feat[:, sy:sy + th + 2 * halo, sx:sx + tw + 2 * halo])
            if out is None:
                out = torch.empty(b, 4 * h, 4 * w, up.shape[-1], dtype=up.dtype,
                                  device=up.device)
            out[:, 4 * ti * th:4 * (ti + 1) * th, 4 * tj * tw:4 * (tj + 1) * tw] = \
                up[:, 4 * cy:4 * (cy + th), 4 * cx:4 * (cx + tw)]
    return out


@dataclasses.dataclass(frozen=True)
class ESRGANConfig:
    """Inferred RRDBNet geometry; ``scale`` is the OUTPUT scale."""

    nf: int = 64
    nb: int = 23
    gc: int = 32
    scale: int = 4
    n_up: int = 2
    unshuffle: bool = True

    def build(self) -> RRDBNet:
        return RRDBNet(nf=self.nf, nb=self.nb, gc=self.gc, scale=self.scale,
                       n_up=self.n_up, unshuffle=self.unshuffle)


# The reference's shipped upscaler dropdown (VisionDepth3D.py:1094-1100):
# five fp16 ONNX exports under weights/. ``scale`` pins the ambiguity a .pth
# checkpoint can't resolve by names alone.
ESRGAN_CATALOG = {
    "RealESR_Gx4": {"file": "RealESR_Gx4_fp16.onnx", "scale": 4},
    "RealESRGAN_x4": {"file": "RealESRGANx4_fp16.onnx", "scale": 4},
    "RealESR_Animex4": {"file": "RealESR_Animex4_fp16.onnx", "scale": 4},
    "BSRGANx2": {"file": "BSRGANx2_fp16.onnx", "scale": 2},
    "BSRGANx4": {"file": "BSRGANx4_fp16.onnx", "scale": 4},
}

SUPPORTED_FAMILIES = ("RRDBNet, Real-ESRGAN naming (conv_first / body.N.rdbM.convK / "
                      "conv_body / conv_up1,2 / conv_hr / conv_last), and RRDBNet, "
                      "KAIR/BSRGAN naming (conv_first / RRDB_trunk.N.RDBM.convK / "
                      "trunk_conv / upconv1,2 / HRconv / conv_last)")


def _canon_esrgan_keymap(keys) -> tuple[dict, str]:
    """Canonical (Real-ESRGAN-scheme) names -> the checkpoint's names, and
    the style, "realesrgan" or "kair". A leading "model." or "module."
    wrapper prefix is stripped."""
    keys = list(keys)
    strip = 0
    for pre in ("model.", "module."):
        if keys and all(k.startswith(pre) for k in keys):
            strip = len(pre)
            break
    stripped = [(k[strip:], k) for k in keys]
    style = "kair" if any(
        s.startswith(("RRDB_trunk.", "trunk_conv.")) for s, _ in stripped) else "realesrgan"
    renames = {"trunk_conv.": "conv_body.", "upconv1.": "conv_up1.",
               "upconv2.": "conv_up2.", "HRconv.": "conv_hr."}
    keymap = {}
    for s, orig in stripped:
        if style == "kair":
            if s.startswith("RRDB_trunk."):
                parts = s.split(".")
                s = ".".join(["body", parts[1], parts[2].lower(), *parts[3:]])
            else:
                for old, new in renames.items():
                    if s.startswith(old):
                        s = new + s[len(old):]
                        break
        keymap[s] = orig
    return keymap, style


def infer_esrgan_config(state: dict, keymap: dict, style: str,
                        scale: int | None = None) -> ESRGANConfig:
    """(nf, nb, gc, scale, n_up, unshuffle) from the checkpoint; ``scale``
    overrides the inference where names alone are ambiguous (KAIR .pth
    files: upconv2 exists but is unused at sf=2)."""
    if "conv_first.weight" not in keymap or "body.0.rdb1.conv1.weight" not in keymap:
        raise ValueError(
            "not an RRDBNet checkpoint (no conv_first / first dense-block conv; "
            "SRVGGNetCompact and other families are not supported). Supported: "
            f"{SUPPORTED_FAMILIES}")
    w_first = np.asarray(state[keymap["conv_first.weight"]])
    nf, in_c = int(w_first.shape[0]), int(w_first.shape[1])
    gc = int(np.asarray(state[keymap["body.0.rdb1.conv1.weight"]]).shape[0])
    nb = 1 + max(int(k.split(".")[1]) for k in keymap if k.startswith("body."))
    if style == "realesrgan":
        if in_c not in (3, 12, 48):
            raise ValueError(f"conv_first takes {in_c} channels; Real-ESRGAN nets take "
                             f"3, 12 or 48 (x4, x2, x1)")
        inferred = {3: 4, 12: 2, 48: 1}[in_c]
        if scale is not None and scale != inferred:
            raise ValueError(f"checkpoint pixel-unshuffles to scale {inferred}, "
                             f"but scale={scale} was requested")
        return ESRGANConfig(nf=nf, nb=nb, gc=gc, scale=inferred, n_up=2, unshuffle=True)
    if scale is None:
        scale = 4 if "conv_up2.weight" in keymap else 2
    if scale not in (2, 4):
        raise ValueError(f"BSRGAN-style checkpoints are x2/x4, got {scale}")
    return ESRGANConfig(nf=nf, nb=nb, gc=gc, scale=scale, n_up=scale.bit_length() - 1,
                        unshuffle=False)


def convert_esrgan(state: dict, scale: int | None = None
                   ) -> tuple[dict[str, torch.Tensor], ESRGANConfig]:
    """Any RRDBNet-family checkpoint (torch state dict, safetensors table, or
    the name-preserving ONNX export's initializer table) -> (a float32 state
    dict for ``ESRGANConfig.build()``, the inferred config). Keys the config
    does not use (a KAIR x2 file's upconv2) are dropped."""
    keymap, style = _canon_esrgan_keymap(state.keys())
    cfg = infer_esrgan_config(state, keymap, style, scale)
    wanted = cfg.build().state_dict().keys()
    out = {}
    for k in wanted:
        if k not in keymap:
            raise KeyError(f"checkpoint lacks {k!r} for {cfg}")
        v = state[keymap[k]]
        v = v.detach().cpu() if isinstance(v, torch.Tensor) else torch.from_numpy(
            np.array(v, dtype=np.float32))
        out[k] = v.to(torch.float32)
    return out, cfg


def load_esrgan_weights(path, scale: int | None = None
                        ) -> tuple[dict[str, torch.Tensor], ESRGANConfig]:
    """ESRGAN/BSRGAN weights from .onnx (initializer table), .safetensors or
    torch .pth -> (state dict, ESRGANConfig)."""
    p = str(path)
    if p.endswith(".onnx"):
        from ..utils.onnx_reader import read_onnx_initializers

        state = read_onnx_initializers(p)
    elif p.endswith(".safetensors"):
        from ..depth.convert import load_safetensors

        state = load_safetensors(p)
    else:
        raw = torch.load(p, map_location="cpu", weights_only=True)
        if isinstance(raw, dict):
            for key in ("params_ema", "params", "state_dict"):
                if key in raw and isinstance(raw[key], dict):
                    raw = raw[key]
                    break
        state = dict(raw)
    return convert_esrgan(state, scale=scale)


def blend_images(original: torch.Tensor, upscaled: torch.Tensor,
                 mode: str = "OFF") -> torch.Tensor:
    """AI-blend modes (merged_pipeline.py:233-238): alpha of the upscaled
    result against the plain-resized original: OFF/LOW/MEDIUM/HIGH."""
    alpha = {"OFF": 1.0, "LOW": 0.85, "MEDIUM": 0.5, "HIGH": 0.25}[mode]
    return upscaled * alpha + original * (1.0 - alpha)
