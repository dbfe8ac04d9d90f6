"""Classic DPT / MiDaS v3 family (Intel/dpt-large) and the DPT neck and
head that the BEiT, hybrid and ZoeDepth families share.

Counterpart of ``visiondepth3d_tpu/depth/dpt_classic.py``. Differences
from the Depth Anything variant (``depth/dpt.py``), per HF
``modeling_dpt.py``:
- backbone: a plain ViT without layer scale, learned position embeddings
  re-gridded BILINEARLY (align_corners False) for a new patch grid, the
  tapped hidden states taken WITHOUT a final LayerNorm;
- readout: each tapped stage concatenates the class token to every patch
  token and projects 2C -> C with exact GELU ("project" readout);
- fusion: always upsamples by exactly 2x (align_corners True), the
  residual resized align_corners False;
- head: conv -> 2x upsample -> conv -> ReLU -> 1x1 conv -> ReLU; with
  ``fast_head`` the last two convs run at the fused resolution and the
  one-channel depth is upsampled last (same parameters).

Parameter names follow HF ``DPTForDepthEstimation`` (``dpt.embeddings``,
``dpt.encoder.layer.{i}.layernorm_before`` ..., ``neck.reassemble_stage
.readout_projects.{i}.0``, ``head.head.{0,2,4}``), so an HF state dict
loads directly. The ViT's attention is the port's ``dinov2.Attention``,
which calls ``ops/attention.py:multi_head_attention`` (SDPA, or K7 under
its ``USE_VMEM_KERNEL`` opt-in).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.resize import resize_bilinear
from .configs import ViTConfig
from .dinov2 import Attention, Embeddings, _Dense
from .dpt import FusionStage, ReassembleLayer, _conv3


@dataclasses.dataclass(frozen=True)
class DPTClassicConfig:
    backbone: ViTConfig = ViTConfig(
        hidden_size=1024, num_layers=24, num_heads=16, patch_size=16,
        layerscale=False, image_size=384, layer_norm_eps=1e-12,
    )
    out_indices: tuple = (6, 12, 18, 24)  # 1-based block outputs
    reassemble_factors: tuple = (4, 2, 1, 0.5)
    neck_hidden_sizes: tuple = (256, 512, 1024, 1024)
    fusion_hidden_size: int = 256


DPT_LARGE = DPTClassicConfig()
DPT_TINY = DPTClassicConfig(
    backbone=ViTConfig(hidden_size=32, num_layers=4, num_heads=2, patch_size=16,
                       layerscale=False, image_size=64, layer_norm_eps=1e-12),
    out_indices=(1, 2, 3, 4),
    neck_hidden_sizes=(16, 24, 32, 40),
    fusion_hidden_size=16,
)

# HF keys the port's classic models do not hold: the ViT's final LayerNorm
# (the taps are taken before it) and the first fusion layer's residual unit,
# which has no residual input to act on.
UNUSED_HF_KEYS = ("dpt.layernorm.", "neck.fusion_stage.layers.0.residual_layer1.")


class ViTLayer(nn.Module):
    """A pre-norm ViT block without layer scale, HF ``DPTViTLayer`` names."""

    def __init__(self, cfg: ViTConfig):
        super().__init__()
        c = cfg.hidden_size
        self.attention = Attention(cfg)
        self.intermediate = _Dense(c, c * cfg.mlp_ratio)
        self.output = _Dense(c * cfg.mlp_ratio, c)
        self.layernorm_before = nn.LayerNorm(c, eps=cfg.layer_norm_eps)
        self.layernorm_after = nn.LayerNorm(c, eps=cfg.layer_norm_eps)

    def forward(self, x):
        x = x + self.attention(self.layernorm_before(x))
        return x + self.output(F.gelu(self.intermediate(self.layernorm_after(x))))


class ViTEncoder(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.layer = nn.ModuleList(ViTLayer(cfg) for _ in range(cfg.num_layers))

    def forward(self, x, out_indices):
        """The hidden states after the blocks named in ``out_indices`` (1-based)."""
        feats = []
        for i, block in enumerate(self.layer):
            x = block(x)
            if i + 1 in out_indices:
                feats.append(x)
        return feats


class ViTEmbeddings(Embeddings):
    """DINOv2's embeddings with the position embeddings re-gridded
    bilinearly (HF ``DPTViTEmbeddings``)."""

    pos_resize = staticmethod(resize_bilinear)


class ReadoutReassembleStage(nn.Module):
    """Project readout (cls concatenated, 2C -> C, exact GELU) and the
    reassemble layers; the stages in ``ignore`` (the hybrid's two BiT maps)
    pass through untouched and hold no parameters."""

    def __init__(self, hidden: int, neck_hidden_sizes: tuple, factors: tuple,
                 ignore: tuple = ()):
        super().__init__()
        self.ignore = tuple(ignore)
        self.layers = nn.ModuleList(
            nn.Identity() if i in self.ignore else ReassembleLayer(hidden, ch, f)
            for i, (ch, f) in enumerate(zip(neck_hidden_sizes, factors)))
        self.readout_projects = nn.ModuleList(
            nn.Sequential(nn.Identity()) if i in self.ignore
            else nn.Sequential(nn.Linear(2 * hidden, hidden), nn.GELU())
            for i in range(len(neck_hidden_sizes)))

    def forward(self, feats, grid_hw):
        """Token features [B, 1 + N, C] (or [B, C, h, w] maps in ``ignore``)
        -> NCHW maps."""
        gh, gw = grid_hw
        maps = []
        for i, (feat, layer, readout) in enumerate(zip(feats, self.layers,
                                                       self.readout_projects)):
            if i in self.ignore:
                maps.append(feat)
                continue
            tokens = feat[:, 1:]
            t = readout(torch.cat([tokens, feat[:, :1].expand_as(tokens)], dim=-1))
            maps.append(layer(t.transpose(1, 2).reshape(t.shape[0], -1, gh, gw)))
        return maps


class DPTNeck(nn.Module):
    """Readout + reassemble, the bias-free 3x3 ``convs``, and fusion that
    upsamples 2x at every stage. Returns every fusion stage's output,
    deepest first (ZoeDepth's metric head reads them all) and the deepest
    ``convs`` output (its bottleneck)."""

    def __init__(self, cfg, hidden: int, factors: tuple | None = None, ignore: tuple = ()):
        super().__init__()
        self.reassemble_stage = ReadoutReassembleStage(
            hidden, cfg.neck_hidden_sizes,
            cfg.reassemble_factors if factors is None else factors, ignore)
        self.convs = nn.ModuleList(_conv3(ch, cfg.fusion_hidden_size, bias=False)
                                   for ch in cfg.neck_hidden_sizes)
        self.fusion_stage = FusionStage(cfg)

    def forward(self, feats, grid_hw):
        maps = [conv(m) for conv, m in zip(self.convs, self.reassemble_stage(feats, grid_hw))]
        fused, outs = None, []
        for hs, layer in zip(maps[::-1], self.fusion_stage.layers):
            fused = layer(hs) if fused is None else layer(fused, hs)
            outs.append(fused)
        return outs, maps[-1]


class DPTHead(nn.Module):
    """HF ``DPTDepthEstimationHead``: ``head.{0,2,4}`` are the convs."""

    def __init__(self, features: int, fast_head: bool):
        super().__init__()
        self.fast_head = fast_head
        self.head = nn.Sequential(_conv3(features, features // 2), nn.Identity(),
                                  _conv3(features // 2, 32), nn.ReLU(),
                                  nn.Conv2d(32, 1, 1), nn.ReLU())

    def forward(self, x):
        conv1, _, conv2, _, conv3, _ = self.head
        x = conv1(x)
        if not self.fast_head:
            x = resize_bilinear(x, (x.shape[2] * 2, x.shape[3] * 2), align_corners=True,
                                channel_last=False)
        x = F.relu(conv3(F.relu(conv2(x))))[:, 0]
        if self.fast_head:
            x = resize_bilinear(x, (x.shape[1] * 2, x.shape[2] * 2), align_corners=True,
                                channel_last=False)
        return x


class _DPTViT(nn.Module):
    """HF's ``dpt`` holder: embeddings and encoder of the plain ViT."""

    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.embeddings = ViTEmbeddings(cfg)
        self.encoder = ViTEncoder(cfg)


class DPTClassic(nn.Module):
    """Plain ViT + DPT neck/head: [B, 3, H, W] ImageNet-normalized pixels
    -> [B, H, W] relative inverse depth (H, W multiples of the patch)."""

    def __init__(self, cfg: DPTClassicConfig = DPT_LARGE, fast_head: bool = False):
        super().__init__()
        self.cfg = cfg
        self.dpt = _DPTViT(cfg.backbone)
        self.neck = DPTNeck(cfg, cfg.backbone.hidden_size)
        self.head = DPTHead(cfg.fusion_hidden_size, fast_head)

    def forward(self, pixels):
        p = self.cfg.backbone.patch_size
        grid = (pixels.shape[2] // p, pixels.shape[3] // p)
        feats = self.dpt.encoder(self.dpt.embeddings(pixels, grid), self.cfg.out_indices)
        fused, _ = self.neck(feats, grid)
        return self.head(fused[-1])
