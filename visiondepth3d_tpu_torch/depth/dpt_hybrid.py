"""DPT-Hybrid / MiDaS 3.0 (Intel/dpt-hybrid-midas).

Counterpart of ``visiondepth3d_tpu/depth/dpt_hybrid.py``, the reference
catalog's "DPT-Hybrid (MiDaS 3.0)" entry. Per HF ``modeling_dpt.py`` with
``is_hybrid=True``:
- a BiT stem (``depth/bit.py``) gives three maps, at /4, /8 and /16;
- the /16 map is projected 1x1 to the ViT width, gets a class token and
  bilinearly re-gridded position embeddings, and runs through the plain
  ViT of ``depth/dpt_classic.py`` (no layer scale; its attention is
  ``ops/attention.py:multi_head_attention``, so K7 under the opt-in);
- the neck takes [BiT /4, BiT /8, ViT tap 0, ViT tap 1]: the two conv maps
  go straight to the ``convs`` (reassemble stages 0 and 1 are identities,
  HF's ``neck_ignore_stages``), the two taps (``vit_out_indices``) get the
  project readout and reassemble factors (1, 0.5);
- fusion and head are the classic DPT's.

Parameter names follow HF (``dpt.embeddings.backbone.bit.*``,
``dpt.embeddings.projection``, ``dpt.encoder.layer.{i}``, ``neck.*``,
``head.head.{0,2,4}``).
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from ..ops.resize import resize_bilinear
from .bit import BitBackbone, BitConfig, make_div
from .configs import ViTConfig
from .dinov2 import interpolate_pos_embed
from .dpt_classic import DPTHead, DPTNeck, ViTEncoder


@dataclasses.dataclass(frozen=True)
class DPTHybridConfig:
    backbone: ViTConfig = ViTConfig(
        hidden_size=768, num_layers=12, num_heads=12, patch_size=16,
        layerscale=False, image_size=384, layer_norm_eps=1e-12,
    )
    bit: BitConfig = BitConfig()
    vit_out_indices: tuple = (9, 12)  # 1-based block outputs (HF [8, 11])
    reassemble_factors: tuple = (1, 0.5)
    neck_hidden_sizes: tuple = (256, 512, 768, 768)
    fusion_hidden_size: int = 256


DPT_HYBRID = DPTHybridConfig()
DPT_HYBRID_TINY = DPTHybridConfig(
    backbone=ViTConfig(hidden_size=32, num_layers=4, num_heads=2,
                       patch_size=16, layerscale=False, image_size=64,
                       layer_norm_eps=1e-12),
    bit=BitConfig(embedding_size=8, hidden_sizes=(8, 16, 32),
                  depths=(1, 1, 1), num_groups=2),
    vit_out_indices=(3, 4),
    neck_hidden_sizes=(8, 16, 24, 32),
    fusion_hidden_size=16,
)

# HF keys the port's model does not hold: the ViT's final LayerNorm and the
# first fusion layer's residual unit, which has no residual input to act on.
UNUSED_HF_KEYS = ("dpt.layernorm.", "neck.fusion_stage.layers.0.residual_layer1.")


class _BitHolder(nn.Module):
    def __init__(self, cfg: BitConfig):
        super().__init__()
        self.bit = BitBackbone(cfg)


class HybridEmbeddings(nn.Module):
    """BiT maps, and the /16 one as ViT tokens with a class token and
    position embeddings."""

    def __init__(self, cfg: DPTHybridConfig):
        super().__init__()
        c = cfg.backbone.hidden_size
        side = cfg.backbone.image_size // cfg.backbone.patch_size
        self.backbone = _BitHolder(cfg.bit)
        self.projection = nn.Conv2d(make_div(cfg.bit.hidden_sizes[-1] * cfg.bit.width_factor), c, 1)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, c))
        self.position_embeddings = nn.Parameter(torch.zeros(1, side * side + 1, c))

    def forward(self, pixels):
        feats = self.backbone.bit(pixels)
        tokens = self.projection(feats[-1])  # /16: the patch grid
        grid = tuple(tokens.shape[2:])
        tokens = tokens.flatten(2).transpose(1, 2)
        x = torch.cat([self.cls_token.expand(tokens.shape[0], -1, -1), tokens], dim=1)
        pos = interpolate_pos_embed(self.position_embeddings, grid, resize_bilinear)
        return x + pos, feats, grid


class _HybridViT(nn.Module):
    def __init__(self, cfg: DPTHybridConfig):
        super().__init__()
        self.embeddings = HybridEmbeddings(cfg)
        self.encoder = ViTEncoder(cfg.backbone)


class DPTHybrid(nn.Module):
    """BiT + ViT-B/16 + DPT neck/head: [B, 3, H, W] ImageNet-normalized
    pixels -> [B, H, W] relative inverse depth."""

    def __init__(self, cfg: DPTHybridConfig = DPT_HYBRID, fast_head: bool = False):
        super().__init__()
        self.cfg = cfg
        self.dpt = _HybridViT(cfg)
        self.neck = DPTNeck(cfg, cfg.backbone.hidden_size,
                            factors=(1, 1) + tuple(cfg.reassemble_factors), ignore=(0, 1))
        self.head = DPTHead(cfg.fusion_hidden_size, fast_head)

    def forward(self, pixels):
        x, bit_feats, grid = self.dpt.embeddings(pixels)
        taps = self.dpt.encoder(x, self.cfg.vit_out_indices)
        fused, _ = self.neck([bit_feats[0], bit_feats[1], *taps], grid)
        return self.head(fused[-1])
