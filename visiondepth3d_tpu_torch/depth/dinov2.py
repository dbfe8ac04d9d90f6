"""DINOv2 ViT backbone — the encoder of Depth Anything V1/V2.

Counterpart of ``visiondepth3d_tpu/depth/dinov2.py``. Parameter names
follow the HF ``Dinov2Backbone`` inside ``DepthAnythingForDepthEstimation``
(``backbone.embeddings.*``, ``backbone.encoder.layer.{i}.*``,
``backbone.layernorm.*``), so an HF state dict loads directly. Position
embeddings are re-gridded bicubically (align_corners=False) with the
matrices of ``ops/resize.py``. Attention is
``F.scaled_dot_product_attention``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.resize import resize_bicubic
from .configs import ViTConfig


class PatchEmbeddings(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        p = cfg.patch_size
        self.projection = nn.Conv2d(3, cfg.hidden_size, p, stride=p)

    def forward(self, x):  # [B, 3, H, W] -> [B, N, C]
        return self.projection(x).flatten(2).transpose(1, 2)


def interpolate_pos_embed(pos: torch.Tensor, grid_hw: tuple[int, int]) -> torch.Tensor:
    """Re-grid [1, 1 + N, C] position embeddings to a (gh, gw) patch grid."""
    n = pos.shape[1] - 1
    side = int(round(n ** 0.5))
    gh, gw = grid_hw
    if (gh, gw) == (side, side):
        return pos
    grid = resize_bicubic(pos[0, 1:].reshape(side, side, -1), (gh, gw),
                          align_corners=False, channel_last=True)
    return torch.cat([pos[:, :1], grid.reshape(1, gh * gw, -1)], dim=1)


class Embeddings(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        side = cfg.image_size // cfg.patch_size
        self.cls_token = nn.Parameter(torch.zeros(1, 1, cfg.hidden_size))
        self.position_embeddings = nn.Parameter(torch.zeros(1, side * side + 1,
                                                            cfg.hidden_size))
        self.patch_embeddings = PatchEmbeddings(cfg)

    def forward(self, pixels, grid_hw):
        x = self.patch_embeddings(pixels)
        x = torch.cat([self.cls_token.expand(x.shape[0], -1, -1), x], dim=1)
        return x + interpolate_pos_embed(self.position_embeddings, grid_hw)


class _SelfAttention(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.query = nn.Linear(c, c)
        self.key = nn.Linear(c, c)
        self.value = nn.Linear(c, c)


class _SelfOutput(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.dense = nn.Linear(c, c)


class Attention(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.num_heads = cfg.num_heads
        self.attention = _SelfAttention(cfg.hidden_size)
        self.output = _SelfOutput(cfg.hidden_size)

    def forward(self, x):  # [B, T, C]
        b, n, c = x.shape
        a = self.attention

        def heads(t):
            return t.reshape(b, n, self.num_heads, c // self.num_heads).transpose(1, 2)

        out = F.scaled_dot_product_attention(heads(a.query(x)), heads(a.key(x)),
                                             heads(a.value(x)))
        return self.output.dense(out.transpose(1, 2).reshape(b, n, c))


class LayerScale(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.lambda1 = nn.Parameter(torch.ones(c))

    def forward(self, x):
        return x * self.lambda1


class Mlp(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.fc1 = nn.Linear(cfg.hidden_size, cfg.hidden_size * cfg.mlp_ratio)
        self.fc2 = nn.Linear(cfg.hidden_size * cfg.mlp_ratio, cfg.hidden_size)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class Block(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        c = cfg.hidden_size
        self.norm1 = nn.LayerNorm(c, eps=cfg.layer_norm_eps)
        self.attention = Attention(cfg)
        self.layer_scale1 = LayerScale(c) if cfg.layerscale else nn.Identity()
        self.norm2 = nn.LayerNorm(c, eps=cfg.layer_norm_eps)
        self.mlp = Mlp(cfg)
        self.layer_scale2 = LayerScale(c) if cfg.layerscale else nn.Identity()

    def forward(self, x):
        x = x + self.layer_scale1(self.attention(self.norm1(x)))
        return x + self.layer_scale2(self.mlp(self.norm2(x)))


class Encoder(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.layer = nn.ModuleList(Block(cfg) for _ in range(cfg.num_layers))


class Dinov2Backbone(nn.Module):
    """Returns the final-LayerNorm hidden states after the blocks named in
    ``out_indices`` (1-based; 0 is the embeddings), plus the patch grid."""

    def __init__(self, cfg: ViTConfig, out_indices: tuple):
        super().__init__()
        self.cfg = cfg
        self.out_indices = tuple(out_indices)
        self.embeddings = Embeddings(cfg)
        self.encoder = Encoder(cfg)
        self.layernorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, pixels):  # [B, 3, H, W] normalized
        gh, gw = pixels.shape[2] // self.cfg.patch_size, pixels.shape[3] // self.cfg.patch_size
        x = self.embeddings(pixels, (gh, gw))
        feats = [self.layernorm(x)] if 0 in self.out_indices else []
        for i, block in enumerate(self.encoder.layer):
            x = block(x)
            if i + 1 in self.out_indices:
                feats.append(self.layernorm(x))
        return feats, (gh, gw)
