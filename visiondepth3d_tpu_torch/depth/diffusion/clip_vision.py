"""The CLIP ViT vision tower: DepthCrafter's image conditioning.

Counterpart of ``visiondepth3d_tpu/depth/diffusion/clip_vision.py`` on
NCHW pixels, under transformers' ``CLIPVisionModelWithProjection``
parameter names (``vision_model.*``, ``visual_projection``), so the laion
ViT-H image encoder's checkpoint loads as it is: a bias-free patch conv,
the class and position embeddings, ``pre_layrnorm``, pre-LN blocks with
the exact GELU (laion's ``hidden_act="gelu"``), ``post_layernorm`` on the
class token and the bias-free projection. Attention goes through
``ops/attention.py:multi_head_attention`` (257 tokens at 224^2: SDPA).
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from ...ops.attention import multi_head_attention
from ..configs import ViTConfig
from ..dinov2 import Mlp


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    """laion CLIP ViT-H/14 (the SVD image encoder's ``config.json``)."""

    hidden_size: int = 1280
    num_layers: int = 32
    num_heads: int = 16
    patch_size: int = 14
    image_size: int = 224
    projection_dim: int = 1024


CLIP_TINY = CLIPVisionConfig(hidden_size=32, num_layers=2, num_heads=2, image_size=28,
                             projection_dim=16)


class _SelfAttention(nn.Module):
    def __init__(self, c: int, heads: int):
        super().__init__()
        self.heads = heads
        self.q_proj, self.k_proj, self.v_proj = (nn.Linear(c, c) for _ in range(3))
        self.out_proj = nn.Linear(c, c)

    def forward(self, x):  # [B, N, C]
        b, n, c = x.shape

        def split(t):  # BNHD
            return t.reshape(b, n, self.heads, c // self.heads)

        out = multi_head_attention(split(self.q_proj(x)), split(self.k_proj(x)),
                                   split(self.v_proj(x)))
        return self.out_proj(out.reshape(b, n, c))


class _Layer(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        c = cfg.hidden_size
        self.layer_norm1 = nn.LayerNorm(c, eps=1e-5)
        self.self_attn = _SelfAttention(c, cfg.num_heads)
        self.layer_norm2 = nn.LayerNorm(c, eps=1e-5)
        self.mlp = Mlp(ViTConfig(hidden_size=c, num_heads=cfg.num_heads, mlp_ratio=4))

    def forward(self, x):
        x = x + self.self_attn(self.layer_norm1(x))
        return x + self.mlp(self.layer_norm2(x))


class _Encoder(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.layers = nn.ModuleList(_Layer(cfg) for _ in range(cfg.num_layers))


class _Embeddings(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        c, p = cfg.hidden_size, cfg.patch_size
        self.class_embedding = nn.Parameter(torch.zeros(c))
        self.patch_embedding = nn.Conv2d(3, c, p, stride=p, bias=False)
        self.position_embedding = nn.Embedding((cfg.image_size // p) ** 2 + 1, c)

    def forward(self, pixels):  # [B, 3, S, S]
        x = self.patch_embedding(pixels).flatten(2).transpose(1, 2)
        cls = self.class_embedding.to(x.dtype).expand(x.shape[0], 1, -1)
        x = torch.cat([cls, x], dim=1)
        return x + self.position_embedding.weight[: x.shape[1]]


class _VisionModel(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.embeddings = _Embeddings(cfg)
        self.pre_layrnorm = nn.LayerNorm(cfg.hidden_size, eps=1e-5)  # transformers' spelling
        self.encoder = _Encoder(cfg)
        self.post_layernorm = nn.LayerNorm(cfg.hidden_size, eps=1e-5)


class CLIPVisionEncoder(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig = CLIPVisionConfig()):
        super().__init__()
        self.cfg = cfg
        self.vision_model = _VisionModel(cfg)
        self.visual_projection = nn.Linear(cfg.hidden_size, cfg.projection_dim, bias=False)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        """[B, S, S, 3] pixels, channel last as the JAX package takes them ->
        [B, projection_dim] image embeddings."""
        vm = self.vision_model
        x = vm.pre_layrnorm(vm.embeddings(pixels.permute(0, 3, 1, 2)))
        for layer in vm.encoder.layers:
            x = layer(x)
        return self.visual_projection(vm.post_layernorm(x[:, 0]))
