"""BEiT backbone (MiDaS v3.1 / Intel dpt-beit-large-512, ZoeDepth's trunk).

Counterpart of ``visiondepth3d_tpu/depth/beit.py``. BEiT differs from the
plain ViT (HF ``modeling_beit.py``):
- no absolute position embeddings: each layer's attention adds a RELATIVE
  position bias looked up from its own table by pairwise grid offsets (the
  class token's row, column and corner take 3 entries of their own);
- the key projection has no bias (query and value do);
- layer scale (``lambda_1`` / ``lambda_2``, ``layerscale_value`` at init);
- another window than the pretraining one re-grids the bias table
  bilinearly (align_corners False), with HF's ``(old_w, old_h)`` reshape
  kept exactly.

Attention is ``F.scaled_dot_product_attention`` with the bias as a float
``attn_mask`` in the query's type: the JAX package's BEiT calls
``jax.nn.dot_product_attention`` with the bias, not its
``multi_head_attention`` dispatch, so K7 never runs here. Parameter names
follow HF ``BeitBackbone`` inside ``DPTForDepthEstimation`` and
``ZoeDepthForDepthEstimation`` (``backbone.embeddings``,
``backbone.encoder.layer.{i}``).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.resize import resize_bilinear
from .configs import ViTConfig
from .dinov2 import PatchEmbeddings, _Dense


@dataclasses.dataclass(frozen=True)
class BEiTConfig:
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    patch_size: int = 16
    image_size: int = 512  # pretraining window of the bias tables
    layer_norm_eps: float = 1e-12
    layerscale_value: float = 0.1


BEIT_LARGE_512 = BEiTConfig()
BEIT_TINY = BEiTConfig(hidden_size=32, num_layers=4, num_heads=2, image_size=64,
                       layerscale_value=0.1)


@functools.lru_cache(maxsize=16)
def relative_position_index(wh: int, ww: int) -> np.ndarray:
    """[N + 1, N + 1] int64 index into the bias table (HF's layout)."""
    area = wh * ww
    coords = np.stack(np.meshgrid(np.arange(wh), np.arange(ww), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0).astype(np.int64)
    rel[:, :, 0] += wh - 1
    rel[:, :, 1] += ww - 1
    rel[:, :, 0] *= 2 * ww - 1
    num_rel = (2 * wh - 1) * (2 * ww - 1) + 3
    idx = np.zeros((area + 1, area + 1), np.int64)
    idx[1:, 1:] = rel.sum(-1)
    idx[0, 0:] = num_rel - 3
    idx[0:, 0] = num_rel - 2
    idx[0, 0] = num_rel - 1
    return idx


class RelativePositionBias(nn.Module):
    """One layer's bias table, looked up for a (gh, gw) patch grid."""

    def __init__(self, cfg: BEiTConfig):
        super().__init__()
        side = cfg.image_size // cfg.patch_size
        self.old_hw = (2 * side - 1, 2 * side - 1)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros(self.old_hw[0] * self.old_hw[1] + 3, cfg.num_heads))
        self._index = {}  # (gh, gw, device) -> the index on that device

    def _flat_index(self, gh: int, gw: int, device) -> torch.Tensor:
        key = (gh, gw, str(device))
        if key not in self._index:
            self._index[key] = torch.from_numpy(
                relative_position_index(gh, gw).reshape(-1)).to(device)
        return self._index[key]

    def forward(self, grid_hw: tuple[int, int]) -> torch.Tensor:
        """[heads, N + 1, N + 1]."""
        table = self.relative_position_bias_table
        old_h, old_w = self.old_hw
        gh, gw = grid_hw
        new_h, new_w = 2 * gh - 1, 2 * gw - 1
        if (new_h, new_w) != (old_h, old_w):
            # HF reshapes (old_w, old_h, heads): kept as it is
            grid = resize_bilinear(table[:-3].reshape(old_w, old_h, -1), (new_h, new_w),
                                   align_corners=False, channel_last=True)
            table = torch.cat([grid.reshape(new_h * new_w, -1), table[-3:]], dim=0)
        n = gh * gw + 1
        bias = table[self._flat_index(gh, gw, table.device)].reshape(n, n, -1)
        # contiguous keys axis: SDPA's fused kernels take a mask with stride 1 there
        return bias.permute(2, 0, 1).contiguous()


class _SelfAttention(nn.Module):
    def __init__(self, cfg: BEiTConfig):
        super().__init__()
        c = cfg.hidden_size
        self.query = nn.Linear(c, c)
        self.key = nn.Linear(c, c, bias=False)
        self.value = nn.Linear(c, c)
        self.relative_position_bias = RelativePositionBias(cfg)


class BEiTAttention(nn.Module):
    def __init__(self, cfg: BEiTConfig):
        super().__init__()
        self.num_heads = cfg.num_heads
        self.attention = _SelfAttention(cfg)
        self.output = _Dense(cfg.hidden_size, cfg.hidden_size)

    def forward(self, x, grid_hw):  # [B, T, C]
        b, n, c = x.shape
        a = self.attention

        def heads(t):  # [B, N, C] -> [B, H, N, D]
            return t.reshape(b, n, self.num_heads, c // self.num_heads).transpose(1, 2)

        bias = a.relative_position_bias(grid_hw).to(x.dtype)[None]
        out = F.scaled_dot_product_attention(heads(a.query(x)), heads(a.key(x)),
                                             heads(a.value(x)), attn_mask=bias)
        return self.output(out.transpose(1, 2).reshape(b, n, c))


class BEiTLayer(nn.Module):
    def __init__(self, cfg: BEiTConfig):
        super().__init__()
        c = cfg.hidden_size
        self.layerscale_value = cfg.layerscale_value  # the init of lambda_1/2
        self.attention = BEiTAttention(cfg)
        self.intermediate = _Dense(c, 4 * c)
        self.output = _Dense(4 * c, c)
        self.layernorm_before = nn.LayerNorm(c, eps=cfg.layer_norm_eps)
        self.layernorm_after = nn.LayerNorm(c, eps=cfg.layer_norm_eps)
        self.lambda_1 = nn.Parameter(torch.full((c,), cfg.layerscale_value))
        self.lambda_2 = nn.Parameter(torch.full((c,), cfg.layerscale_value))

    def forward(self, x, grid_hw):
        x = x + self.attention(self.layernorm_before(x), grid_hw) * self.lambda_1
        h = self.output(F.gelu(self.intermediate(self.layernorm_after(x))))
        return x + h * self.lambda_2


class BEiTEmbeddings(nn.Module):
    def __init__(self, cfg: BEiTConfig):
        super().__init__()
        self.cls_token = nn.Parameter(torch.zeros(1, 1, cfg.hidden_size))
        self.patch_embeddings = PatchEmbeddings(
            ViTConfig(hidden_size=cfg.hidden_size, patch_size=cfg.patch_size))

    def forward(self, pixels):
        x = self.patch_embeddings(pixels)
        return torch.cat([self.cls_token.expand(x.shape[0], -1, -1), x], dim=1)


class BEiTEncoder(nn.Module):
    def __init__(self, cfg: BEiTConfig):
        super().__init__()
        self.layer = nn.ModuleList(BEiTLayer(cfg) for _ in range(cfg.num_layers))


class BEiTBackbone(nn.Module):
    """The hidden states after the blocks named in ``out_indices``
    (1-based, no final LayerNorm) and the patch grid."""

    def __init__(self, cfg: BEiTConfig, out_indices: tuple):
        super().__init__()
        self.cfg = cfg
        self.out_indices = tuple(out_indices)
        self.embeddings = BEiTEmbeddings(cfg)
        self.encoder = BEiTEncoder(cfg)

    def forward(self, pixels):  # [B, 3, H, W] normalized
        grid = (pixels.shape[2] // self.cfg.patch_size, pixels.shape[3] // self.cfg.patch_size)
        x = self.embeddings(pixels)
        feats = []
        for i, block in enumerate(self.encoder.layer):
            x = block(x, grid)
            if i + 1 in self.out_indices:
                feats.append(x)
        return feats, grid
