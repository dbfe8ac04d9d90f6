"""The SD2-class conditional UNet (diffusers ``UNet2DConditionModel``) of
Marigold.

Counterpart of ``visiondepth3d_tpu/depth/diffusion/unet2d.py`` on NCHW
tensors, under diffusers' parameter names: down blocks of resnets with a
spatial transformer each where ``with_attn`` says (GEGLU feed-forward at
4x width, self-attention, then cross-attention to the text context),
stride-2 downsamplers, a resnet-transformer-resnet mid block, up blocks
that concatenate the skips, and a sinusoidal timestep MLP.

Self-attention goes through ``ops/attention.py:multi_head_attention``
(SDPA, or K7 under its opt-in at 512 <= N < 4096); cross-attention keys
come from the 77 context tokens, so the dispatcher sends it to SDPA.

Each up block upsamples (nearest) to the size of the skip it concatenates
next, as diffusers does (``Upsample2D(output_size=...)``): where the
latent divides by 2^(levels - 1) that is exactly 2x, the JAX package's
upsample, bit for bit; elsewhere (a 1080p frame's 135-row latent) the JAX
package cannot concatenate and raises (ROADMAP Queue 3, F11).

As in the JAX package, the transformer blocks' LayerNorms take epsilon
1e-6 and GEGLU the tanh-approximate GELU (``jax.nn.gelu``'s default);
diffusers takes 1e-5 and the exact GELU.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.attention import multi_head_attention
from .vae import ResnetBlock, _Block, _conv3


@dataclasses.dataclass(frozen=True)
class UNet2DConfig:
    """Marigold's UNet (``prs-eth/marigold-depth-v1-0`` ``unet/config.json``):
    8 channels in (RGB latent and depth latent), 4 out, SD2 widths, heads
    (5, 10, 20, 20) of 64, cross-attention to 1024-wide text embeddings.
    ``attention_head_dim`` holds head counts, as diffusers' SD2 configs
    do."""

    in_channels: int = 8
    out_channels: int = 4
    block_out_channels: tuple = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    attention_head_dim: tuple = (5, 10, 20, 20)
    cross_attention_dim: int = 1024
    norm_groups: int = 32
    with_attn: tuple = (True, True, True, False)  # per down block


UNET2D_TINY = UNet2DConfig(block_out_channels=(32, 64), layers_per_block=1,
                           attention_head_dim=(2, 4), cross_attention_dim=32, norm_groups=8,
                           with_attn=(True, False))


def timestep_embedding(t: torch.Tensor, dim: int, max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal embedding, float32 (diffusers flip_sin_to_cos=True, shift 0)."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(half, dtype=torch.float32,
                                                           device=t.device) / half)
    args = t[..., None].float() * freqs
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


class CrossAttention(nn.Module):
    def __init__(self, c: int, heads: int, head_dim: int, ctx_dim: int | None = None):
        super().__init__()
        inner = heads * head_dim
        self.heads, self.head_dim = heads, head_dim
        self.to_q = nn.Linear(c, inner, bias=False)
        self.to_k = nn.Linear(ctx_dim or c, inner, bias=False)
        self.to_v = nn.Linear(ctx_dim or c, inner, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(inner, c)])

    def forward(self, x, ctx=None):  # [B, N, C], [B, L, D]
        ctx = x if ctx is None else ctx

        def split(t):  # BNHD
            return t.reshape(t.shape[0], t.shape[1], self.heads, self.head_dim)

        out = multi_head_attention(split(self.to_q(x)), split(self.to_k(ctx)),
                                   split(self.to_v(ctx)))
        return self.to_out[0](out.reshape(x.shape[0], x.shape[1], -1))


class GEGLU(nn.Module):
    """Projects to 2 x inner, gates one half by the other's GELU."""

    def __init__(self, c: int, inner: int):
        super().__init__()
        self.proj = nn.Linear(c, 2 * inner)

    def forward(self, x):
        a, b = self.proj(x).chunk(2, dim=-1)
        return a * F.gelu(b, approximate="tanh")


class _FeedForward(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.net = nn.ModuleList([GEGLU(c, 4 * c), nn.Identity(), nn.Linear(4 * c, c)])

    def forward(self, x):
        return self.net[2](self.net[0](x))


class TransformerBlock(nn.Module):
    def __init__(self, c: int, heads: int, ctx_dim: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(c, eps=1e-6)
        self.attn1 = CrossAttention(c, heads, c // heads)
        self.norm2 = nn.LayerNorm(c, eps=1e-6)
        self.attn2 = CrossAttention(c, heads, c // heads, ctx_dim)
        self.norm3 = nn.LayerNorm(c, eps=1e-6)
        self.ff = _FeedForward(c)

    def forward(self, x, ctx):
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), ctx)
        return x + self.ff(self.norm3(x))


class SpatialTransformer(nn.Module):
    """diffusers' Transformer2DModel with linear projections."""

    def __init__(self, c: int, heads: int, groups: int, ctx_dim: int):
        super().__init__()
        self.norm = nn.GroupNorm(groups, c, eps=1e-6)
        self.proj_in = nn.Linear(c, c)
        self.transformer_blocks = nn.ModuleList([TransformerBlock(c, heads, ctx_dim)])
        self.proj_out = nn.Linear(c, c)

    def forward(self, x, ctx):
        b, c, h, w = x.shape
        y = self.proj_in(self.norm(x).flatten(2).transpose(1, 2))
        y = self.proj_out(self.transformer_blocks[0](y, ctx))
        return x + y.transpose(1, 2).reshape(b, c, h, w)


class _TimeEmbedding(nn.Module):
    def __init__(self, c0: int):
        super().__init__()
        self.linear_1 = nn.Linear(c0, 4 * c0)
        self.linear_2 = nn.Linear(4 * c0, 4 * c0)

    def forward(self, temb):
        """In float32 whatever the weights' type, as the JAX package's
        Dense promotes its float32 input."""
        def lin(layer, x):
            return F.linear(x, layer.weight.float(), layer.bias.float())
        return lin(self.linear_2, F.silu(lin(self.linear_1, temb)))


class UNet2DCondition(nn.Module):
    def __init__(self, cfg: UNet2DConfig = UNet2DConfig()):
        super().__init__()
        self.cfg = cfg
        chans, g, lpb = cfg.block_out_channels, cfg.norm_groups, cfg.layers_per_block
        n, c0, temb = len(chans), chans[0], 4 * chans[0]
        ctx = cfg.cross_attention_dim
        self.conv_in = _conv3(cfg.in_channels, c0)
        self.time_embedding = _TimeEmbedding(c0)

        def resnet(cin, cout):
            return ResnetBlock(cin, cout, g, 1e-5, temb)

        skips, down, cin = [c0], [], c0
        for i, ch in enumerate(chans):
            heads = cfg.attention_head_dim[i]
            res, attn = [], []
            for j in range(lpb):
                res.append(resnet(cin if j == 0 else ch, ch))
                if cfg.with_attn[i]:
                    attn.append(SpatialTransformer(ch, heads, g, ctx))
                skips.append(ch)
            last = i == n - 1
            down.append(_Block(res, attn, downsample=None if last else _conv3(ch, ch, stride=2)))
            if not last:
                skips.append(ch)
            cin = ch
        self.down_blocks = nn.ModuleList(down)
        cm, hm = chans[-1], cfg.attention_head_dim[-1]
        self.mid_block = _Block([resnet(cm, cm), resnet(cm, cm)],
                                [SpatialTransformer(cm, hm, g, ctx)])
        up, cin = [], cm
        for i, ch in enumerate(reversed(chans)):
            bi = n - 1 - i
            res, attn = [], []
            for j in range(lpb + 1):
                res.append(resnet(cin + skips.pop(), ch))
                if cfg.with_attn[bi]:
                    attn.append(SpatialTransformer(ch, cfg.attention_head_dim[bi], g, ctx))
                cin = ch
            up.append(_Block(res, attn, upsample=None if i == n - 1 else _conv3(ch, ch)))
        self.up_blocks = nn.ModuleList(up)
        self.conv_norm_out = nn.GroupNorm(g, c0, eps=1e-5)
        self.conv_out = _conv3(c0, cfg.out_channels)

    def forward(self, latents, timesteps, context):
        """latents [B, Cin, H, W]; timesteps a scalar or [B]; context [B, L,
        cross dim] -> [B, Cout, H, W], in the latents' type."""
        t = torch.as_tensor(timesteps, dtype=torch.float32, device=latents.device)
        if t.ndim == 0:
            t = t.expand(latents.shape[0])
        temb = self.time_embedding(timestep_embedding(t, self.cfg.block_out_channels[0]))
        temb = temb.to(latents.dtype)
        context = context.to(latents.dtype)

        h = self.conv_in(latents)
        skips = [h]
        for block in self.down_blocks:
            for j, res in enumerate(block.resnets):
                h = res(h, temb)
                if hasattr(block, "attentions"):
                    h = block.attentions[j](h, context)
                skips.append(h)
            if hasattr(block, "downsamplers"):
                h = block.downsamplers[0].conv(h)
                skips.append(h)
        mid = self.mid_block
        h = mid.resnets[1](mid.attentions[0](mid.resnets[0](h, temb), context), temb)
        for block in self.up_blocks:
            for j, res in enumerate(block.resnets):
                h = res(torch.cat([h, skips.pop()], dim=1), temb)
                if hasattr(block, "attentions"):
                    h = block.attentions[j](h, context)
            if hasattr(block, "upsamplers"):  # to the next skip's size (F11)
                h = F.interpolate(h, size=tuple(skips[-1].shape[2:]), mode="nearest")
                h = block.upsamplers[0].conv(h)
        return self.conv_out(F.silu(self.conv_norm_out(h)))
