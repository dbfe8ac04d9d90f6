"""Stable Diffusion's AutoencoderKL, the latent codec of Marigold.

Counterpart of ``visiondepth3d_tpu/depth/diffusion/vae.py`` on NCHW
tensors, under diffusers' ``AutoencoderKL`` parameter names, so a diffusers
checkpoint loads as it is. The encoder is conv_in, down blocks of resnets
with stride-2 downsamplers (padded (0, 1, 0, 1) first), a mid block with
one single-head attention, GroupNorm/SiLU and conv_out to the posterior's
moments; the decoder mirrors it with 2x nearest upsamplers. diffusers'
``quant_conv`` / ``post_quant_conv`` stay separate 1x1 layers here (the JAX
converter folds them into the neighbouring convs: a difference of rounding
only); a checkpoint without them loads them as the identity.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.attention import multi_head_attention


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    """The SD VAE (``prs-eth/marigold-depth-v1-0`` ``vae/config.json``)."""

    block_out_channels: tuple = (128, 256, 512, 512)
    layers_per_block: int = 2
    latent_channels: int = 4
    norm_groups: int = 32
    scaling_factor: float = 0.18215
    in_channels: int = 3
    out_channels: int = 3


VAE_TINY = VAEConfig(block_out_channels=(16, 32), layers_per_block=1, norm_groups=4)


def _conv3(cin: int, cout: int, stride: int = 1, padding: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, stride=stride, padding=padding)


class ResnetBlock(nn.Module):
    """GroupNorm/SiLU/conv twice with a residual (a 1x1 ``conv_shortcut``
    where the width changes); the UNet's adds its time embedding
    (``time_emb_proj``) between the convs."""

    def __init__(self, cin: int, cout: int, groups: int, eps: float,
                 temb_channels: int | None = None):
        super().__init__()
        self.norm1 = nn.GroupNorm(groups, cin, eps=eps)
        self.conv1 = _conv3(cin, cout)
        if temb_channels is not None:
            self.time_emb_proj = nn.Linear(temb_channels, cout)
        self.norm2 = nn.GroupNorm(groups, cout, eps=eps)
        self.conv2 = _conv3(cout, cout)
        if cin != cout:
            self.conv_shortcut = nn.Conv2d(cin, cout, 1)

    def forward(self, x, temb=None):
        h = self.conv1(F.silu(self.norm1(x)))
        if temb is not None:
            h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(F.silu(self.norm2(h)))
        if hasattr(self, "conv_shortcut"):
            x = self.conv_shortcut(x)
        return x + h


class AttnBlock(nn.Module):
    """One-head self-attention over the H W positions, with a residual."""

    def __init__(self, c: int, groups: int):
        super().__init__()
        self.group_norm = nn.GroupNorm(groups, c, eps=1e-6)
        self.to_q = nn.Linear(c, c)
        self.to_k = nn.Linear(c, c)
        self.to_v = nn.Linear(c, c)
        self.to_out = nn.ModuleList([nn.Linear(c, c)])

    def forward(self, x):
        b, c, h, w = x.shape
        y = self.group_norm(x).flatten(2).transpose(1, 2)  # [B, H W, C]
        q, k, v = (lin(y)[:, :, None, :] for lin in (self.to_q, self.to_k, self.to_v))
        y = self.to_out[0](multi_head_attention(q, k, v)[:, :, 0])
        return x + y.transpose(1, 2).reshape(b, c, h, w)


class _Sampler(nn.Module):
    """diffusers' Downsample2D / Upsample2D holder of one ``conv``."""

    def __init__(self, conv: nn.Conv2d):
        super().__init__()
        self.conv = conv


class _Block(nn.Module):
    def __init__(self, resnets, attentions=(), downsample=None, upsample=None):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        if attentions:
            self.attentions = nn.ModuleList(attentions)
        if downsample is not None:
            self.downsamplers = nn.ModuleList([_Sampler(downsample)])
        if upsample is not None:
            self.upsamplers = nn.ModuleList([_Sampler(upsample)])


def _mid_block(c: int, groups: int) -> _Block:
    return _Block([ResnetBlock(c, c, groups, 1e-6), ResnetBlock(c, c, groups, 1e-6)],
                  [AttnBlock(c, groups)])


def _mid(block: _Block, h):
    return block.resnets[1](block.attentions[0](block.resnets[0](h)))


class Encoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        chans, g = cfg.block_out_channels, cfg.norm_groups
        self.conv_in = _conv3(cfg.in_channels, chans[0])
        blocks, cin = [], chans[0]
        for i, ch in enumerate(chans):
            res = [ResnetBlock(cin if j == 0 else ch, ch, g, 1e-6)
                   for j in range(cfg.layers_per_block)]
            down = _conv3(ch, ch, stride=2, padding=0) if i < len(chans) - 1 else None
            blocks.append(_Block(res, downsample=down))
            cin = ch
        self.down_blocks = nn.ModuleList(blocks)
        self.mid_block = _mid_block(chans[-1], g)
        self.conv_norm_out = nn.GroupNorm(g, chans[-1], eps=1e-6)
        self.conv_out = _conv3(chans[-1], 2 * cfg.latent_channels)

    def forward(self, x):
        h = self.conv_in(x)
        for block in self.down_blocks:
            for res in block.resnets:
                h = res(h)
            if hasattr(block, "downsamplers"):
                h = block.downsamplers[0].conv(F.pad(h, (0, 1, 0, 1)))
        h = _mid(self.mid_block, h)
        return self.conv_out(F.silu(self.conv_norm_out(h)))


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        chans, g = tuple(reversed(cfg.block_out_channels)), cfg.norm_groups
        self.conv_in = _conv3(cfg.latent_channels, chans[0])
        self.mid_block = _mid_block(chans[0], g)
        blocks, cin = [], chans[0]
        for i, ch in enumerate(chans):
            res = [ResnetBlock(cin if j == 0 else ch, ch, g, 1e-6)
                   for j in range(cfg.layers_per_block + 1)]
            blocks.append(_Block(res, upsample=_conv3(ch, ch) if i < len(chans) - 1 else None))
            cin = ch
        self.up_blocks = nn.ModuleList(blocks)
        self.conv_norm_out = nn.GroupNorm(g, chans[-1], eps=1e-6)
        self.conv_out = _conv3(chans[-1], cfg.out_channels)

    def forward(self, z):
        h = _mid(self.mid_block, self.conv_in(z))
        for block in self.up_blocks:
            for res in block.resnets:
                h = res(h)
            if hasattr(block, "upsamplers"):
                h = block.upsamplers[0].conv(F.interpolate(h, scale_factor=2.0, mode="nearest"))
        return self.conv_out(F.silu(self.conv_norm_out(h)))


class AutoencoderKL(nn.Module):
    def __init__(self, cfg: VAEConfig = VAEConfig()):
        super().__init__()
        self.cfg = cfg
        lat = cfg.latent_channels
        self.encoder = Encoder(cfg)
        self.decoder = Decoder(cfg)
        self.quant_conv = nn.Conv2d(2 * lat, 2 * lat, 1)
        self.post_quant_conv = nn.Conv2d(lat, lat, 1)

    def encode_moments(self, x):
        """[B, 3, H, W] -> the posterior's moments (mean, log variance),
        [B, 2 latent, H / 2^(n-1), W / 2^(n-1)]."""
        return self.quant_conv(self.encoder(x))

    def encode_mode(self, x):
        """[B, 3, H, W] in [-1, 1] -> the posterior's mode in latent units
        (times ``scaling_factor``), [B, latent, H / 2^(n-1), W / 2^(n-1)]."""
        return self.encode_moments(x)[:, : self.cfg.latent_channels] * self.cfg.scaling_factor

    def decode(self, z):
        return self.decoder(self.post_quant_conv(z / self.cfg.scaling_factor))

    def forward(self, x):
        return self.decode(self.encode_mode(x))


def identity_quant_convs(state: dict, lat: int) -> dict:
    """``state`` with identity ``quant_conv`` / ``post_quant_conv`` added
    where the checkpoint has none (diffusers' ``use_quant_conv=False``)."""
    state = dict(state)
    for name, c in (("quant_conv", 2 * lat), ("post_quant_conv", lat)):
        if f"{name}.weight" not in state:
            state[f"{name}.weight"] = torch.eye(c)[:, :, None, None]
            state[f"{name}.bias"] = torch.zeros(c)
    return state
