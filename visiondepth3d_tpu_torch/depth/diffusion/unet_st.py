"""The spatio-temporal conditional UNet (SVD class): DepthCrafter's denoiser.

Counterpart of ``visiondepth3d_tpu/depth/diffusion/unet_st.py`` on
[B, T, C, H, W] tensors, under diffusers' ``UNetSpatioTemporalConditionModel``
parameter names (the ones the JAX package's ``convert_unet_st`` reads), so
a DepthCrafter checkpoint loads as it is:

- spatial sublayers fold T into the batch (NCHW frames);
- temporal sublayers fold the positions into the batch and work over T;
- each spatial resnet and transformer is followed by its temporal twin,
  the two merged by a learnable sigmoid mix (``time_mixer``, SVD's
  AlphaBlender): a * spatial + (1 - a) * temporal.

The temporal resnet runs diffusers' (3, 1, 1) Conv3d kernels as 3-tap
convolutions over T at each position and adds the per-frame time
embedding between them; its GroupNorm statistics are taken per position
over T, as the JAX package takes them (diffusers normalizes over T, H and
W). The temporal transformer self-attends over the T frames at each
position, then cross-attends to the first frame's CLIP context, repeated
for every position. The keys the JAX converter drops (``add_embedding``,
``add_time_proj``, the temporal blocks' ``norm_in`` / ``ff_in`` and the
frame-index embedding ``time_pos_embed``) have no counterpart here and
are left unloaded (ROADMAP Queue 3, F16).

Each up block upsamples (nearest) to the size of the skip it concatenates
next, as ``unet2d.py`` does: exactly 2x where the latent divides by
2^(levels - 1), the JAX package's upsample bit for bit; at 1080p (a
135-row latent) the JAX package cannot concatenate and raises (F11).

Self-attention goes through ``ops/attention.py:multi_head_attention``:
under the K7 opt-in the spatial self-attention at 512 <= H W < 4096 runs
K7; the temporal (T tokens) and cross (one context token) attention stay
on SDPA.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from .unet2d import TransformerBlock, _TimeEmbedding, timestep_embedding
from .vae import ResnetBlock, _Block, _conv3


@dataclasses.dataclass(frozen=True)
class UNetSTConfig:
    """DepthCrafter's UNet (``unet_config.json``): 8 channels in (the noisy
    depth latent and the frame latent), 4 out, SVD widths, heads (5, 10,
    20, 20) of 64 (``attention_head_dim`` holds head counts), cross
    attention to the 1024-wide CLIP image embedding."""

    in_channels: int = 8
    out_channels: int = 4
    block_out_channels: tuple = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    attention_head_dim: tuple = (5, 10, 20, 20)
    cross_attention_dim: int = 1024
    norm_groups: int = 32
    with_attn: tuple = (True, True, True, False)


UNET_ST_TINY = UNetSTConfig(block_out_channels=(16, 32), layers_per_block=1,
                            attention_head_dim=(2, 4), cross_attention_dim=16, norm_groups=4,
                            with_attn=(True, False))


class AlphaBlender(nn.Module):
    """out = a * spatial + (1 - a) * temporal, a = sigmoid(mix_factor)."""

    def __init__(self):
        super().__init__()
        self.mix_factor = nn.Parameter(torch.full((1,), 0.5))

    def forward(self, spatial, temporal):
        a = torch.sigmoid(self.mix_factor)
        return a * spatial + (1.0 - a) * temporal


def _conv_t(conv: nn.Conv3d, y: torch.Tensor) -> torch.Tensor:
    """A (3, 1, 1) Conv3d as a 3-tap convolution over T: y [N, C, T]."""
    return F.conv1d(y, conv.weight[..., 0, 0], conv.bias, padding=1)


class TemporalResnet(nn.Module):
    """diffusers' TemporalResnetBlock (width kept)."""

    def __init__(self, c: int, groups: int, temb_channels: int):
        super().__init__()
        self.norm1 = nn.GroupNorm(groups, c, eps=1e-5)
        self.conv1 = nn.Conv3d(c, c, (3, 1, 1), padding=(1, 0, 0))
        self.time_emb_proj = nn.Linear(temb_channels, c)
        self.norm2 = nn.GroupNorm(groups, c, eps=1e-5)
        self.conv2 = nn.Conv3d(c, c, (3, 1, 1), padding=(1, 0, 0))

    def forward(self, x, temb, t: int):  # x [BT, C, H, W], temb [BT, D]
        bt, c, h, w = x.shape
        b = bt // t
        y = x.reshape(b, t, c, h * w).permute(0, 3, 2, 1).reshape(b * h * w, c, t)
        r = _conv_t(self.conv1, F.silu(self.norm1(y)))
        te = self.time_emb_proj(F.silu(temb)).reshape(b, 1, t, c).transpose(2, 3)
        r = (r.reshape(b, h * w, c, t) + te).reshape(b * h * w, c, t)
        r = _conv_t(self.conv2, F.silu(self.norm2(r)))
        out = (y + r).reshape(b, h * w, c, t)
        return out.permute(0, 3, 2, 1).reshape(bt, c, h, w)


class STResnet(nn.Module):
    """diffusers' SpatioTemporalResBlock."""

    def __init__(self, cin: int, cout: int, groups: int, temb_channels: int):
        super().__init__()
        self.spatial_res_block = ResnetBlock(cin, cout, groups, 1e-5, temb_channels)
        self.temporal_res_block = TemporalResnet(cout, groups, temb_channels)
        self.time_mixer = AlphaBlender()

    def forward(self, x, temb, t: int):
        s = self.spatial_res_block(x, temb)
        return self.time_mixer(s, self.temporal_res_block(s, temb, t))


class STTransformer(nn.Module):
    """diffusers' TransformerSpatioTemporalModel: a spatial transformer
    block and a temporal one, alpha-blended, between linear projections."""

    def __init__(self, c: int, heads: int, groups: int, ctx_dim: int):
        super().__init__()
        self.norm = nn.GroupNorm(groups, c, eps=1e-6)
        self.proj_in = nn.Linear(c, c)
        self.transformer_blocks = nn.ModuleList([TransformerBlock(c, heads, ctx_dim)])
        self.temporal_transformer_blocks = nn.ModuleList([TransformerBlock(c, heads, ctx_dim)])
        self.time_mixer = AlphaBlender()
        self.proj_out = nn.Linear(c, c)

    def forward(self, x, ctx, t: int):  # x [BT, C, H, W]; ctx [BT, L, D]
        bt, c, h, w = x.shape
        b, n = bt // t, h * w
        y = self.proj_in(self.norm(x).flatten(2).transpose(1, 2))  # [BT, N, C]
        y = self.transformer_blocks[0](y, ctx)
        # the T frames at each position; cross attention to the first
        # frame's context (diffusers' time_context_first_timestep)
        z = y.reshape(b, t, n, c).transpose(1, 2).reshape(b * n, t, c)
        tctx = ctx.reshape(b, t, *ctx.shape[1:])[:, 0].repeat_interleave(n, dim=0)
        z = self.temporal_transformer_blocks[0](z, tctx)
        z = z.reshape(b, n, t, c).transpose(1, 2).reshape(bt, n, c)
        y = self.proj_out(self.time_mixer(y, z))
        return x + y.transpose(1, 2).reshape(bt, c, h, w)


class UNetSpatioTemporal(nn.Module):
    def __init__(self, cfg: UNetSTConfig = UNetSTConfig()):
        super().__init__()
        self.cfg = cfg
        chans, g, lpb = cfg.block_out_channels, cfg.norm_groups, cfg.layers_per_block
        n, c0, temb = len(chans), chans[0], 4 * chans[0]
        ctx = cfg.cross_attention_dim
        self.conv_in = _conv3(cfg.in_channels, c0)
        self.time_embedding = _TimeEmbedding(c0)

        def resnet(cin, cout):
            return STResnet(cin, cout, g, temb)

        skips, down, cin = [c0], [], c0
        for i, ch in enumerate(chans):
            res, attn = [], []
            for j in range(lpb):
                res.append(resnet(cin if j == 0 else ch, ch))
                if cfg.with_attn[i]:
                    attn.append(STTransformer(ch, cfg.attention_head_dim[i], g, ctx))
                skips.append(ch)
            last = i == n - 1
            down.append(_Block(res, attn, downsample=None if last else _conv3(ch, ch, stride=2)))
            if not last:
                skips.append(ch)
            cin = ch
        self.down_blocks = nn.ModuleList(down)
        cm, hm = chans[-1], cfg.attention_head_dim[-1]
        self.mid_block = _Block([resnet(cm, cm), resnet(cm, cm)], [STTransformer(cm, hm, g, ctx)])
        up, cin = [], cm
        for i, ch in enumerate(reversed(chans)):
            bi = n - 1 - i
            res, attn = [], []
            for j in range(lpb + 1):
                res.append(resnet(cin + skips.pop(), ch))
                if cfg.with_attn[bi]:
                    attn.append(STTransformer(ch, cfg.attention_head_dim[bi], g, ctx))
                cin = ch
            up.append(_Block(res, attn, upsample=None if i == n - 1 else _conv3(ch, ch)))
        self.up_blocks = nn.ModuleList(up)
        self.conv_norm_out = nn.GroupNorm(g, c0, eps=1e-5)
        self.conv_out = _conv3(c0, cfg.out_channels)

    def forward(self, latents, timesteps, context):
        """latents [B, T, Cin, H, W]; timesteps a scalar, [B] or [B, T] (one
        embedding per frame); context [B, L, D] (CLIP image embeddings) ->
        [B, T, Cout, H, W], in the latents' type."""
        b, t = latents.shape[:2]
        ts = torch.as_tensor(timesteps, dtype=torch.float32, device=latents.device)
        ts = ts.expand(b, t) if ts.ndim == 0 else ts.reshape(b, -1).expand(b, t)
        temb = self.time_embedding(timestep_embedding(ts.reshape(b * t),
                                                      self.cfg.block_out_channels[0]))
        # the whole net at the latents' type (an f32 temb would promote it)
        temb = temb.to(latents.dtype)
        ctx = context.repeat_interleave(t, dim=0).to(latents.dtype)  # [BT, L, D]

        h = self.conv_in(latents.flatten(0, 1))
        skips = [h]
        for block in self.down_blocks:
            for j, res in enumerate(block.resnets):
                h = res(h, temb, t)
                if hasattr(block, "attentions"):
                    h = block.attentions[j](h, ctx, t)
                skips.append(h)
            if hasattr(block, "downsamplers"):
                h = block.downsamplers[0].conv(h)
                skips.append(h)
        mid = self.mid_block
        h = mid.resnets[1](mid.attentions[0](mid.resnets[0](h, temb, t), ctx, t), temb, t)
        for block in self.up_blocks:
            for j, res in enumerate(block.resnets):
                h = res(torch.cat([h, skips.pop()], dim=1), temb, t)
                if hasattr(block, "attentions"):
                    h = block.attentions[j](h, ctx, t)
            if hasattr(block, "upsamplers"):  # to the next skip's size (F11)
                h = F.interpolate(h, size=tuple(skips[-1].shape[2:]), mode="nearest")
                h = block.upsamplers[0].conv(h)
        out = self.conv_out(F.silu(self.conv_norm_out(h)))
        return out.reshape(b, t, *out.shape[1:])
