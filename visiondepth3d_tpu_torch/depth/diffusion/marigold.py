"""Marigold: depth by image diffusion.

Counterpart of ``visiondepth3d_tpu/depth/diffusion/marigold.py``: the RGB
frame is encoded to SD latents, a DDIM v-prediction loop denoises a depth
latent conditioned by channel concatenation with the RGB latent (the
UNet's 8 input channels) and on the empty-prompt text embedding, the
result is decoded and its channel mean mapped to [0, 1]. Ensembles run E
noise draws and take their median: the JAX package's median, which for an
even E is the mean of the two middle values (``torch.median`` returns the
lower one).

The public layout is the JAX package's: frames [B, H, W, 3] float RGB in
[0, 1], noise [B, H / s, W / s, latent] (s = 2^(VAE levels - 1)), depth
[B, H, W] float32. Noise drawn from a seed comes from a
``torch.Generator`` on the pipeline's device, so one seed gives other
noise than ``jax.random``; ``_run`` and ``_run_ens`` take the noise.
"""

from __future__ import annotations

import numpy as np
import torch

from ...device import DEFAULT_DEVICE, resolve_device
from ..model import _DTYPES
from .schedulers import DDIMSchedule
from .unet2d import UNet2DCondition
from .vae import AutoencoderKL


def median0(x: torch.Tensor) -> torch.Tensor:
    """The median over dim 0 as ``jnp.median`` takes it: the mean of the
    two middle values for an even count."""
    s = torch.sort(x, dim=0).values
    e = x.shape[0]
    if e % 2:
        return s[e // 2]
    return (s[e // 2 - 1] + s[e // 2]) / 2


class MarigoldPipeline:
    """A UNet and a VAE with their weights loaded, on one device, in one
    type (bfloat16 casts the weights once)."""

    def __init__(self, unet: UNet2DCondition, vae: AutoencoderKL, empty_text_embed,
                 num_steps: int = 4, ensemble_size: int = 1, dtype: str = "float32",
                 device=DEFAULT_DEVICE):
        if dtype not in _DTYPES:
            raise ValueError(f"dtype {dtype!r} not in {tuple(_DTYPES)}")
        self.device = resolve_device(device)
        self.dtype = dtype
        cdt = _DTYPES[dtype]
        self.unet = unet.to(device=self.device, dtype=cdt).eval()
        self.vae = vae.to(device=self.device, dtype=cdt).eval()
        self.unet_cfg, self.vae_cfg = unet.cfg, vae.cfg
        self.num_steps, self.ensemble_size = num_steps, ensemble_size
        self.schedule = DDIMSchedule(num_inference_steps=num_steps)
        self.ctx = torch.as_tensor(np.asarray(empty_text_embed, np.float32)).to(self.device, cdt)

    @property
    def stride(self) -> int:
        """Pixels per latent: 2^(VAE levels - 1)."""
        return 2 ** (len(self.vae_cfg.block_out_channels) - 1)

    def _denoise(self, rgb_latent, depth_latent):
        """The DDIM loop over [RGB latent, depth latent] (NCHW)."""
        ctx = self.ctx.expand(rgb_latent.shape[0], *self.ctx.shape[1:])
        for i, t in enumerate(self.schedule.timesteps):
            v = self.unet(torch.cat([rgb_latent, depth_latent], dim=1), float(t), ctx)
            depth_latent = self.schedule.step(v, i, depth_latent)
        return depth_latent

    def _depth01(self, decoded):
        """Decoded [B, 3, H, W] in [-1, 1] -> [B, H, W] channel mean in [0, 1]."""
        return torch.clamp((decoded.float().mean(dim=1) + 1.0) / 2.0, 0.0, 1.0)

    def _rgb_latent(self, rgb01):
        cdt = _DTYPES[self.dtype]
        rgb = rgb01.to(device=self.device, dtype=cdt).permute(0, 3, 1, 2) * 2.0 - 1.0
        return self.vae.encode_mode(rgb)

    def _noise(self, noise):
        return noise.to(device=self.device, dtype=_DTYPES[self.dtype]).movedim(-1, -3)

    @torch.no_grad()
    def _run(self, rgb01: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        """rgb01 [B, H, W, 3]; noise [B, h, w, latent] -> depth [B, H, W]."""
        depth_latent = self._denoise(self._rgb_latent(rgb01), self._noise(noise))
        return self._depth01(self.vae.decode(depth_latent))

    @torch.no_grad()
    def _run_ens(self, rgb01: torch.Tensor, noise_e: torch.Tensor) -> torch.Tensor:
        """Ensemble members folded into the batch (member-major), the RGB
        latent encoded once; members decoded one at a time; the median.
        noise_e [E, B, h, w, latent] -> [B, H, W]."""
        e, b = noise_e.shape[:2]
        rgb_latent = self._rgb_latent(rgb01).repeat(e, 1, 1, 1)
        depth_latent = self._denoise(rgb_latent, self._noise(noise_e.flatten(0, 1)))
        depth = torch.stack([self._depth01(self.vae.decode(z[None]))[0] for z in depth_latent])
        return median0(depth.reshape(e, b, *depth.shape[1:]))

    def _draw(self, shape, seed: int) -> torch.Tensor:
        gen = torch.Generator(self.device).manual_seed(seed)
        return torch.randn(shape, generator=gen, device=self.device, dtype=torch.float32)

    def _latent_shape(self, rgb01) -> tuple:
        b, h, w = rgb01.shape[:3]
        return (b, h // self.stride, w // self.stride, self.vae_cfg.latent_channels)

    def run_ensemble(self, rgb01: torch.Tensor, seed: int = 0) -> torch.Tensor:
        """[B, H, W, 3] -> [B, H, W]; every ensemble member in one batch."""
        return self._run_ens(rgb01, self._draw((self.ensemble_size, *self._latent_shape(rgb01)),
                                               seed))

    def __call__(self, rgb01: torch.Tensor, seed: int = 0) -> torch.Tensor:
        """[B, H, W, 3] float RGB in [0, 1] (H, W multiples of ``stride``)
        -> [B, H, W] depth in [0, 1]; member e draws its noise from seed + e,
        and an ensemble takes the median."""
        outs = [self._run(rgb01, self._draw(self._latent_shape(rgb01), seed + e))
                for e in range(self.ensemble_size)]
        return outs[0] if len(outs) == 1 else median0(torch.stack(outs))


def __getattr__(name: str):
    # ``tiny_marigold`` is defined in ``loaders``, which imports this module; it is
    # importable from here too, where the JAX package defines it
    if name == "tiny_marigold":
        from .loaders import tiny_marigold

        return tiny_marigold
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
