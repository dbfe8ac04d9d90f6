"""DepthCrafter: video depth by spatio-temporal diffusion over sliding windows.

Counterpart of ``visiondepth3d_tpu/depth/diffusion/depthcrafter.py`` (the
reference's SVD-derived pipeline), on one device:

- conditioning: the VAE latents of the frames (noise-augmented by 0.02,
  concatenated with the noisy depth latent into the UNet's 8 channels) and
  the CLIP image embedding of the first frame as the cross-attention
  context;
- Euler steps with the EDM preconditioning, c_noise = 0.25 log sigma;
- windows of ``window_size`` frames overlapping by ``overlap``: each
  window after the first re-seeds its overlap from the previous window's
  final latents plus fresh noise, and the windows are stitched in float32
  with linear cross-fade weights;
- the depth latents decoded one frame at a time, their channel mean taken
  in float32; ``__call__`` min-max normalizes over the whole clip.

The public layout is the JAX package's: frames [T, H, W, 3] float RGB in
[0, 1] (H, W multiples of the latent stride), depth [T, H, W] float32.
Every random draw goes through ``_draw(shape, gen)`` in the JAX package's
layout (the augmentation noise [T, H, W, 3], each window's [1, Tw, h, w,
4]); from a seed it comes from a ``torch.Generator`` on the pipeline's
device, so one seed gives other noise than ``jax.random``. The VAE encodes
the frames in chunks of ``_ENCODE_CHUNK`` (the encoder is per frame, so the
chunks change nothing but the memory: one 1080p frame's first level is
0.5 GB in bfloat16).

The window-parallel mode (``run_raw_parallel``) denoises every window at
once over the ``dp`` devices of a mesh, window g on device g mod dp with
the UNet replicated once per distinct device: instead of re-seeding each
window's overlap from the previous window's latents (a serial chain), the
noise is drawn per frame (``[T, h, w, 4]``, one draw) and every window
that covers a frame sees that frame's noise. The JAX package pads the
window count to a multiple of dp for its sharding; here each window simply
goes to its device, so nothing is padded.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ...device import DEFAULT_DEVICE, resolve_device
from ...ops.resize import resize_bilinear
from ...parallel.mesh import Mesh, replicate
from ..model import _DTYPES
from .clip_vision import CLIPVisionEncoder
from .schedulers import EulerSchedule, svd_precondition
from .unet_st import UNetSpatioTemporal
from .vae import AutoencoderKL

_ENCODE_CHUNK = 8  # frames per VAE encoder call
_NOISE_AUG = 0.02  # the conditioning frames' noise augmentation


class DepthCrafterPipeline:
    """The ST-UNet, the VAE and the CLIP encoder with their weights loaded,
    on one device, in one type (bfloat16 casts the weights once; the
    compute type is the weights')."""

    def __init__(self, unet: UNetSpatioTemporal, vae: AutoencoderKL, clip: CLIPVisionEncoder,
                 num_steps: int = 2, window_size: int = 24, overlap: int = 6,
                 dtype: str = "float32", device=DEFAULT_DEVICE):
        if dtype not in _DTYPES:
            raise ValueError(f"dtype {dtype!r} not in {tuple(_DTYPES)}")
        # overlap >= window (the reference GUI ships 24 / 25, whose stride
        # of -1 never ends) clamps to window - 1: stride 1, full coverage
        if overlap >= window_size:
            overlap = window_size - 1
        self.device = resolve_device(device)
        self.dtype = dtype
        cdt = _DTYPES[dtype]
        self.unet = unet.to(device=self.device, dtype=cdt).eval()
        self.vae = vae.to(device=self.device, dtype=cdt).eval()
        self.clip = clip.to(device=self.device, dtype=cdt).eval()
        self.unet_cfg, self.vae_cfg, self.clip_cfg = unet.cfg, vae.cfg, clip.cfg
        self.compute_dtype = next(self.unet.parameters()).dtype
        self.num_steps, self.window_size, self.overlap = num_steps, window_size, overlap
        self.schedule = EulerSchedule(num_inference_steps=num_steps)

    @property
    def stride(self) -> int:
        """Pixels per latent: 2^(VAE levels - 1)."""
        return 2 ** (len(self.vae_cfg.block_out_channels) - 1)

    def _windows(self, t: int) -> list[int]:
        if t <= self.window_size:
            return [0]
        starts = list(range(0, t - self.window_size, self.window_size - self.overlap))
        starts.append(t - self.window_size)
        return starts

    def _draw(self, shape, gen: torch.Generator) -> torch.Tensor:
        """Standard normal noise of ``shape`` (float32, on the device)."""
        return torch.randn(shape, generator=gen, device=self.device, dtype=torch.float32)

    @torch.no_grad()
    def _denoise_window(self, cond, ctx, init, unet=None):
        """cond [1, Tw, 4, h, w] frame latents; ctx [1, 1, D]; init [1, Tw, 4,
        h, w] = noise * sigma0 (the overlap possibly re-seeded) -> the final
        latents, in the compute type; on ``unet``'s device (default: the
        pipeline's UNet)."""
        cdt = self.compute_dtype
        unet = unet if unet is not None else self.unet
        cond, ctx, latent = cond.to(cdt), ctx.to(cdt), init.to(cdt)
        for i in range(self.num_steps):
            sigma = float(self.schedule.sigmas[i])
            c_skip, c_out, c_in = svd_precondition(sigma)
            f = unet(torch.cat([latent * c_in, cond], dim=2), 0.25 * math.log(sigma), ctx)
            latent = self.schedule.step(c_skip * latent + c_out * f, i, latent)
        return latent

    def _encode(self, frames01):
        """[T, H, W, 3] in [0, 1] -> the VAE posterior modes [T, 4, h, w]."""
        x = frames01.to(self.compute_dtype) * 2.0 - 1.0
        return torch.cat([self.vae.encode_mode(c.permute(0, 3, 1, 2))
                          for c in x.split(_ENCODE_CHUNK)])

    def _decode(self, latents):
        """[T, 4, h, w] -> [T, H, W] float32: one frame at a time, the
        decoded channels' mean in float32."""
        return torch.stack([self.vae.decode(z[None].to(self.compute_dtype))[0].float().mean(0)
                            for z in latents])

    def _condition(self, frames01, seed: int):
        """(frames [T, H, W, 3] float32, the augmented frames' latents [T, 4,
        h, w], the CLIP context [1, 1, D], the generator the windows draw
        from next)."""
        frames = torch.as_tensor(frames01, dtype=torch.float32).to(self.device)
        gen = torch.Generator(self.device).manual_seed(seed)
        aug = frames + _NOISE_AUG * self._draw(tuple(frames.shape), gen).to(self.device)
        cond = self._encode(aug)  # [T, 4, h, w]
        s = self.clip_cfg.image_size
        clip_in = resize_bilinear(frames[:1], (s, s), channel_last=True)
        ctx = self.clip(clip_in.to(self.compute_dtype))[:, None, :]  # [1, 1, D]
        return frames, cond, ctx, gen

    def _ramp(self, start: int, tw: int) -> torch.Tensor:
        """A window's cross-fade weights [Tw, 1, 1, 1]: linear over the
        overlap of every window but the first."""
        ramp = np.ones(tw, np.float32)
        if start > 0:
            ov = min(self.overlap, tw)
            ramp[:ov] = np.linspace(1.0 / (ov + 1), 1.0, ov, endpoint=False)
        return torch.from_numpy(ramp).to(self.device)[:, None, None, None]

    def _stitch(self, finals, starts, cond_shape) -> torch.Tensor:
        """The windows' final latents [1, Tw, 4, h, w] cross-faded in float32
        and decoded -> [T, H, W] float32."""
        t = cond_shape[0]
        out = torch.zeros(cond_shape, dtype=torch.float32, device=self.device)
        weights = torch.zeros((t, 1, 1, 1), dtype=torch.float32, device=self.device)
        for final, start in zip(finals, starts):
            wgt = self._ramp(start, final.shape[1])
            out[start: start + final.shape[1]] += final[0].to(self.device) * wgt
            weights[start: start + final.shape[1]] += wgt
        return self._decode(out / torch.clamp(weights, min=1e-8))

    @torch.no_grad()
    def run_raw(self, frames01, seed: int = 0) -> torch.Tensor:
        """Sliding-window denoise -> UNNORMALIZED [T, H, W] float32 depth (the
        streaming route normalizes over the whole clip after stitching)."""
        frames, cond, ctx, gen = self._condition(frames01, seed)
        t = frames.shape[0]
        tw = min(self.window_size, t)
        sigma0 = float(self.schedule.sigmas[0])
        c, h, w = cond.shape[1:]
        starts, finals = self._windows(t), []
        prev_final, prev_start = None, 0
        for start in starts:
            noise = self._draw((1, tw, h, w, c), gen).to(self.device).permute(0, 1, 4, 2, 3)
            init = noise * sigma0
            if prev_final is not None:
                # the overlap re-seeded from the previous window's final latents
                ov = max(0, min(prev_start + tw - start, tw))
                if ov > 0:
                    tail = prev_final[:, -ov:] if start > prev_start else prev_final[:, :ov]
                    init = torch.cat([tail + init[:, :ov], init[:, ov:]], dim=1)
            final = self._denoise_window(cond[start: start + tw][None], ctx, init)
            prev_final, prev_start = final, start
            finals.append(final)
        return self._stitch(finals, starts, cond.shape)

    @torch.no_grad()
    def denoise_windows_parallel(self, cond, ctx, noise_full, starts,
                                 mesh: Mesh | None = None) -> list[torch.Tensor]:
        """Every window at once: window g (cond [T, 4, h, w] and noise_full
        [T, 4, h, w] at its frames) denoised on the mesh's dp device g mod dp
        (the pipeline's device without a mesh), each device's UNet replica
        once. Each window is enqueued before any is read. -> the final
        latents [1, Tw, 4, h, w] per window, on their devices."""
        devices = [self.device]
        if mesh is not None:
            devices = list(mesh.devices[:, 0, 0])
        unets = {d: replicate(self.unet, d) for d in dict.fromkeys(devices)}
        tw = min(self.window_size, cond.shape[0])
        sigma0 = float(self.schedule.sigmas[0])
        finals = []
        for g, start in enumerate(starts):
            d = devices[g % len(devices)]
            finals.append(self._denoise_window(
                cond[start: start + tw][None].to(d), ctx.to(d),
                (noise_full[start: start + tw] * sigma0)[None].to(d), unet=unets[d]))
        return finals

    @torch.no_grad()
    def run_raw_parallel(self, frames01, seed: int = 0, mesh: Mesh | None = None):
        """Window-parallel denoise -> UNNORMALIZED [T, H, W] float32 depth:
        the augmentation noise, then the per-frame window noise [T, h, w, 4]
        (one ``_draw`` each), the windows over the mesh
        (``denoise_windows_parallel``), the cross-fade and decode of
        ``run_raw``. With a mesh this is the streaming route's per-segment
        worker."""
        frames, cond, ctx, gen = self._condition(frames01, seed)
        t, (c, h, w) = frames.shape[0], cond.shape[1:]
        noise_full = self._draw((t, h, w, c), gen).to(self.device).permute(0, 3, 1, 2)
        starts = self._windows(t)
        finals = self.denoise_windows_parallel(cond, ctx, noise_full, starts, mesh)
        return self._stitch(finals, starts, cond.shape)

    def run_parallel(self, frames01, seed: int = 0, mesh: Mesh | None = None) -> torch.Tensor:
        """Throughput mode: ``run_raw_parallel`` min-max normalized over the
        whole clip (the output contract of ``__call__``)."""
        return _minmax(self.run_raw_parallel(frames01, seed, mesh))

    def __call__(self, frames01, seed: int = 0) -> torch.Tensor:
        """[T, H, W, 3] in [0, 1] -> [T, H, W] depth in [0, 1], min-max
        normalized over the whole clip."""
        return _minmax(self.run_raw(frames01, seed))


def _minmax(depth: torch.Tensor) -> torch.Tensor:
    lo, hi = depth.min(), depth.max()
    return torch.clamp((depth - lo) / torch.clamp(hi - lo, min=1e-9), 0.0, 1.0)


def __getattr__(name: str):
    # ``tiny_depthcrafter`` is defined in ``loaders``, which imports this module; it is
    # importable from here too, where the JAX package defines it
    if name == "tiny_depthcrafter":
        from .loaders import tiny_depthcrafter

        return tiny_depthcrafter
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
