"""Depth of field: a Gaussian level-of-detail stack and a per-pixel lerp.

Counterpart of ``visiondepth3d_tpu/ops/dof.py``. ``num_levels`` blur
levels with sigma in linspace(0, max_sigma, num_levels), kernel size
2 * ceil(2 sigma) + 1; the per-pixel blur index is |depth - focal| /
focus_width clamped to [0, 1] and scaled to [0, N - 1], and the two
neighbouring levels are lerped. Computes in float32 and returns the image's
dtype (one rounding for a bf16 image plane).
"""

from __future__ import annotations

import math

import torch

from .filters import gaussian_blur


def level_sigmas(max_sigma: float, num_levels: int) -> list[float]:
    return [float(max_sigma) * i / (num_levels - 1) for i in range(num_levels)]


def level_ksize(sigma: float) -> int:
    return int(2 * math.ceil(2 * sigma) + 1)


def apply_dof(rgb: torch.Tensor, depth: torch.Tensor, focal_depth, max_sigma: float = 2.0,
              focus_width: float = 0.35, num_levels: int = 5) -> torch.Tensor:
    """rgb [H, W, 3], depth [H, W], focal_depth a scalar (a 0-d tensor on
    rgb's device or a float; never read on the host). Returns [H, W, 3]."""
    dt, x = rgb.dtype, rgb.float()
    n = num_levels
    diff = torch.abs(depth.float() - focal_depth)
    weights = torch.clamp(diff / (focus_width + 1e-6), 0.0, 1.0)
    idx = torch.clamp(weights * (n - 1), 0.0, n - 1 - 1e-6)
    lower = torch.clamp(torch.floor(idx), 0, n - 2)
    # the pixel reads (1 - alpha) of level `lower` and alpha of `lower + 1`
    alpha = (idx - lower)[..., None]
    lower = lower[..., None]
    out = torch.zeros_like(x)
    for i, sigma in enumerate(level_sigmas(max_sigma, num_levels)):
        img = x if sigma == 0.0 else gaussian_blur(x, level_ksize(sigma), sigma)
        w_lo = (lower == i).float() * (1.0 - alpha)
        w_hi = (lower == i - 1).float() * alpha
        out = out + img * (w_lo + w_hi)
    return torch.clamp(out, 0.0, 1.0).to(dt)
