"""Small stencil filters: box blur, Gaussian blur, sharpening, gradients.

Counterpart of ``visiondepth3d_tpu/ops/filters.py``:
- ``box_blur``: k x k mean, stride 1, zero padding counted in the mean
  (``F.avg_pool2d(count_include_pad=True)`` semantics);
- ``gaussian_blur``: separable, torchvision-style weights, reflect padding
  (no edge repeat), rows first then columns;
- ``sharpen``: the brightness-preserving 3x3 cross kernel with a
  reflect-101 border, clamped to [0, 1];
- ``bilateral_smooth_depth``: cv2's bilateral filter on a depth plane in
  u8 value scale (circular window, reflect-101 border), kept in float;
- ``forward_diff_grad``: left/top zero-padded forward differences.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


def box_blur(x: torch.Tensor, ksize: int) -> torch.Tensor:
    """Mean over a k x k window of the last two axes ([..., H, W]).

    Separable window sums, accumulated in float32 whatever the input type
    (a bf16 sum of 81 taps would lose most of its bits), returned in the
    input type.
    """
    if ksize <= 1:
        return x
    pad = ksize // 2
    h, w = x.shape[-2], x.shape[-1]
    xf = x.float()
    xp = F.pad(xf, (0, 0, pad, ksize - 1 - pad))
    acc = xp[..., 0:h, :]
    for o in range(1, ksize):
        acc = acc + xp[..., o:o + h, :]
    xp = F.pad(acc, (pad, ksize - 1 - pad))
    acc = xp[..., 0:w]
    for o in range(1, ksize):
        acc = acc + xp[..., o:o + w]
    return (acc / float(ksize * ksize)).to(x.dtype)


@functools.lru_cache(maxsize=64)
def _gaussian_kernel_1d(ksize: int, sigma: float) -> np.ndarray:
    """torchvision's 1-D Gaussian: exp(-(x/sigma)^2/2) on the ksize taps
    centred at 0, normalized, as float32."""
    lim = (ksize - 1) / 2.0
    x = np.linspace(-lim, lim, ksize)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def _reflect_index(n: int, pad: int, device=None) -> torch.Tensor:
    """Source indices of an axis of length n padded by ``pad`` on both
    sides with reflection about the edge samples (index -1 reads 1), as
    ``jnp.pad(mode="reflect")``; pads wider than the axis reflect again."""
    i = torch.arange(-pad, n + pad, device=device)
    if n == 1:
        return torch.zeros_like(i)
    period = 2 * (n - 1)
    i = torch.remainder(i, period)
    return torch.where(i >= n, period - i, i)


def gaussian_blur(x: torch.Tensor, ksize: int, sigma: float) -> torch.Tensor:
    """Separable Gaussian blur of [H, W] or [H, W, C] with reflect padding,
    rows first. Sums in float32, returns x's dtype (one rounding)."""
    if sigma <= 0.0 or ksize <= 1:
        return x
    k = _gaussian_kernel_1d(ksize, float(sigma)).tolist()
    pad = ksize // 2
    dt = x.dtype
    xf = x.float() if x.ndim == 3 else x.float()[..., None]  # [H, W, C]
    h, w = xf.shape[:2]
    xp = xf.index_select(0, _reflect_index(h, pad, x.device))
    acc = xp[0:h] * k[0]
    for t in range(1, ksize):
        acc = acc + xp[t:t + h] * k[t]
    xp = acc.index_select(1, _reflect_index(w, pad, x.device))
    out = xp[:, 0:w] * k[0]
    for t in range(1, ksize):
        out = out + xp[:, t:t + w] * k[t]
    return (out if x.ndim == 3 else out[..., 0]).to(dt)


def sharpen(x: torch.Tensor, factor: float) -> torch.Tensor:
    """[[0,-1,0],[-1,5+f,-1],[0,-1,0]] / (1+f) on [H, W, C], reflect-101
    border, clamped to [0, 1]. A kernel sum of 0 uses the raw kernel.
    Computes in float32 (the 3x center weight would amplify bf16 rounding)
    and returns x's dtype."""
    ksum = 1.0 + factor
    if ksum == 0.0:
        w_center, w_cross = 5.0 + factor, -1.0
    else:
        w_center, w_cross = (5.0 + factor) / ksum, -1.0 / ksum
    dt, x = x.dtype, x.float()
    # reflect-101: row -1 reads row 1, row H reads row H-2 (same for columns)
    up = torch.cat([x[1:2], x[:-1]], dim=0)
    down = torch.cat([x[1:], x[-2:-1]], dim=0)
    left = torch.cat([x[:, 1:2], x[:, :-1]], dim=1)
    right = torch.cat([x[:, 1:], x[:, -2:-1]], dim=1)
    out = w_center * x + w_cross * (up + down + left + right)
    return out.clamp(0.0, 1.0).to(dt)


def bilateral_smooth_depth(d: torch.Tensor, ksize: int = 9, sigma_color: float = 75.0,
                           sigma_space: float = 75.0) -> torch.Tensor:
    """Edge-preserving smoothing of an [H, W] depth in [0, 1] with
    ``cv2.bilateralFilter``'s weights: a circular window of radius
    ksize // 2 (taps with dy^2 + dx^2 > radius^2 are skipped), spatial
    weight exp(-r^2 / (2 sigma_space^2)), range weight exp(-dv^2 /
    (2 sigma_color^2)) with dv in u8 value scale, reflect-101 borders. The
    values are not rounded to u8 on the way."""
    radius = ksize // 2
    sc = max(float(sigma_color), 1.0)
    ss = max(float(sigma_space), 1.0)
    v = d * 255.0
    h, w = v.shape
    vp = v.index_select(0, _reflect_index(h, radius, d.device)).index_select(
        1, _reflect_index(w, radius, d.device))
    num = torch.zeros_like(v)
    den = torch.zeros_like(v)
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            r2 = dy * dy + dx * dx
            if r2 > radius * radius:
                continue
            sw = float(np.exp(-0.5 * r2 / (ss * ss)))
            tap = vp[radius + dy:radius + dy + h, radius + dx:radius + dx + w]
            # sw * exp(-0.5 * (diff * diff) / (sc * sc)), in place
            wgt = (tap - v).square_().mul_(-0.5).div_(sc * sc).exp_().mul_(sw)
            num += wgt * tap
            den += wgt
    return (num / den) / 255.0


def forward_diff_grad(d: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """d: [H, W] -> (dx, dy), dx[:, 0] = 0 and dy[0, :] = 0."""
    dx = F.pad(d[:, 1:] - d[:, :-1], (1, 0))
    dy = F.pad(d[1:, :] - d[:-1, :], (0, 0, 1, 0))
    return dx, dy


def grad_magnitude(d: torch.Tensor) -> torch.Tensor:
    """sqrt(dx^2 + dy^2) of the forward differences."""
    dx, dy = forward_diff_grad(d)
    return torch.sqrt(dx * dx + dy * dy)
