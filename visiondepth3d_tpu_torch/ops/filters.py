"""Small stencil filters: box blur, sharpening, forward-difference gradients.

Counterpart of ``visiondepth3d_tpu/ops/filters.py``:
- ``box_blur``: k x k mean, stride 1, zero padding counted in the mean
  (``F.avg_pool2d(count_include_pad=True)`` semantics);
- ``sharpen``: the brightness-preserving 3x3 cross kernel with a
  reflect-101 border, clamped to [0, 1];
- ``forward_diff_grad``: left/top zero-padded forward differences.
"""

from __future__ import annotations

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


def forward_diff_grad(d: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """d: [H, W] -> (dx, dy), dx[:, 0] = 0 and dy[0, :] = 0."""
    dx = F.pad(d[:, 1:] - d[:, :-1], (1, 0))
    dy = F.pad(d[1:, :] - d[:-1, :], (0, 0, 1, 0))
    return dx, dy


def grad_magnitude(d: torch.Tensor) -> torch.Tensor:
    """sqrt(dx^2 + dy^2) of the forward differences."""
    dx, dy = forward_diff_grad(d)
    return torch.sqrt(dx * dx + dy * dy)
