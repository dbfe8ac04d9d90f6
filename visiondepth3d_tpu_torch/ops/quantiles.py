"""Quantile / histogram / median primitives for depth statistics.

Counterpart of ``visiondepth3d_tpu/ops/quantiles.py``. Two modes:

- ``exact``: sort based, torch.quantile linear interpolation and the
  lower-middle masked median (``torch.median`` semantics);
- ``hist``: 12-step bisection of ``count(x <= mid) / n`` over [0, 1]. Sums
  of 0/1 predicates are exact in float32 below 2^24 elements, so every
  decision is independent of reduction order and the result is bit-identical
  to the JAX function. On a CUDA tensor the unmasked 2-D quantile pair runs
  the hand-written kernel of ``kernels/stats.py``, which reproduces the same
  decisions from one histogram pass.
"""

from __future__ import annotations

from typing import Literal, Sequence

import torch

QuantileMode = Literal["hist", "exact"]


def histogram_01(x: torch.Tensor, bins: int,
                 mask: torch.Tensor | None = None) -> torch.Tensor:
    """torch.histc bin semantics over [0, 1]: bin i covers [i/bins,
    (i+1)/bins), the last bin is closed. ``mask`` weights each element."""
    flat = x.reshape(-1)
    idx = torch.floor(flat * bins).to(torch.int64).clamp(0, bins - 1)
    w = (mask.reshape(-1).to(x.dtype) if mask is not None
         else torch.ones_like(flat))
    return torch.zeros(bins, dtype=x.dtype, device=x.device).index_add_(0, idx, w)


def bisect_quantile_01(x: torch.Tensor, q, mask: torch.Tensor | None = None,
                       iters: int = 12) -> torch.Tensor:
    """Quantile(s) of values in [0, 1] by bisection on the value axis.

    ``q``: a float, a sequence of floats or a tensor; the result has q's
    shape. Each step compares ``count(x <= mid) / count`` with q in float32.
    """
    q_in = torch.as_tensor(q, dtype=x.dtype, device=x.device)
    qv = q_in.reshape(-1)
    flat = x.reshape(-1)
    if mask is not None:
        m = mask.reshape(-1).to(x.dtype)
        count = torch.clamp(m.sum(), min=1.0)
    else:
        m = None
        count = float(flat.shape[0])
    lo = torch.zeros_like(qv)
    hi = torch.ones_like(qv)
    for _ in range(iters):
        mid = (lo + hi) * 0.5
        sums = []
        for i in range(qv.shape[0]):
            le = (flat <= mid[i]).to(x.dtype)
            if m is not None:
                le = le * m
            sums.append(le.sum())
        go_right = torch.stack(sums) / count < qv
        lo = torch.where(go_right, mid, lo)
        hi = torch.where(go_right, hi, mid)
    return ((lo + hi) * 0.5).reshape(q_in.shape)


def exact_quantile(x: torch.Tensor, q, mask: torch.Tensor | None = None) -> torch.Tensor:
    """torch.quantile linear interpolation; with a mask, the quantile of the
    valid subset (invalid elements sort to +inf)."""
    q = torch.as_tensor(q, dtype=x.dtype, device=x.device)
    flat = x.reshape(-1)
    if mask is None:
        return torch.quantile(flat, q)
    m = mask.reshape(-1)
    n = flat.shape[0]
    s, _ = torch.sort(torch.where(m, flat, torch.full_like(flat, float("inf"))))
    count = m.to(torch.int64).sum()
    pos = q * (count.to(q.dtype) - 1.0)
    lo = torch.floor(pos).to(torch.int64).clamp(0, n - 1)
    hi = torch.minimum(lo + 1, torch.clamp(count - 1, min=0))
    w = pos - lo.to(q.dtype)
    return s[lo] * (1.0 - w) + s[hi] * w


def quantile_01(x: torch.Tensor, q: Sequence[float] | float,
                mask: torch.Tensor | None = None,
                mode: QuantileMode = "hist") -> torch.Tensor:
    """Quantile of values known to lie in [0, 1]. Dispatch on mode."""
    if mode == "exact":
        return exact_quantile(x, q, mask)
    if mask is None and x.ndim == 2 and isinstance(q, (tuple, list)) and len(q) == 2:
        from ..kernels.stats import quantile_pair

        return quantile_pair(x, float(q[0]), float(q[1]))
    return bisect_quantile_01(x, q, mask)


def exact_masked_median(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """torch.median of the masked subset: sorted[(n - 1) // 2]."""
    flat = x.reshape(-1)
    m = mask.reshape(-1)
    s, _ = torch.sort(torch.where(m, flat, torch.full_like(flat, float("inf"))))
    count = m.to(torch.int64).sum()
    idx = torch.div(count - 1, 2, rounding_mode="floor").clamp(0, flat.shape[0] - 1)
    return s[idx]


def hist_masked_median(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Bisection form of the masked lower-middle median."""
    count = torch.clamp(mask.to(x.dtype).sum(), min=1.0)
    # lower-middle order statistic: 1-based rank floor((n-1)/2) + 1
    q = (torch.floor((count - 1.0) / 2.0) + 1.0) / count
    return bisect_quantile_01(x, q, mask)


def masked_median_01(x: torch.Tensor, mask: torch.Tensor,
                     mode: QuantileMode = "hist") -> torch.Tensor:
    if mode == "exact":
        return exact_masked_median(x, mask)
    return hist_masked_median(x, mask)
