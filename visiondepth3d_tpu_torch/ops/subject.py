"""Scene statistics: subject depth, dynamic parallax scale, motion metric.

Counterpart of ``visiondepth3d_tpu/ops/subject.py``:
- ``estimate_subject_depth``: 60 % center crop, valid band 0.05 < d < 0.95,
  the 64-bin histogram peak blended 70/30 with the masked median; fewer
  than 20 valid pixels give 0.5. In hist mode the three statistics come
  from ``kernels/stats.py:subject_stats`` (the hand-written kernel on a
  CUDA tensor).
- ``dynamic_parallax_scale``: normalized center-crop variance (ddof=1)
  mapped to [min_scale, max_scale].
- ``motion_metric``: clamp(mean |curr - prev| * 4, 0, 1).
"""

from __future__ import annotations

import torch

from .quantiles import QuantileMode, histogram_01, masked_median_01

SUBJECT_HIST_BINS = 64


def estimate_subject_depth(depth: torch.Tensor,
                           quantile_mode: QuantileMode = "hist") -> torch.Tensor:
    """Histogram-peak subject depth of a [H, W] map in [0, 1] -> scalar."""
    h, w = depth.shape[-2], depth.shape[-1]
    crop = depth[..., h // 5: h * 4 // 5, w // 5: w * 4 // 5]
    if quantile_mode == "exact":
        valid = (crop > 0.05) & (crop < 0.95)
        count = valid.sum()
        hist = histogram_01(crop, SUBJECT_HIST_BINS, valid)
        median = masked_median_01(crop, valid, mode="exact")
    else:
        from ..kernels.stats import subject_stats

        hist, count, median = subject_stats(crop)
    peak_bin = torch.argmax(hist)
    subject = (peak_bin.to(depth.dtype) + 0.5) / SUBJECT_HIST_BINS
    smoothed = torch.clamp(0.7 * subject + 0.3 * median, 0.0, 1.0)
    return torch.where(count < 20, 0.5, smoothed)


def dynamic_parallax_scale(depth: torch.Tensor, min_scale: float = 0.90,
                           max_scale: float = 1.15) -> torch.Tensor:
    """Variance-adaptive parallax scale over the 50 % center crop."""
    h, w = depth.shape[-2], depth.shape[-1]
    crop = depth[..., h // 4: h * 3 // 4, w // 4: w * 3 // 4]
    mean = crop.mean()
    n = crop.numel()
    var = ((crop - mean) ** 2).sum() / max(n - 1, 1)
    norm_var = torch.clamp(var / (mean + 1e-5), 0.0, 1.0)
    return min_scale + norm_var * (max_scale - min_scale)


def motion_metric(prev_depth: torch.Tensor, curr_depth: torch.Tensor) -> torch.Tensor:
    """Scene-motion scalar in [0, 1]."""
    mad = torch.abs(curr_depth - prev_depth).mean()
    return torch.clamp(mad * 4.0, 0.0, 1.0)
