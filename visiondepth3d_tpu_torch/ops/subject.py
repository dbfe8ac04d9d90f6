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

The two float means are taken as a vector of row sums followed by one sum
of it, so a frame held as row bands (``stereo/bands.py``) reproduces them
by concatenating the bands' row sums; the ``*_bands`` forms take a frame
as row bands and return the whole frame's statistic on the lead device.
"""

from __future__ import annotations

import torch

from .quantiles import QuantileMode, histogram_01, masked_median_01

SUBJECT_HIST_BINS = 64


def subject_crop(h: int, w: int) -> tuple[int, int, int, int]:
    """The 60 % center crop's rows [r0, r1) and columns [c0, c1)."""
    return h // 5, h * 4 // 5, w // 5, w * 4 // 5


def parallax_crop(h: int, w: int) -> tuple[int, int, int, int]:
    """The 50 % center crop's rows [r0, r1) and columns [c0, c1)."""
    return h // 4, h * 3 // 4, w // 4, w * 3 // 4


def band_share(bands: list[torch.Tensor], row0s, rows: tuple[int, int],
               cols: tuple[int, int]) -> list[torch.Tensor]:
    """Each band's part of a crop (``rows``, ``cols`` in frame coordinates);
    band b holds frame rows row0s[b] onward. A band outside the crop's rows
    gives an empty view."""
    out = []
    for x, r0 in zip(bands, row0s):
        a = min(max(rows[0] - r0, 0), x.shape[0])
        b = max(min(rows[1] - r0, x.shape[0]), a)
        out.append(x[a:b, cols[0]:cols[1]])
    return out


def subject_from_stats(hist: torch.Tensor, count: torch.Tensor, median: torch.Tensor,
                       dtype: torch.dtype) -> torch.Tensor:
    """The subject depth from the crop's 64-bin histogram, valid count and
    masked median."""
    peak_bin = torch.argmax(hist)
    subject = (peak_bin.to(dtype) + 0.5) / SUBJECT_HIST_BINS
    smoothed = torch.clamp(0.7 * subject + 0.3 * median, 0.0, 1.0)
    return torch.where(count < 20, 0.5, smoothed)


def estimate_subject_depth(depth: torch.Tensor,
                           quantile_mode: QuantileMode = "hist") -> torch.Tensor:
    """Histogram-peak subject depth of a [H, W] map in [0, 1] -> scalar."""
    r0, r1, c0, c1 = subject_crop(depth.shape[-2], depth.shape[-1])
    crop = depth[..., r0:r1, c0:c1]
    if quantile_mode == "exact":
        valid = (crop > 0.05) & (crop < 0.95)
        count = valid.sum()
        hist = histogram_01(crop, SUBJECT_HIST_BINS, valid)
        median = masked_median_01(crop, valid, mode="exact")
    else:
        from ..kernels.stats import subject_stats

        hist, count, median = subject_stats(crop)
    return subject_from_stats(hist, count, median, depth.dtype)


def estimate_subject_depth_bands(bands: list[torch.Tensor], row0s, height: int,
                                 lead: torch.device,
                                 quantile_mode: QuantileMode = "hist") -> torch.Tensor:
    """estimate_subject_depth of the [height, W] frame held as row bands
    (band b's first row is frame row row0s[b]), on ``lead``. In hist mode
    each band counts its share of the crop (K4's band form), the counts
    are summed on ``lead`` and finished there: the result is the whole
    frame's bit for bit. Exact mode gathers the crop on ``lead``."""
    from ..parallel.halo import lead_cat, lead_sum

    r0, r1, c0, c1 = subject_crop(height, bands[0].shape[-1])
    shares = band_share(bands, row0s, (r0, r1), (c0, c1))
    if quantile_mode == "exact":
        crop = lead_cat(shares, lead)
        valid = (crop > 0.05) & (crop < 0.95)
        return subject_from_stats(histogram_01(crop, SUBJECT_HIST_BINS, valid), valid.sum(),
                                  masked_median_01(crop, valid, mode="exact"), crop.dtype)
    from ..kernels.stats import subject_hist_band, subject_stats_finish

    bufs: dict = {}
    for x in shares:
        bufs[x.device] = subject_hist_band(x, bufs.get(x.device))
    hist, count, median = subject_stats_finish(lead_sum(list(bufs.values()), lead))
    return subject_from_stats(hist, count, median, bands[0].dtype)


def parallax_from_moments(mean: torch.Tensor, var: torch.Tensor, min_scale: float,
                          max_scale: float) -> torch.Tensor:
    norm_var = torch.clamp(var / (mean + 1e-5), 0.0, 1.0)
    return min_scale + norm_var * (max_scale - min_scale)


def dynamic_parallax_scale(depth: torch.Tensor, min_scale: float = 0.90,
                           max_scale: float = 1.15) -> torch.Tensor:
    """Variance-adaptive parallax scale over the 50 % center crop."""
    r0, r1, c0, c1 = parallax_crop(depth.shape[-2], depth.shape[-1])
    crop = depth[..., r0:r1, c0:c1]
    n = crop.numel()
    mean = crop.sum(dim=-1).sum() / n
    var = ((crop - mean) ** 2).sum(dim=-1).sum() / max(n - 1, 1)
    return parallax_from_moments(mean, var, min_scale, max_scale)


def dynamic_parallax_scale_bands(bands: list[torch.Tensor], row0s, height: int,
                                 lead: torch.device, min_scale: float = 0.90,
                                 max_scale: float = 1.15) -> torch.Tensor:
    """dynamic_parallax_scale of the frame held as row bands, on ``lead``:
    the bands' row sums are concatenated in order and summed there, the
    sums the one-device form takes."""
    from ..parallel.halo import lead_cat

    r0, r1, c0, c1 = parallax_crop(height, bands[0].shape[-1])
    shares = band_share(bands, row0s, (r0, r1), (c0, c1))
    n = (r1 - r0) * (c1 - c0)
    mean = lead_cat([x.sum(dim=-1) for x in shares], lead).sum() / n
    means = {d: mean.to(d, non_blocking=True) for d in dict.fromkeys(x.device for x in shares)}
    var = lead_cat([((x - means[x.device]) ** 2).sum(dim=-1) for x in shares],
                   lead).sum() / max(n - 1, 1)
    return parallax_from_moments(mean, var, min_scale, max_scale)


def motion_metric(prev_depth: torch.Tensor, curr_depth: torch.Tensor) -> torch.Tensor:
    """Scene-motion scalar in [0, 1]."""
    diff = torch.abs(curr_depth - prev_depth)
    mad = diff.sum(dim=-1).sum() / diff.numel()
    return torch.clamp(mad * 4.0, 0.0, 1.0)


def motion_metric_bands(prev: list[torch.Tensor], curr: list[torch.Tensor],
                        lead: torch.device) -> torch.Tensor:
    """motion_metric of two frames held as the same row bands, on ``lead``."""
    from ..parallel.halo import lead_cat

    rows = [torch.abs(c - p).sum(dim=-1) for p, c in zip(prev, curr)]
    n = sum(c.numel() for c in curr)
    return torch.clamp(lead_cat(rows, lead).sum() / n * 4.0, 0.0, 1.0)
