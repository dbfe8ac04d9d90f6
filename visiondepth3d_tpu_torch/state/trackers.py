"""Cross-frame EMA trackers.

Counterpart of ``visiondepth3d_tpu/state/trackers.py``: the seven pieces of
cross-frame state of the stereo stage, as one dataclass of device tensors.
Each update returns a new ``StereoTrackers`` and its output. Every
conditional update is a ``torch.where`` on device tensors, so the per-frame
loop never waits for the device.

- temporal depth filter (alpha 0.5): the first frame passes through;
- percentile EMA (0.02 / 0.98, alpha 0.92): a degenerate range
  (hi - lo < 1e-5) returns the input and leaves the EMA untouched;
- convergence EMA (alpha 0.97);
- shift smoother (alpha 0.15, blends toward the new value);
- floating window (alpha 0.97, deadband 0.0015; clamps to [-1, 1] every
  100 updates);
- bar easer (alpha 0.85, truncated each step);
- focal tracker (deadband 0.03, max step 0.02, alpha 0.10 + 0.20 * motion).
"""

from __future__ import annotations

import dataclasses

import torch

from ..device import DEFAULT_DEVICE
from ..ops.quantiles import QuantileMode, quantile_01


@dataclasses.dataclass
class StereoTrackers:
    """prev_depth / prev_norm_depth are [H, W]; the rest are 0-d tensors
    (float32, bool, and int32 for fw_counter)."""

    initialized: torch.Tensor
    prev_depth: torch.Tensor
    prev_norm_depth: torch.Tensor
    norm_lo: torch.Tensor
    norm_hi: torch.Tensor
    norm_init: torch.Tensor
    conv_val: torch.Tensor
    conv_init: torch.Tensor
    fg: torch.Tensor
    mg: torch.Tensor
    bg: torch.Tensor
    shift_init: torch.Tensor
    fw_offset: torch.Tensor
    fw_counter: torch.Tensor
    bar_width: torch.Tensor
    focal: torch.Tensor
    focal_init: torch.Tensor

    def replace(self, **kw) -> "StereoTrackers":
        return dataclasses.replace(self, **kw)


def init_trackers(height: int, width: int, dtype=torch.float32,
                  device=DEFAULT_DEVICE) -> StereoTrackers:
    def z():
        return torch.zeros((), dtype=dtype, device=device)

    def f():
        return torch.zeros((), dtype=torch.bool, device=device)

    return StereoTrackers(
        initialized=f(),
        prev_depth=torch.zeros((height, width), dtype=dtype, device=device),
        prev_norm_depth=torch.zeros((height, width), dtype=dtype, device=device),
        norm_lo=z(), norm_hi=z(), norm_init=f(),
        conv_val=z(), conv_init=f(),
        fg=z(), mg=z(), bg=z(), shift_init=f(),
        fw_offset=z(), fw_counter=torch.zeros((), dtype=torch.int32, device=device),
        bar_width=z(),
        focal=z(), focal_init=f(),
    )


def _true(like: torch.Tensor) -> torch.Tensor:
    return torch.ones((), dtype=torch.bool, device=like.device)


def smooth_plane(initialized: torch.Tensor, prev_depth: torch.Tensor, depth: torch.Tensor,
                 alpha: float = 0.5) -> torch.Tensor:
    """The temporal filter on a plane (a whole frame or a row band of it)."""
    prev = torch.where(initialized, prev_depth, depth)
    return alpha * prev + (1.0 - alpha) * depth


def temporal_depth_smooth(trackers: StereoTrackers, depth: torch.Tensor, alpha: float = 0.5):
    smoothed = smooth_plane(trackers.initialized, trackers.prev_depth, depth, alpha)
    return trackers.replace(prev_depth=smoothed), smoothed


def percentile_ema_normalize(trackers: StereoTrackers, depth01: torch.Tensor,
                             p_lo: float = 0.02, p_hi: float = 0.98,
                             alpha: float = 0.92,
                             quantile_mode: QuantileMode = "hist"):
    d = torch.clamp(depth01, 0.0, 1.0)
    q = quantile_01(d, (p_lo, p_hi), mode=quantile_mode)
    trackers, new_lo, new_hi, degenerate = percentile_ema_update(trackers, q[0], q[1], alpha)
    return trackers, percentile_ema_apply(d, new_lo, new_hi, degenerate)


def percentile_ema_update(t: StereoTrackers, lo: torch.Tensor, hi: torch.Tensor,
                          alpha: float = 0.92):
    """The EMA of the frame's quantiles lo, hi. Returns (trackers, new_lo,
    new_hi, degenerate)."""
    degenerate = (hi - lo) < 1e-5
    new_lo = torch.where(t.norm_init, alpha * t.norm_lo + (1 - alpha) * lo, lo)
    new_hi = torch.where(t.norm_init, alpha * t.norm_hi + (1 - alpha) * hi, hi)
    new_lo = torch.where(degenerate, t.norm_lo, new_lo)
    new_hi = torch.where(degenerate, t.norm_hi, new_hi)
    new_init = torch.where(degenerate, t.norm_init, _true(lo))
    return (t.replace(norm_lo=new_lo, norm_hi=new_hi, norm_init=new_init), new_lo, new_hi,
            degenerate)


def percentile_ema_apply(d: torch.Tensor, new_lo: torch.Tensor, new_hi: torch.Tensor,
                         degenerate: torch.Tensor) -> torch.Tensor:
    """The normalization of d (clamped to [0, 1]; a frame or a row band)."""
    return torch.where(degenerate, d,
                       torch.clamp((d - new_lo) / (new_hi - new_lo + 1e-6), 0.0, 1.0))


def convergence_ema_update(trackers: StereoTrackers, x: torch.Tensor, alpha: float = 0.97):
    val = torch.where(trackers.conv_init, alpha * trackers.conv_val + (1 - alpha) * x, x)
    return trackers.replace(conv_val=val, conv_init=_true(x)), val


def shift_smoother_update(trackers: StereoTrackers, fg: float, mg: float, bg: float,
                          alpha: float = 0.15):
    """Blends toward the new value with weight alpha."""
    fg, mg, bg = (torch.full((), v, dtype=trackers.fg.dtype, device=trackers.fg.device)
                  for v in (fg, mg, bg))
    nfg = torch.where(trackers.shift_init, alpha * fg + (1 - alpha) * trackers.fg, fg)
    nmg = torch.where(trackers.shift_init, alpha * mg + (1 - alpha) * trackers.mg, mg)
    nbg = torch.where(trackers.shift_init, alpha * bg + (1 - alpha) * trackers.bg, bg)
    return (trackers.replace(fg=nfg, mg=nmg, bg=nbg, shift_init=_true(trackers.fg)),
            (nfg, nmg, nbg))


def floating_window_update(trackers: StereoTrackers, current_offset: torch.Tensor,
                           alpha: float = 0.97, threshold: float = 0.0015):
    prev = trackers.fw_offset
    small = torch.abs(current_offset - prev) < threshold
    updated = alpha * prev + (1 - alpha) * current_offset
    counter = trackers.fw_counter + 1
    clamp_now = counter >= 100
    updated = torch.where(clamp_now, torch.clamp(updated, -1.0, 1.0), updated)
    counter = torch.where(clamp_now, torch.zeros_like(counter), counter)
    new_offset = torch.where(small, prev, updated)
    new_counter = torch.where(small, trackers.fw_counter, counter)
    return trackers.replace(fw_offset=new_offset, fw_counter=new_counter), new_offset


def bar_easer_update(trackers: StereoTrackers, current_width: torch.Tensor, alpha: float = 0.85):
    eased = torch.floor(alpha * trackers.bar_width + (1 - alpha) * current_width)
    return trackers.replace(bar_width=eased), eased


def focal_tracker_update(trackers: StereoTrackers, candidate: torch.Tensor,
                         motion: torch.Tensor, deadband: float = 0.03,
                         max_step: float = 0.02):
    alpha = 0.10 + 0.20 * torch.clamp(motion, 0.0, 1.0)
    focal = trackers.focal
    c = torch.where(torch.abs(candidate - focal) < deadband, focal, candidate)
    new_focal = (1.0 - alpha) * focal + alpha * c
    step = torch.clamp(new_focal - focal, -max_step, max_step)
    new_focal = torch.clamp(focal + step, 0.0, 1.0)
    out = torch.where(trackers.focal_init, new_focal, candidate)
    return trackers.replace(focal=out, focal_init=_true(out)), out
