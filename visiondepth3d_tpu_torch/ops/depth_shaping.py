"""Pop-Control depth shaping.

Counterpart of ``visiondepth3d_tpu/ops/depth_shaping.py``: percentile
stretch, recenter on the subject, symmetric signed-power contrast about the
mid plane; the additive curvature dome; and the plain gamma
``midtone_shape``.
"""

from __future__ import annotations

import torch

from .quantiles import QuantileMode, quantile_01


def signed_pow(x: torch.Tensor, gamma: float) -> torch.Tensor:
    """sign(x) * |x| ** gamma."""
    return torch.sign(x) * torch.abs(x) ** gamma


def shape_depth_for_pop(depth01: torch.Tensor, subject_depth: torch.Tensor, *,
                        stretch_lo: float = 0.05, stretch_hi: float = 0.95,
                        depth_mid: float = 0.50, gamma: float = 0.85,
                        quantile_mode: QuantileMode = "hist") -> torch.Tensor:
    """Stretch-recenter-curve shaping. A degenerate stretch range
    (hi - lo < 1e-5) leaves the values unstretched."""
    d = torch.clamp(depth01, 0.0, 1.0)
    q = quantile_01(d, (stretch_lo, stretch_hi), mode=quantile_mode)
    return shape_depth_apply(d, q[0], q[1], subject_depth, depth_mid=depth_mid, gamma=gamma)


def shape_depth_apply(d: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                      subject_depth: torch.Tensor, *, depth_mid: float = 0.50,
                      gamma: float = 0.85) -> torch.Tensor:
    """The pointwise part of ``shape_depth_for_pop``: d (clamped to [0, 1])
    stretched by the frame's quantiles lo, hi, recentered on the subject
    and curved."""
    degenerate = (hi - lo) < 1e-5
    d_stretched = torch.where(
        degenerate, d, torch.clamp((d - lo) / (hi - lo + 1e-6), 0.0, 1.0))
    subj = torch.clamp(subject_depth, 0.0, 1.0)
    subj_stretched = torch.where(
        degenerate, subj, torch.clamp((subj - lo) / (hi - lo + 1e-6), 0.0, 1.0))
    centered = d_stretched - subj_stretched + depth_mid
    shaped = signed_pow(centered - depth_mid, gamma) + depth_mid
    return torch.clamp(shaped, 0.0, 1.0)


def enhance_curvature(depth: torch.Tensor, strength: float = 0.08, row0: int = 0,
                      height: int | None = None) -> torch.Tensor:
    """Add the centered dome 1 - (x^2 + y^2) * strength (not clamped). A
    row band of a taller frame passes its first row ``row0`` and the
    frame's ``height``: it takes its slice of the frame's ramp."""
    h, w = depth.shape[-2], depth.shape[-1]
    height = h if height is None else height
    yy = torch.linspace(-1.0, 1.0, height, dtype=depth.dtype,
                        device=depth.device)[row0:row0 + h, None]
    xx = torch.linspace(-1.0, 1.0, w, dtype=depth.dtype, device=depth.device)[None, :]
    curvature = 1.0 - (xx * xx + yy * yy)
    return depth + curvature * strength


def midtone_shape(depth01: torch.Tensor, gamma: float = 0.85) -> torch.Tensor:
    """The power curve clamp(d, 0, 1) ** gamma."""
    return torch.clamp(depth01, 0.0, 1.0) ** gamma
