"""Color grading: saturation / contrast / brightness.

Counterpart of ``visiondepth3d_tpu/ops/grade.py``: Rec.709 luma, chroma
lerp for saturation, contrast about 0.5, additive brightness, clamp.
"""

from __future__ import annotations

import torch

REC709 = (0.2126, 0.7152, 0.0722)


def apply_color_grade(rgb: torch.Tensor, saturation: float = 1.0,
                      contrast: float = 1.0, brightness: float = 0.0) -> torch.Tensor:
    """rgb: [..., 3] float in [0, 1]. Computes in float32, returns rgb's
    dtype (one rounding for a bf16 image plane)."""
    dt, rgb = rgb.dtype, rgb.float()
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    luma = (REC709[0] * r + REC709[1] * g + REC709[2] * b)[..., None]
    rgb_sat = luma + (rgb - luma) * saturation
    rgb_con = 0.5 + (rgb_sat - 0.5) * contrast
    return torch.clamp(rgb_con + brightness, 0.0, 1.0).to(dt)
