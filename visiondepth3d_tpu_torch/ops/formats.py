"""3D output packing: SBS / VR / anaglyph / interlaced, and the
floating-window side masks.

Counterpart of ``visiondepth3d_tpu/ops/formats.py``. Every packer works on
channel-last float RGB in [0, 1]. A format name outside ``FORMATS`` packs
as the JAX package packs it: letterboxed eyes side by side (the Full-SBS
layout).

Anaglyph: the reference applies the Dubois rows to BGR frames as if they
were RGB; ``bgr_convention=True`` reproduces that red/blue swap, the
default is the published RGB transform. The three-term sums are computed
in float32 and rounded once to the image type.
"""

from __future__ import annotations

import torch

from .resize import pad_to_aspect, resize_area, resize_bilinear

FORMATS = ("Half-SBS", "Full-SBS", "VR", "Red-Cyan Anaglyph", "Passive Interlaced")

# Dubois-style red-cyan rows of the reference (render_3d.py:873-875)
_DUBOIS_LEFT_RED = (0.4561, 0.5005, 0.1762)
_DUBOIS_RIGHT_GREEN = (0.3764, 0.7616, -0.1876)
_DUBOIS_RIGHT_BLUE = (-0.0401, -0.1126, 1.2723)


def _row(rgb: torch.Tensor, w) -> torch.Tensor:
    return w[0] * rgb[..., 0] + w[1] * rgb[..., 1] + w[2] * rgb[..., 2]


def anaglyph_red_cyan(left: torch.Tensor, right: torch.Tensor,
                      bgr_convention: bool = False) -> torch.Tensor:
    """Dubois red-cyan anaglyph of [H, W, 3] RGB eyes in [0, 1]."""
    dt = left.dtype
    left, right = left.float(), right.float()
    if bgr_convention:
        left, right = left.flip(-1), right.flip(-1)
    out = torch.stack([_row(left, _DUBOIS_LEFT_RED), _row(right, _DUBOIS_RIGHT_GREEN),
                       _row(right, _DUBOIS_RIGHT_BLUE)], dim=-1).clamp(0.0, 1.0)
    if bgr_convention:
        out = out.flip(-1)
    return out.to(dt)


def interlaced(left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    """Passive interlaced: even rows from the left eye, odd rows from the right."""
    sel = (torch.arange(left.shape[0], device=left.device) % 2)[:, None, None].to(left.dtype)
    return left * (1.0 - sel) + right * sel


def apply_side_mask(img: torch.Tensor, bar_width: torch.Tensor,
                    side_sign: torch.Tensor) -> torch.Tensor:
    """Black out ``bar_width`` columns on one edge of img [H, W, C]:
    side_sign +1 the right edge, -1 the left edge, 0 none. Column
    positions stay float32 (bf16 cannot resolve columns past 256)."""
    w = img.shape[1]
    cols = torch.arange(w, dtype=torch.float32, device=img.device)[None, :, None]
    left_keep = cols >= bar_width
    right_keep = cols < (w - bar_width)
    keep = torch.where(side_sign < 0, left_keep,
                       torch.where(side_sign > 0, right_keep, True))
    return img * keep.to(img.dtype)


def format_3d_output(left: torch.Tensor, right: torch.Tensor, fmt: str, *,
                     vr_eye_hw: tuple[int, int] = (1600, 1440),
                     anaglyph_bgr_convention: bool = False) -> torch.Tensor:
    """Pack per-eye frames [H, W, 3] into the output frame."""
    if fmt == "VR":
        return torch.cat([resize_bilinear(left, vr_eye_hw), resize_bilinear(right, vr_eye_hw)],
                         dim=1)
    if fmt == "Red-Cyan Anaglyph":
        return anaglyph_red_cyan(left, right, anaglyph_bgr_convention)
    if fmt == "Passive Interlaced":
        return interlaced(left, right)
    return torch.cat([left, right], dim=1)


def pack_per_eye(left: torch.Tensor, right: torch.Tensor, fmt: str,
                 per_eye_w: int, per_eye_h: int):
    """Per-eye geometry before packing: Half-SBS area-resizes each eye,
    every other format letterboxes. left/right: [H, W, 3]."""
    if fmt == "Half-SBS":
        return (resize_area(left, (per_eye_h, per_eye_w)),
                resize_area(right, (per_eye_h, per_eye_w)))
    return (pad_to_aspect(left, per_eye_w, per_eye_h),
            pad_to_aspect(right, per_eye_w, per_eye_h))
