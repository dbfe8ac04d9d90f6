"""3D output packing (side-by-side) and the floating-window side masks.

Counterpart of ``visiondepth3d_tpu/ops/formats.py`` for the formats the
port renders: Full-SBS and Half-SBS. VR, anaglyph and interlaced are not
ported yet and raise.
"""

from __future__ import annotations

import torch

from .resize import pad_to_aspect, resize_area

FORMATS = ("Half-SBS", "Full-SBS")


def _check_format(fmt: str):
    if fmt not in FORMATS:
        raise NotImplementedError(
            f"output format {fmt!r} is not ported yet; use one of {FORMATS}")


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


def format_3d_output(left: torch.Tensor, right: torch.Tensor, fmt: str) -> torch.Tensor:
    """Pack per-eye frames [..., H, W, 3] side by side."""
    _check_format(fmt)
    return torch.cat([left, right], dim=-2)


def pack_per_eye(left: torch.Tensor, right: torch.Tensor, fmt: str,
                 per_eye_w: int, per_eye_h: int):
    """Per-eye geometry before packing: Half-SBS area-resizes each eye,
    Full-SBS letterboxes. left/right: [H, W, 3]."""
    _check_format(fmt)
    if fmt == "Half-SBS":
        return (resize_area(left, (per_eye_h, per_eye_w)),
                resize_area(right, (per_eye_h, per_eye_w)))
    return (pad_to_aspect(left, per_eye_w, per_eye_h),
            pad_to_aspect(right, per_eye_w, per_eye_h))
