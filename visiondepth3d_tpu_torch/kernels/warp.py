"""K1: the dual-eye DIBR warp (``csrc/warp.cu``) and its plain version.

``stereo_warp`` dispatches on the tensors' device: a CUDA tensor launches
the kernel, a CPU tensor runs ``stereo_warp_torch``. Both compute in float32
and return the image type.
"""

from __future__ import annotations

import torch

from ..ops import warp as warp_ops
from ._lib import check, launch_counts, lib, require_cuda, stream_of

_IMAGE_TYPES = (torch.float32, torch.bfloat16)


def stereo_warp_torch(frame: torch.Tensor, shaped_depth: torch.Tensor,
                      shift_norm: torch.Tensor, max_shift_px: int | None = None):
    """Plain version: ops/warp.py in float32 (shifted accumulation with a
    bound, gather without), cast back to the frame's type."""
    dt = frame.dtype
    outs = warp_ops.stereo_warp(frame.float(), shaped_depth.float(),
                                shift_norm.float(), max_shift_px)
    return tuple(o.to(dt) for o in outs)


def stereo_warp_cuda(frame: torch.Tensor, shaped_depth: torch.Tensor,
                     shift_norm: torch.Tensor, max_shift_px: int | None = None):
    """The kernel: frame [H, W, 3] and shaped_depth [H, W] in float32 or
    bfloat16, shift_norm [H, W] float32, all contiguous on one CUDA device.
    Returns (left, right, depth_left, depth_right) in the frame's type.
    The 2-tap gather needs no disparity bound: ``max_shift_px`` is unused."""
    require_cuda("stereo_warp_cuda", frame, shaped_depth, shift_norm)
    h, w = shift_norm.shape
    if frame.shape != (h, w, 3) or shaped_depth.shape != (h, w):
        raise ValueError(f"stereo_warp_cuda: shapes {tuple(frame.shape)}, "
                         f"{tuple(shaped_depth.shape)}, {tuple(shift_norm.shape)}")
    if frame.dtype not in _IMAGE_TYPES or shaped_depth.dtype != frame.dtype:
        raise TypeError(f"stereo_warp_cuda: image types {frame.dtype}, {shaped_depth.dtype}")
    if shift_norm.dtype != torch.float32:
        raise TypeError("stereo_warp_cuda: shift_norm must be float32")
    if h > 65535:
        raise ValueError("stereo_warp_cuda: more than 65535 rows")
    frame, shaped_depth, shift_norm = (t.contiguous() for t in (frame, shaped_depth, shift_norm))
    left, right = torch.empty_like(frame), torch.empty_like(frame)
    dleft, dright = torch.empty_like(shaped_depth), torch.empty_like(shaped_depth)
    rc = lib().vd3d_stereo_warp(
        frame.data_ptr(), shaped_depth.data_ptr(), shift_norm.data_ptr(),
        left.data_ptr(), right.data_ptr(), dleft.data_ptr(), dright.data_ptr(),
        h, w, int(frame.dtype == torch.bfloat16), stream_of(frame))
    check(rc, "stereo_warp_cuda")
    launch_counts["stereo_warp"] += 1
    return left, right, dleft, dright


def stereo_warp(frame: torch.Tensor, shaped_depth: torch.Tensor,
                shift_norm: torch.Tensor, max_shift_px: int | None = None):
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    if frame.device.type == "cuda":
        return stereo_warp_cuda(frame, shaped_depth, shift_norm, max_shift_px)
    if frame.device.type == "cpu":
        return stereo_warp_torch(frame, shaped_depth, shift_norm, max_shift_px)
    raise ValueError(f"stereo_warp: unsupported device {frame.device}")
