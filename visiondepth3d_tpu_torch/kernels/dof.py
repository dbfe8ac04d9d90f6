"""K6: the fused depth of field + color grade pass (``csrc/dof.cu``) and its
plain version.

``dof_grade`` dispatches on the tensors' device: a CUDA tensor launches the
kernel, a CPU tensor runs ``dof_grade_torch``. Both compute in float32 and
round once to the image type: ``ops/dof.apply_dof`` followed by
``ops/grade.apply_color_grade`` for each eye. The kernel covers the whole
preset range of ``dof_strength`` (<= 5, a blur reach of 10 pixels) at any
frame size; a larger reach raises.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..ops import dof as dof_ops
from ..ops import grade
from ..ops.filters import _gaussian_kernel_1d
from ._lib import launch, require_cuda

MAX_REACH = 10  # csrc/dof.cu: the shared-memory halo
MAX_LEVELS = 8
_MAX_TAPS = 2 * MAX_REACH + 1


def dof_reach(max_sigma: float, num_levels: int) -> int:
    """The largest blur half-width in the LOD stack."""
    sig = max(dof_ops.level_sigmas(max_sigma, num_levels))
    return int(math.ceil(2 * sig)) if sig > 0 else 0


def dof_grade_torch(left, right, depth, focal_depth, max_sigma: float,
                    focus_width: float = 0.35, num_levels: int = 5, saturation: float = 1.0,
                    contrast: float = 1.0, brightness: float = 0.0, apply_grade: bool = True):
    """Plain version: apply_dof then apply_color_grade per eye, in float32."""
    outs = []
    for eye in (left, right):
        out = dof_ops.apply_dof(eye.float(), depth, focal_depth, max_sigma, focus_width,
                                num_levels)
        if apply_grade:
            out = grade.apply_color_grade(out, saturation, contrast, brightness)
        outs.append(out.to(eye.dtype))
    return tuple(outs)


def _taps(max_sigma: float, num_levels: int) -> tuple[np.ndarray, np.ndarray]:
    """The kernel's level table: taps [n, 2 * MAX_REACH + 1] float32 and
    half-widths [n] int32 (0 for the unblurred level)."""
    taps = np.zeros((num_levels, _MAX_TAPS), np.float32)
    halves = np.zeros(num_levels, np.int32)
    for i, sigma in enumerate(dof_ops.level_sigmas(max_sigma, num_levels)):
        if sigma == 0.0:
            taps[i, 0] = 1.0
            continue
        k = _gaussian_kernel_1d(dof_ops.level_ksize(sigma), sigma)
        taps[i, :k.size] = k
        halves[i] = k.size // 2
    return taps, halves


def dof_grade_cuda(left, right, depth, focal_depth, max_sigma: float,
                   focus_width: float = 0.35, num_levels: int = 5, saturation: float = 1.0,
                   contrast: float = 1.0, brightness: float = 0.0, apply_grade: bool = True):
    """The kernel: left/right [H, W, 3] float32 or bfloat16, depth [H, W]
    float32, focal_depth a float32 0-d tensor on the same CUDA device (read
    by the kernel, never on the host) or a Python float."""
    if not 2 <= num_levels <= MAX_LEVELS:
        raise ValueError(f"dof_grade_cuda: num_levels {num_levels} not in [2, {MAX_LEVELS}]")
    reach = dof_reach(max_sigma, num_levels)
    if reach > MAX_REACH:
        raise ValueError(f"dof_grade_cuda: blur reach {reach} (max_sigma {max_sigma}) exceeds "
                         f"{MAX_REACH}")
    if not torch.is_tensor(focal_depth):
        focal_depth = torch.tensor(float(focal_depth), device=left.device)
    focal_depth = focal_depth.reshape(()).float()
    require_cuda("dof_grade_cuda", left, right, depth, focal_depth)
    h, w = depth.shape
    if left.shape != (h, w, 3) or right.shape != (h, w, 3):
        raise ValueError(f"dof_grade_cuda: expected [H, W, 3] eyes and an [H, W] depth, got "
                         f"{tuple(left.shape)} {tuple(right.shape)} {tuple(depth.shape)}")
    if left.dtype not in (torch.float32, torch.bfloat16) or right.dtype != left.dtype:
        raise TypeError("dof_grade_cuda: both eyes must share float32 or bfloat16")
    taps, halves = _taps(max_sigma, num_levels)
    left, right = left.contiguous(), right.contiguous()
    depth = depth.float().contiguous()
    out_l, out_r = torch.empty_like(left), torch.empty_like(right)
    launch("dof_grade", left, "vd3d_dof_grade",
           left.data_ptr(), right.data_ptr(), depth.data_ptr(), focal_depth.data_ptr(),
           out_l.data_ptr(), out_r.data_ptr(), h, w, taps.ctypes.data, halves.ctypes.data,
           num_levels, float(focus_width + 1e-6), float(num_levels - 1 - 1e-6),
           float(saturation), float(contrast), float(brightness), int(apply_grade),
           int(left.dtype == torch.bfloat16))
    return out_l, out_r


def dof_grade(left, right, depth, focal_depth, max_sigma: float, **kw):
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    if left.device.type == "cuda":
        return dof_grade_cuda(left, right, depth, focal_depth, max_sigma, **kw)
    if left.device.type == "cpu":
        return dof_grade_torch(left, right, depth, focal_depth, max_sigma, **kw)
    raise ValueError(f"dof_grade: unsupported device {left.device}")
