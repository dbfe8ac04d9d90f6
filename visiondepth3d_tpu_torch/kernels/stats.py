"""K3 and K4: the depth-statistics kernels (``csrc/stats.cu``) and their
plain versions.

``quantile_pair`` and ``subject_stats`` dispatch on the tensor's device: a
CUDA tensor launches the kernel, a CPU tensor runs the plain version. The
two agree bit for bit: both take the bisection's decisions on exact counts.
Results stay on the device.

K3's kernel keeps its global histogram and ticket in a scratch tensor of
the call, which the kernel zeroes itself before a grid barrier: no memset
and no state between calls, so calls may overlap on several streams and be
captured into a CUDA graph at any time.
"""

from __future__ import annotations

import torch

from ..ops.quantiles import bisect_quantile_01, hist_masked_median, histogram_01
from ._lib import launch, lib, require_cuda

QHIST_BINS = 4097  # 4096 right-closed bins + one above 1
SUBJECT_BINS = 64
MAX_ITEMS = 2**31 - 2**13  # the kernels' int32 item indices, 4 x 1024 of them ahead


def quantile_pair_torch(x: torch.Tensor, q0: float, q1: float) -> torch.Tensor:
    """Plain version: 12-step bisection quantiles of a 2-D map. -> [2]."""
    return bisect_quantile_01(x, (q0, q1))


def quantile_pair_cuda(x: torch.Tensor, q0: float, q1: float) -> torch.Tensor:
    """The kernel: x [H, W] float32 on a CUDA device (rows may be strided,
    columns contiguous). One launch, one device operation. -> [2] float32
    on the device."""
    require_cuda("quantile_pair_cuda", x)
    rows, cols, ld = _matrix_view("quantile_pair_cuda", x)
    scratch = torch.empty(QHIST_BINS + 1, dtype=torch.int32, device=x.device)
    out = torch.empty(2, dtype=torch.float32, device=x.device)
    launch("quantile_pair", x, "vd3d_quantile_pair", x.data_ptr(), rows, cols, ld,
           float(q0), float(q1), scratch.data_ptr(), out.data_ptr())
    return out


def quantile_pair(x: torch.Tensor, q0: float, q1: float) -> torch.Tensor:
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    if x.device.type == "cuda":
        return quantile_pair_cuda(x, q0, q1)
    if x.device.type == "cpu":
        return quantile_pair_torch(x, q0, q1)
    raise ValueError(f"quantile_pair: unsupported device {x.device}")


def subject_stats_torch(crop: torch.Tensor):
    """Plain version over the valid band 0.05 < d < 0.95 of a 2-D crop:
    (64-bin histogram [64], valid count, masked lower-middle median)."""
    valid = (crop > 0.05) & (crop < 0.95)
    hist = histogram_01(crop, SUBJECT_BINS, valid)
    return hist, valid.to(crop.dtype).sum(), hist_masked_median(crop, valid)


def subject_stats_cuda(crop: torch.Tensor):
    """The kernel: crop [h, w] float32 on a CUDA device, usually a strided
    view into the depth map (the row stride is passed, nothing is copied).
    One launch of one thread-block cluster writes one [66] float32 tensor:
    -> (hist [64], count, median), views of it on the device."""
    require_cuda("subject_stats_cuda", crop)
    rows, cols, ld = _matrix_view("subject_stats_cuda", crop)
    out = torch.empty(SUBJECT_BINS + 2, dtype=torch.float32, device=crop.device)
    launch("subject_stats", crop, "vd3d_subject_stats", crop.data_ptr(), rows, cols, ld,
           out.data_ptr())
    return out[:SUBJECT_BINS], out[SUBJECT_BINS], out[SUBJECT_BINS + 1]


def cluster_size() -> int:
    """The CTAs of subject_stats_cuda's cluster on the current card (16, or
    8 where a 16-CTA cluster cannot be scheduled)."""
    return lib().vd3d_subject_cluster()


def subject_stats(crop: torch.Tensor):
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    if crop.device.type == "cuda":
        return subject_stats_cuda(crop)
    if crop.device.type == "cpu":
        return subject_stats_torch(crop)
    raise ValueError(f"subject_stats: unsupported device {crop.device}")


def _matrix_view(what: str, x: torch.Tensor) -> tuple[int, int, int]:
    """(rows, cols, row stride) of a 2-D float32 view with unit column
    stride and at most MAX_ITEMS values; raises on anything else."""
    if x.ndim != 2 or x.dtype != torch.float32:
        raise TypeError(f"{what}: expected a 2-D float32 tensor, got "
                        f"{x.dtype} {tuple(x.shape)}")
    if x.stride(1) != 1:
        raise ValueError(f"{what}: columns must be contiguous")
    if x.numel() > MAX_ITEMS:
        raise ValueError(f"{what}: {x.shape[0]} x {x.shape[1]} values exceed the kernel's "
                         f"int32 indexing")
    return x.shape[0], x.shape[1], x.stride(0)
