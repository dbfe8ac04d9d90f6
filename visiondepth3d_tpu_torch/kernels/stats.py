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

Band forms, for a frame whose rows lie in bands on several devices
(``parallel/halo.py``): ``quantile_hist_band`` and ``subject_hist_band``
add a band's exact integer counts into an int32 buffer on the band's
device; the buffers are summed on one device, where
``quantile_pair_finish`` and ``subject_stats_finish`` replay the
bisections on the sum. Integer sums do not depend on their order, so the
results are the one-shot functions' on the whole frame, bit for bit. Each
has its plain version beside it (``*_torch``); a CUDA tensor always runs
the kernel.
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


# ------------------------------------------------------------------ band forms

QBAND_BINS = 4096  # right-closed bins of the valid values of a subject crop
SUBJECT_BAND = QBAND_BINS + SUBJECT_BINS + 1  # + the counts of values on j / 64, j = 0 .. 64


def _qbins(flat: torch.Tensor) -> torch.Tensor:
    """K3's bin of each value: ceil(x * 4096) - 1, values <= 0 in bin 0,
    values above 1 (and NaN) in bin 4096."""
    b = torch.ceil(flat * float(QBAND_BINS)).to(torch.int64) - 1
    b = torch.where(flat <= 0.0, 0, b)
    return torch.where(flat <= 1.0, b, QBAND_BINS)


def _add_counts(buf: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return buf.index_add_(0, idx, torch.ones_like(idx, dtype=torch.int32))


def quantile_hist_band_torch(x: torch.Tensor, hist: torch.Tensor) -> torch.Tensor:
    """Plain version: add the QHIST_BINS counts of a 2-D view into ``hist``
    (int32 [QHIST_BINS]); returns ``hist``."""
    return _add_counts(hist, _qbins(x.reshape(-1)))


def quantile_hist_band_cuda(x: torch.Tensor, hist: torch.Tensor) -> torch.Tensor:
    """The kernel: add the counts of x [h, w] float32 (rows may be
    strided) into ``hist`` (int32 [QHIST_BINS] on x's device). One launch."""
    require_cuda("quantile_hist_band_cuda", x, hist)
    rows, cols, ld = _matrix_view("quantile_hist_band_cuda", x)
    _buffer("quantile_hist_band_cuda", hist, QHIST_BINS)
    launch("quantile_hist_band", x, "vd3d_quantile_hist_band", x.data_ptr(), rows, cols, ld,
           hist.data_ptr())
    return hist


def quantile_hist_band(x: torch.Tensor, hist: torch.Tensor | None = None) -> torch.Tensor:
    """Add a band's counts into ``hist`` (a zeroed one on x's device when
    None): the kernel for CUDA tensors, the plain version for CPU tensors.
    An empty band adds nothing and launches nothing."""
    if hist is None:
        hist = torch.zeros(QHIST_BINS, dtype=torch.int32, device=x.device)
    if x.numel() == 0:
        return hist
    if x.device.type == "cuda":
        return quantile_hist_band_cuda(x, hist)
    if x.device.type == "cpu":
        return quantile_hist_band_torch(x, hist)
    raise ValueError(f"quantile_hist_band: unsupported device {x.device}")


def _replay(cum: torch.Tensor, count: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """The bisection's end from the counts of x <= k / 4096 for k = 1 ..
    4095 (``cum``, int64): fl(cum / count) < q only falls as k grows, so
    the 12 decisions end at lo = K / 4096, K the k where it holds."""
    k = ((cum.to(torch.float32) / count)[:, None] < q[None, :]).sum(0).to(torch.float32)
    return (k / QBAND_BINS + (k + 1.0) / QBAND_BINS) * 0.5


def quantile_pair_finish_torch(hist: torch.Tensor, n: int, q0: float, q1: float):
    """Plain version: the two quantiles of ``n`` values from their summed
    counts. -> [2] float32."""
    cum = torch.cumsum(hist[:QBAND_BINS - 1].to(torch.int64), 0)
    q = torch.tensor([q0, q1], dtype=torch.float32, device=hist.device)
    return _replay(cum, torch.tensor(float(n), dtype=torch.float32, device=hist.device), q)


def quantile_pair_finish_cuda(hist: torch.Tensor, n: int, q0: float, q1: float):
    """The kernel: one CTA replays both bisections on the summed counts.
    -> [2] float32 on the device."""
    require_cuda("quantile_pair_finish_cuda", hist)
    _buffer("quantile_pair_finish_cuda", hist, QHIST_BINS)
    out = torch.empty(2, dtype=torch.float32, device=hist.device)
    launch("quantile_pair_finish", hist, "vd3d_quantile_pair_finish", hist.data_ptr(), int(n),
           float(q0), float(q1), out.data_ptr())
    return out


def quantile_pair_finish(hist: torch.Tensor, n: int, q0: float, q1: float) -> torch.Tensor:
    """quantile_pair of the n values whose counts ``hist`` sums."""
    if hist.device.type == "cuda":
        return quantile_pair_finish_cuda(hist, n, q0, q1)
    if hist.device.type == "cpu":
        return quantile_pair_finish_torch(hist, n, q0, q1)
    raise ValueError(f"quantile_pair_finish: unsupported device {hist.device}")


def subject_hist_band_torch(crop: torch.Tensor, buf: torch.Tensor) -> torch.Tensor:
    """Plain version: add the valid values' (0.05 < d < 0.95) right-closed
    counts and their counts on j / 64 into ``buf`` (int32 [SUBJECT_BAND])."""
    flat = crop.reshape(-1)
    v = flat[(flat > 0.05) & (flat < 0.95)]
    t = v * float(QBAND_BINS)
    c = torch.ceil(t)
    _add_counts(buf, c.to(torch.int64) - 1)
    on_edge = (c == t) & (torch.remainder(c, float(SUBJECT_BINS)) == 0)
    return _add_counts(buf, QBAND_BINS + (c[on_edge] / SUBJECT_BINS).to(torch.int64))


def subject_hist_band_cuda(crop: torch.Tensor, buf: torch.Tensor) -> torch.Tensor:
    """The kernel: add the counts of crop [h, w] float32 (rows may be
    strided) into ``buf`` (int32 [SUBJECT_BAND] on its device). One launch."""
    require_cuda("subject_hist_band_cuda", crop, buf)
    rows, cols, ld = _matrix_view("subject_hist_band_cuda", crop)
    _buffer("subject_hist_band_cuda", buf, SUBJECT_BAND)
    launch("subject_hist_band", crop, "vd3d_subject_hist_band", crop.data_ptr(), rows, cols,
           ld, buf.data_ptr())
    return buf


def subject_hist_band(crop: torch.Tensor, buf: torch.Tensor | None = None) -> torch.Tensor:
    """Add a band's share of the subject crop into ``buf`` (a zeroed one on
    crop's device when None). An empty share launches nothing."""
    if buf is None:
        buf = torch.zeros(SUBJECT_BAND, dtype=torch.int32, device=crop.device)
    if crop.numel() == 0:
        return buf
    if crop.device.type == "cuda":
        return subject_hist_band_cuda(crop, buf)
    if crop.device.type == "cpu":
        return subject_hist_band_torch(crop, buf)
    raise ValueError(f"subject_hist_band: unsupported device {crop.device}")


def subject_stats_finish_torch(buf: torch.Tensor):
    """Plain version: (64-bin histogram [64], valid count, masked
    lower-middle median) from summed band counts, as subject_stats_torch
    gives them on the whole crop."""
    hist = buf[:QBAND_BINS].to(torch.int64)
    edge = buf[QBAND_BINS:].to(torch.int64)
    hist64 = (hist.reshape(SUBJECT_BINS, -1).sum(1) + edge[:-1] - edge[1:]).to(torch.float32)
    cnt = hist.sum().to(torch.float32)
    count = torch.clamp(cnt, min=1.0)
    q = (torch.floor((count - 1.0) / 2.0) + 1.0) / count
    median = _replay(torch.cumsum(hist[:QBAND_BINS - 1], 0), count, q.reshape(1))[0]
    return hist64, cnt, median


def subject_stats_finish_cuda(buf: torch.Tensor):
    """The kernel: one CTA finishes the summed counts. -> (hist [64],
    count, median), views of one [66] float32 tensor on the device."""
    require_cuda("subject_stats_finish_cuda", buf)
    _buffer("subject_stats_finish_cuda", buf, SUBJECT_BAND)
    out = torch.empty(SUBJECT_BINS + 2, dtype=torch.float32, device=buf.device)
    launch("subject_stats_finish", buf, "vd3d_subject_stats_finish", buf.data_ptr(),
           out.data_ptr())
    return out[:SUBJECT_BINS], out[SUBJECT_BINS], out[SUBJECT_BINS + 1]


def subject_stats_finish(buf: torch.Tensor):
    """subject_stats of the crop whose band counts ``buf`` sums."""
    if buf.device.type == "cuda":
        return subject_stats_finish_cuda(buf)
    if buf.device.type == "cpu":
        return subject_stats_finish_torch(buf)
    raise ValueError(f"subject_stats_finish: unsupported device {buf.device}")


def _buffer(what: str, buf: torch.Tensor, n: int) -> None:
    """Raise unless buf is a contiguous int32 [n] count buffer."""
    if buf.dtype != torch.int32 or tuple(buf.shape) != (n,) or not buf.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous int32 [{n}] buffer, got "
                         f"{buf.dtype} {tuple(buf.shape)}")
