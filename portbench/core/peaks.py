"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
the 700 W power limit), as ``chip_smoke.py`` holds them: HBM bytes/s and
FLOP/s by type (float32 on the CUDA cores, outside the tensor cores)."""

from __future__ import annotations

PEAK_BYTES = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12, "tf32": 495e12}


def bound_s(flops: float, nbytes: float, dtype: str) -> float:
    """The least time (s) the card could take: the larger of the bytes over
    the memory rate and the operations over the peak rate of their type."""
    return max(nbytes / PEAK_BYTES, flops / PEAK_FLOPS[dtype])
