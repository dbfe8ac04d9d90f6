"""The split-TF32 form of float32 operands, as K5's and K7's float32 bodies
use it (``csrc/hopper.cuh``), in plain PyTorch.

A float32 x is split into two TF32 values (the low 13 of the 23 mantissa
bits zero): ``big``, x rounded to TF32 to nearest with ties away from zero
(the card's ``cvt.rna.tf32.f32``), and ``small``, the rest ``x - big``
(exact in float32) rounded the same way. ``big + small`` is within 2^-22
of |x|, so a product a b taken as the three TF32 products a_small b_big +
a_big b_small + a_big b_big, each exact in float32 and summed in float32,
keeps float32 accuracy; the dropped a_small b_small is below 2^-22 |a b|.
``pack_conv3x3`` stores K5's float32 weights as their two halves.
"""

from __future__ import annotations

import torch

LOW_BITS = 13  # float32 mantissa bits that TF32 drops


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 x rounded to TF32, to nearest, ties away from zero; inf and
    NaN pass unchanged."""
    x = x.to(torch.float32).contiguous()
    bits = x.view(torch.int32)
    # sign and magnitude: adding half of the dropped bits' unit to the
    # pattern rounds the magnitude half away from zero (a carry moves into
    # the exponent as it should), the mask drops them
    half = 1 << (LOW_BITS - 1)
    rounded = ((bits + half) & ~((1 << LOW_BITS) - 1)).view(torch.float32)
    return torch.where(torch.isfinite(x), rounded, x)


def split_tf32(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x (as float32) -> (big, small), both TF32 values, big + small within
    2^-22 |x|."""
    x = x.to(torch.float32)
    big = round_tf32(x)
    return big, round_tf32(x - big)
