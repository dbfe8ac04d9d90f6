"""The precision the reference computes its products in.

``Mat("float32")`` computes every product in IEEE float32: on the card with
TF32 off in cuBLAS and cuDNN (``float32_products``). ``Mat("tf32")`` is the
control: on the card the same calls with TF32 on, on the CPU (which has no
TF32) each operand rounded to TF32 first (10 mantissa bits, to nearest,
ties away from zero, as the card's ``cvt.rna.tf32.f32``), products and
sums in float32.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

LOW_BITS = 13  # float32 mantissa bits that TF32 drops


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    x = x.contiguous()
    bits = x.view(torch.int32)
    rounded = ((bits + (1 << (LOW_BITS - 1))) & ~((1 << LOW_BITS) - 1)).view(torch.float32)
    return torch.where(torch.isfinite(x), rounded, x)


@contextlib.contextmanager
def float32_products(tf32: bool = False):
    """cuBLAS and cuDNN with TF32 on or off for the block; restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


class Mat:
    """The reference's products in one precision."""

    def __init__(self, precision: str = "float32"):
        if precision not in ("float32", "tf32"):
            raise ValueError(f"precision {precision!r}")
        self.precision = precision

    def _r(self, *xs):
        if self.precision == "tf32" and xs[0].device.type == "cpu":
            return tuple(round_tf32(x) for x in xs)
        return xs

    def scope(self):
        """The cuBLAS and cuDNN setting this precision runs under."""
        return float32_products(self.precision == "tf32")

    def einsum(self, eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        a, b = self._r(a, b)
        return torch.einsum(eq, a, b)

    def linear(self, x, w, b=None):
        x, w = self._r(x, w)
        return F.linear(x, w, b)

    def matmul(self, a, b):
        a, b = self._r(a, b)
        return torch.matmul(a, b)

    def conv2d(self, x, w, b=None, stride=1, padding=0):
        x, w = self._r(x, w)
        return F.conv2d(x, w, b, stride=stride, padding=padding)

    def conv_transpose2d(self, x, w, b=None, stride=1):
        x, w = self._r(x, w)
        return F.conv_transpose2d(x, w, b, stride=stride)
