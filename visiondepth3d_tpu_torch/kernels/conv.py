"""K5: the 3x3 stride-1 SAME conv (``csrc/conv.cu``) and its plain version.

Layout is the JAX package's: x [B, H, W, C] (NHWC) in float32 or bfloat16,
w [3, 3, C, O] (HWIO), bias [O]. Both versions follow the Pallas kernel's
arithmetic (``ops/pallas_conv.py:_conv3_kernel``): weights and bias rounded
to the input's type, the nine taps as one K = 9C product accumulated in
float32, bias and activation (none, relu, leaky relu) in float32, one
rounding to the input's type.

``conv3x3`` dispatches on the input's device: a CUDA tensor launches the
kernel, a CPU tensor runs ``conv3x3_torch``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from ._lib import check, launch_counts, lib, require_cuda, stream_of

_ACTS = {None: 0, "relu": 1, "lrelu": 2}
_IMAGE_TYPES = (torch.float32, torch.bfloat16)


def _activate(y: torch.Tensor, act: str | None, slope: float) -> torch.Tensor:
    if act == "relu":
        return torch.clamp_min(y, 0.0)
    if act == "lrelu":
        return torch.where(y >= 0.0, y, y * slope)
    if act is None:
        return y
    raise ValueError(f"conv3x3: unknown activation {act!r}")


def conv3x3_torch(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None,
                  act: str | None = None, slope: float = 0.2) -> torch.Tensor:
    """Plain version: the nine zero-padded shifted taps concatenated to
    K = 9C (tap-major, as HWIO reshapes), one float32 matmul, bias, act, one
    cast to x's type."""
    bsz, h, wd, c = x.shape
    o = w.shape[-1]
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1))
    cat9 = torch.cat([xp[:, ky:ky + h, kx:kx + wd] for ky in range(3) for kx in range(3)],
                     dim=-1)
    y = cat9.reshape(-1, 9 * c) @ w.to(x.dtype).float().reshape(9 * c, o)
    if b is not None:
        y = y + b.to(x.dtype).float()
    return _activate(y, act, slope).reshape(bsz, h, wd, o).to(x.dtype)


class PackedConv(NamedTuple):
    """The kernel's weight layout: w [9, Cp, Op] in the input's type with
    Cp, Op the channel counts rounded up to 16 (zero padded), and the bias
    rounded to the input's type, then float32 [Op]."""

    w: torch.Tensor
    bias: torch.Tensor
    c: int
    o: int


def _round16(n: int) -> int:
    return (n + 15) // 16 * 16


def pack_conv3x3(w: torch.Tensor, b: torch.Tensor | None, dtype: torch.dtype) -> PackedConv:
    """HWIO weights and bias -> the kernel's layout (once per module)."""
    c, o = int(w.shape[2]), int(w.shape[3])
    wp = torch.zeros(9, _round16(c), _round16(o), dtype=dtype, device=w.device)
    wp[:, :c, :o] = w.detach().reshape(9, c, o).to(dtype)
    bp = torch.zeros(_round16(o), dtype=torch.float32, device=w.device)
    if b is not None:
        bp[:o] = b.detach().to(dtype).float()
    return PackedConv(wp, bp, c, o)


def conv3x3_cuda(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None,
                 act: str | None = None, slope: float = 0.2,
                 packed: PackedConv | None = None) -> torch.Tensor:
    """The kernel: x [B, H, W, C] float32 or bfloat16 on a CUDA device,
    w [3, 3, C, O]; ``packed`` (from ``pack_conv3x3`` for x's type) skips
    the re-layout of w and b. Returns [B, H, W, O] in x's type."""
    if act not in _ACTS:
        raise ValueError(f"conv3x3_cuda: unknown activation {act!r}")
    if x.ndim != 4 or x.dtype not in _IMAGE_TYPES:
        raise TypeError(f"conv3x3_cuda: x must be [B, H, W, C] float32/bfloat16, "
                        f"got {tuple(x.shape)} {x.dtype}")
    bsz, h, wd, c = x.shape
    if tuple(w.shape[:3]) != (3, 3, c):
        raise ValueError(f"conv3x3_cuda: weights {tuple(w.shape)} for {c} input channels")
    if packed is None:
        packed = pack_conv3x3(w, b, x.dtype)
    if packed.w.dtype != x.dtype or packed.c != c:
        raise ValueError("conv3x3_cuda: packed weights do not fit the input")
    require_cuda("conv3x3_cuda", x, packed.w, packed.bias)
    if bsz > 65535:
        raise ValueError("conv3x3_cuda: more than 65535 images")
    x = x.contiguous()
    out = torch.empty(bsz, h, wd, packed.o, dtype=x.dtype, device=x.device)
    vec = int(c % (16 // x.element_size()) == 0 and x.data_ptr() % 16 == 0)
    cp, op = packed.w.shape[1], packed.w.shape[2]
    rc = lib().vd3d_conv3x3(x.data_ptr(), packed.w.data_ptr(), packed.bias.data_ptr(),
                            out.data_ptr(), bsz, h, wd, c, packed.o, cp, op, _ACTS[act],
                            float(slope), int(x.dtype == torch.bfloat16), vec, stream_of(x))
    check(rc, "conv3x3_cuda")
    launch_counts["conv3x3"] += 1
    return out


def conv3x3(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None,
            act: str | None = None, slope: float = 0.2,
            packed: PackedConv | None = None) -> torch.Tensor:
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    if x.device.type == "cuda":
        return conv3x3_cuda(x, w, b, act, slope, packed)
    if x.device.type == "cpu":
        return conv3x3_torch(x, w, b, act, slope)
    raise ValueError(f"conv3x3: unsupported device {x.device}")
