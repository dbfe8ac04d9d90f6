"""K5: the 3x3 stride-1 SAME conv (``csrc/conv.cu``) and its plain version.

Layout is the JAX package's: x [B, H, W, C] (NHWC) in float32 or bfloat16,
w [3, 3, C, O] (HWIO), bias [O]. Both versions follow the Pallas kernel's
arithmetic (``ops/pallas_conv.py:_conv3_kernel``): weights and bias rounded
to the input's type, the nine taps as one K = 9C product accumulated in
float32, bias and activation (none, relu, leaky relu) in float32, one
rounding to the input's type. The kernel's float32 body takes each product
as three TF32 products of split operands (``tf32.py``), within float32's
accuracy of the plain version.

``conv3x3`` dispatches on the input's device: a CUDA tensor launches the
kernel, a CPU tensor runs ``conv3x3_torch``. Both take strided views: x may
be a channel slice ``[..., :c]`` of a wider NHWC tensor, and ``out`` (when
given) a channel slice of one, written in place and returned; any other
stride pattern raises. The dense blocks of the RRDB trunk read and write
one buffer this way.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from ._lib import launch, require_cuda
from .tf32 import split_tf32

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


def is_channel_slice(t: torch.Tensor) -> bool:
    """Whether a [B, H, W, C] tensor is contiguous or a channel slice
    ``[..., a:b]`` of a contiguous NHWC tensor: the views K5 reads and
    writes in place."""
    if t.ndim != 4 or t.is_contiguous():
        return t.ndim == 4
    _, h, w, c = t.shape
    sb, sh, sw, sc = t.stride()
    return sc == 1 and sw >= c and sh == w * sw and sb == h * sh


def pixel_stride(t: torch.Tensor, what: str = "x") -> int:
    """The pixel stride of a [B, H, W, C] channel slice (``is_channel_slice``);
    raises on any other layout."""
    if not is_channel_slice(t):
        raise ValueError(f"conv3x3: {what} {list(t.shape)} with strides {t.stride()} is "
                         f"neither contiguous nor a channel slice of a contiguous NHWC tensor")
    return int(t.shape[3]) if t.is_contiguous() else t.stride(2)


def _check_out(out: torch.Tensor, x: torch.Tensor, o: int) -> int:
    want = (*x.shape[:3], o)
    if tuple(out.shape) != want or out.dtype != x.dtype or out.device != x.device:
        raise ValueError(f"conv3x3: out must be {list(want)} {x.dtype} on {x.device}, got "
                         f"{list(out.shape)} {out.dtype} on {out.device}")
    return pixel_stride(out, "out")


def conv3x3_torch(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None,
                  act: str | None = None, slope: float = 0.2,
                  out: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version: the nine zero-padded shifted taps concatenated to
    K = 9C (tap-major, as HWIO reshapes), one float32 matmul, bias, act, one
    cast to x's type; copied into ``out`` when given."""
    pixel_stride(x)
    bsz, h, wd, c = x.shape
    o = w.shape[-1]
    if out is not None:
        _check_out(out, x, o)
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1))
    cat9 = torch.cat([xp[:, ky:ky + h, kx:kx + wd] for ky in range(3) for kx in range(3)],
                     dim=-1)
    y = cat9.reshape(-1, 9 * c) @ w.to(x.dtype).float().reshape(9 * c, o)
    if b is not None:
        y = y + b.to(x.dtype).float()
    y = _activate(y, act, slope).reshape(bsz, h, wd, o).to(x.dtype)
    if out is None:
        return y
    return out.copy_(y)


CK = 32  # input channels per chunk of the bf16 kernel
CK_F32 = 16  # input channels per chunk of the float32 kernel


class PackedConv(NamedTuple):
    """The kernel's weight layout (``csrc/conv.cu``) and the bias rounded to
    the input's type, then float32, both zero padded:

    - bfloat16: w [O / bn, Cp / 32, 9, bn, 4, 8]: per block of bn output
      channels and chunk of 32 input channels, the nine taps' [bn][32]
      tiles, each 64-byte row with its 16-byte groups of 8 input channels
      swizzled (group j of row n at j ^ ((n >> 1) & 3));
    - float32: w [O / bn, Cp / 16, 2, 9, bn, 4, 4]: per block of bn output
      channels and chunk of 16 input channels, the big then the small
      TF32 half (``tf32.split_tf32``; the kernel multiplies in split TF32)
      of the nine taps' [bn][16] tiles, the channels of each 8 in the order
      0, 2, 4, 6, 1, 3, 5, 7 (``k8_order``), each 64-byte row with its
      16-byte groups of 4 swizzled the same way.

    ``cp``, ``op``: the padded channel counts; ``bn``: output channels per
    block."""

    w: torch.Tensor
    bias: torch.Tensor
    c: int
    o: int
    cp: int
    op: int
    bn: int


def _round(n: int, m: int) -> int:
    return -(-n // m) * m


def block_n(o: int) -> int:
    """Output channels per block of the bf16 kernel: all of them up to 64,
    else blocks of 64 (or 32 where that divides O and 64 does not)."""
    for bn in (8, 16, 32, 64):
        if o <= bn:
            return bn
    return 32 if o % 64 and o % 32 == 0 else 64


def k8_order(n: int, device=None) -> torch.Tensor:
    """The float32 kernel's K order over n channels (a multiple of 8):
    within each 8, channels 0, 2, 4, 6, 1, 3, 5, 7, so that a thread's two
    A-fragment columns t and t + 4 of a k8 step are the adjacent channels
    2 t and 2 t + 1 of the window (one 8-byte load)."""
    k = torch.arange(n, device=device)
    return k - k % 8 + 2 * (k % 4) + (k % 8) // 4


def pack_conv3x3(w: torch.Tensor, b: torch.Tensor | None, dtype: torch.dtype) -> PackedConv:
    """HWIO weights and bias -> the kernel's layout for inputs of ``dtype``
    (once per module)."""
    c, o = int(w.shape[2]), int(w.shape[3])
    bn = block_n(o)
    ck = CK if dtype == torch.bfloat16 else CK_F32
    cp, op = _round(c, ck), _round(o, bn)
    wp = torch.zeros(9, cp, op, dtype=dtype, device=w.device)
    wp[:, :c, :o] = w.detach().reshape(9, c, o).to(dtype)
    n = torch.arange(bn, device=w.device)[:, None]
    swz = torch.arange(4, device=w.device)[None, :] ^ ((n >> 1) & 3)
    if dtype == torch.bfloat16:
        # [9, chunk, 32, block, bn] -> [block, chunk, 9, bn, 4 groups, 8]
        wp = wp.reshape(9, cp // CK, CK, op // bn, bn).permute(3, 1, 0, 4, 2)
        wp = wp.reshape(op // bn, cp // CK, 9, bn, 4, 8)[:, :, :, n, swz]
    else:
        # [half, 9, chunk, 16, block, bn] -> [block, chunk, half, 9, bn, 4 groups, 4]
        wp = torch.stack(split_tf32(wp[:, k8_order(cp, w.device)]))
        wp = wp.reshape(2, 9, cp // ck, ck, op // bn, bn)
        wp = wp.permute(4, 2, 0, 1, 5, 3).reshape(op // bn, cp // ck, 2, 9, bn, 4, 4)
        wp = wp[:, :, :, :, n, swz]
    bp = torch.zeros(op, dtype=torch.float32, device=w.device)
    if b is not None:
        bp[:o] = b.detach().to(dtype).float()
    return PackedConv(wp.contiguous(), bp, c, o, cp, op, bn)


def conv3x3_cuda(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None,
                 act: str | None = None, slope: float = 0.2,
                 packed: PackedConv | None = None,
                 out: torch.Tensor | None = None) -> torch.Tensor:
    """The kernel: x [B, H, W, C] float32 or bfloat16 on a CUDA device
    (contiguous or a channel slice), w [3, 3, C, O]; ``packed`` (from
    ``pack_conv3x3`` for x's type) skips the re-layout of w and b. Writes
    into ``out`` (a [B, H, W, O] channel slice of x's type, not overlapping
    x) when given, else into a new tensor; returns it."""
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
    x_stride = pixel_stride(x)
    if out is None:
        out = torch.empty(bsz, h, wd, packed.o, dtype=x.dtype, device=x.device)
    out_stride = _check_out(out, x, packed.o)
    launch("conv3x3", x, "vd3d_conv3x3", x.data_ptr(), packed.w.data_ptr(),
           packed.bias.data_ptr(), out.data_ptr(), bsz, h, wd, c, x_stride, packed.o,
           out_stride, packed.cp, packed.op, packed.bn, _ACTS[act], float(slope),
           int(x.dtype == torch.bfloat16))
    return out


def conv3x3(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None,
            act: str | None = None, slope: float = 0.2,
            packed: PackedConv | None = None,
            out: torch.Tensor | None = None) -> torch.Tensor:
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    if x.device.type == "cuda":
        return conv3x3_cuda(x, w, b, act, slope, packed, out)
    if x.device.type == "cpu":
        return conv3x3_torch(x, w, b, act, slope, out)
    raise ValueError(f"conv3x3: unsupported device {x.device}")
