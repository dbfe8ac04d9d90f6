"""K7: single-call attention over BNHD tensors (``csrc/attention.cu``)
and its plain version.

``vmem_attention`` dispatches on the tensors' device: a CUDA tensor
launches the kernel, a CPU tensor runs ``vmem_attention_torch``. Both keep
the TPU kernel's numerics (``ops/pallas_attention.py:vmem_attention``):
float32 logits and softmax statistics, the normalized probabilities
rounded to the input type, P V accumulated in float32, one rounding of the
output (the kernel's float32 body multiplies in split TF32, ``tf32.py``,
within float32's accuracy). q: [B, Nq, H, D], k and v: [B, Nk, H, D],
float32 or bfloat16: self-attention (Nq = Nk, the TPU kernel's form) or
its query-band form (Nq < Nk): a band of query rows against the whole
sequence, what the row-sharded depth model (``parallel/sp.py``) runs on
each band. Row i of
``vmem_attention(q[:, a:b], k, v)`` is row a + i of ``vmem_attention(q,
k, v)``: each query row's softmax sees the same keys in the same order.

K7 has no backward, nor has the TPU kernel: both versions raise when an
input requires grad with grad enabled (the launch would hand back a tensor
cut from the autograd graph, which trains silently wrong). Training takes
the default attention route.
"""

from __future__ import annotations

import math

import torch

from ._lib import launch, require_cuda

HEAD_DIMS = (16, 32, 64, 128)  # the kernel's instantiations


def _refuse_grad(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("vmem_attention: K7 has no backward and an input requires grad; "
                           "train with the default attention (ops.attention.USE_VMEM_KERNEL "
                           "off)")


def _check_shapes(what: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """q [B, Nq, H, D] against k = v [B, Nk, H, D] with 1 <= Nq <= Nk."""
    if (q.ndim != 4 or k.shape != v.shape or k.ndim != 4 or q.shape[0] != k.shape[0]
            or q.shape[2:] != k.shape[2:] or not 1 <= q.shape[1] <= k.shape[1]):
        raise ValueError(f"{what}: expected q [B, Nq, H, D] and k, v [B, Nk, H, D] with "
                         f"1 <= Nq <= Nk, got {tuple(q.shape)} {tuple(k.shape)} "
                         f"{tuple(v.shape)}")


def vmem_attention_torch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Plain version: f32 logits, f32 softmax, p in the input type, P V in f32
    (any Nq against Nk)."""
    _check_shapes("vmem_attention_torch", q, k, v)
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    m = torch.amax(s, dim=-1, keepdim=True)
    e = torch.exp(s - m)
    p = (e / torch.sum(e, dim=-1, keepdim=True)).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p.float(), v.float()).to(q.dtype)


def vmem_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The kernel: q [B, Nq, H, D], k and v [B, Nk, H, D] of one type
    (float32 or bfloat16) on one CUDA device, D in HEAD_DIMS. Returns
    [B, Nq, H, D] in that type."""
    _refuse_grad(q, k, v)
    require_cuda("vmem_attention_cuda", q, k, v)
    _check_shapes("vmem_attention_cuda", q, k, v)
    if q.dtype not in (torch.float32, torch.bfloat16) or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError("vmem_attention_cuda: q, k, v must share float32 or bfloat16")
    b, nq, h, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"vmem_attention_cuda: head dim {d} not in {HEAD_DIMS}")
    if b > 65535 or h > 65535:
        raise ValueError("vmem_attention_cuda: more than 65535 batches or heads")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("vmem_attention_cuda: inputs must be 16-byte aligned")
    out = torch.empty_like(q)
    launch("vmem_attention", q, "vd3d_attention", q.data_ptr(), k.data_ptr(), v.data_ptr(),
           out.data_ptr(), b, nq, k.shape[1], h, d, 1.0 / math.sqrt(d),
           int(q.dtype == torch.bfloat16))
    return out


def vmem_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The kernel for CUDA tensors, the plain version for CPU tensors;
    either raises when an input requires grad."""
    _refuse_grad(q, k, v)
    if q.device.type == "cuda":
        return vmem_attention_cuda(q, k, v)
    if q.device.type == "cpu":
        return vmem_attention_torch(q, k, v)
    raise ValueError(f"vmem_attention: unsupported device {q.device}")
