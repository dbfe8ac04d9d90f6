"""K2: the fused feather + heal pass (``csrc/postfx.cu``) and its plain version.

``feather_heal`` dispatches on the tensors' device: a CUDA tensor launches
the kernel, a CPU tensor runs ``feather_heal_torch``. Both compute in
float32 and return the image type, and the kernel rounds each step as the
plain version's tensor ops round it on the card (its gray mean grouped as
PyTorch's CUDA mean), so the two take the same heal-mask decisions there.
The mask is a threshold on a gradient: against other implementations (the
CPU's mean, the JAX package) a pixel whose gradient sits at the threshold
can flip, so compare those where the masks agree.
"""

from __future__ import annotations

import torch

from ..ops import edges
from ._lib import launch, require_cuda

MAX_BLUR_KSIZE = 15  # the kernel's edge-mask ring holds 4 + 15 - 1 rows


def feather_heal_torch(left, right, frame, dleft, dright, blur_ksize: int = 7,
                       feather_strength: float = 10.0, heal_strength: float = 0.5,
                       heal_threshold: float = 0.05, enable_feathering: bool = True,
                       enable_healing: bool = True):
    """Plain version: ops/edges.py feather then heal, per eye, in float32."""
    dt = left.dtype
    orig = frame.float()
    outs = []
    for eye, depth in ((left, dleft), (right, dright)):
        out = eye.float()
        if enable_feathering:
            out = edges.feather_shift_edges(out, orig, depth.float(), blur_ksize,
                                            feather_strength)
        if enable_healing:
            out = edges.heal_missing_pixels(out, orig, None, heal_strength, heal_threshold)
        outs.append(out.to(dt))
    return tuple(outs)


def feather_heal_cuda(left, right, frame, dleft, dright, blur_ksize: int = 7,
                      feather_strength: float = 10.0, heal_strength: float = 0.5,
                      heal_threshold: float = 0.05, enable_feathering: bool = True,
                      enable_healing: bool = True):
    """The kernel: left/right/frame [H, W, 3], dleft/dright [H, W], one
    image type (float32 or bfloat16), on one CUDA device."""
    require_cuda("feather_heal_cuda", left, right, frame, dleft, dright)
    h, w = dleft.shape
    if any(t.shape != (h, w, 3) for t in (left, right, frame)) or dright.shape != (h, w):
        raise ValueError("feather_heal_cuda: expected [H, W, 3] frames and [H, W] depths")
    if left.dtype not in (torch.float32, torch.bfloat16) or any(
            t.dtype != left.dtype for t in (right, frame, dleft, dright)):
        raise TypeError("feather_heal_cuda: all inputs must share float32 or bfloat16")
    if not 1 <= blur_ksize <= MAX_BLUR_KSIZE:
        raise ValueError(f"feather_heal_cuda: blur_ksize {blur_ksize} not in "
                         f"[1, {MAX_BLUR_KSIZE}]")
    ins = [t.contiguous() for t in (left, right, frame, dleft, dright)]
    out_l, out_r = torch.empty_like(ins[0]), torch.empty_like(ins[0])
    launch("feather_heal", left, "vd3d_feather_heal",
           *(t.data_ptr() for t in ins), out_l.data_ptr(), out_r.data_ptr(), h, w,
           int(blur_ksize), float(feather_strength), float(heal_strength),
           float(heal_threshold), int(enable_feathering), int(enable_healing),
           int(left.dtype == torch.bfloat16))
    return out_l, out_r


def feather_heal(left, right, frame, dleft, dright, **kw):
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    if left.device.type == "cuda":
        return feather_heal_cuda(left, right, frame, dleft, dright, **kw)
    if left.device.type == "cpu":
        return feather_heal_torch(left, right, frame, dleft, dright, **kw)
    raise ValueError(f"feather_heal: unsupported device {left.device}")
