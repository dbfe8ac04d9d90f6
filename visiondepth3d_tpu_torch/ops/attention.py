"""Multi-head self-attention dispatch over [B, N, H, D] tensors.

Counterpart of ``visiondepth3d_tpu/ops/attention.py``. The default route is
``F.scaled_dot_product_attention`` (on the card its fused flash or
memory-efficient backends play the role of the JAX package's XLA and
library-kernel routes). The JAX package's opt-in keeps its name and gate:
with ``USE_VMEM_KERNEL`` set, self-attention with 512 <= N <
``_FLASH_ALWAYS_SEQ`` and at most ``_VMEM_MAX_HEADS`` heads runs K7
(``kernels/attention.py``): the hand kernel for a CUDA tensor, its plain
version for a CPU tensor (where the JAX package asks for a TPU backend).
From ``_FLASH_ALWAYS_SEQ`` tokens on, the JAX package takes its flash
library route whatever the flags; here that route is SDPA.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels import attention as kattention

USE_VMEM_KERNEL = False
_VMEM_MAX_HEADS = 8
_VMEM_MIN_SEQ = 512  # the JAX package's _FLASH_MIN_SEQ
_FLASH_ALWAYS_SEQ = 4096  # the JAX package's: from here on, always the library route


def multi_head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Scaled dot-product attention, BNHD in and out."""
    n = q.shape[1]
    if (USE_VMEM_KERNEL and k.shape[1] == n and _VMEM_MIN_SEQ <= n < _FLASH_ALWAYS_SEQ
            and q.shape[2] <= _VMEM_MAX_HEADS):
        return kattention.vmem_attention(q, k, v)
    out = F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                         v.transpose(1, 2))
    return out.transpose(1, 2)
