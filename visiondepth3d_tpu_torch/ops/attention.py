"""Multi-head self-attention dispatch over [B, N, H, D] tensors.

Counterpart of ``visiondepth3d_tpu/ops/attention.py``. The default route is
``F.scaled_dot_product_attention`` (on the card its fused flash or
memory-efficient backends play the role of the JAX package's XLA and
library-kernel routes). The JAX package's opt-in keeps its name and its
sequence gate: with ``USE_VMEM_KERNEL`` set, self-attention with 512 <= N
< ``_FLASH_ALWAYS_SEQ`` runs K7 (``kernels/attention.py``): the hand kernel
for a CUDA tensor, its plain version for a CPU tensor (where the JAX
package asks for a TPU backend). From ``_FLASH_ALWAYS_SEQ`` tokens on, the
JAX package takes its flash library route whatever the flags; here that
route is SDPA.

The opt-in's shape gate: the JAX package caps it at 8 heads, its TPU
kernel's VMEM budget. K7 on the card has no such budget (one CTA per
(batch, head, query tile)), so ViT-B and ViT-L (12 and 16 heads) take it
too; it is instantiated for the head dims in ``kattention.HEAD_DIMS`` only,
so any other head dim (the VAE's one head of 512) goes to SDPA. That is a
routing rule, not a fallback: a K7 launch that fails raises.

q, k and v of mixed types are promoted to their common type first, as the
JAX package does before ``jax.nn.dot_product_attention``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels import attention as kattention

USE_VMEM_KERNEL = False
_VMEM_MIN_SEQ = 512  # the JAX package's _FLASH_MIN_SEQ
_FLASH_ALWAYS_SEQ = 4096  # the JAX package's: from here on, always the library route


def multi_head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Scaled dot-product attention, BNHD in and out."""
    if not (q.dtype == k.dtype == v.dtype):
        dt = torch.promote_types(torch.promote_types(q.dtype, k.dtype), v.dtype)
        q, k, v = q.to(dt), k.to(dt), v.to(dt)
    n = q.shape[1]
    if (USE_VMEM_KERNEL and k.shape[1] == n and _VMEM_MIN_SEQ <= n < _FLASH_ALWAYS_SEQ
            and q.shape[-1] in kattention.HEAD_DIMS):
        return kattention.vmem_attention(q, k, v)
    out = F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                         v.transpose(1, 2))
    return out.transpose(1, 2)
