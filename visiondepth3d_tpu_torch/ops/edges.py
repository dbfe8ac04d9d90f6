"""Edge-aware artifact control: shift suppression, feathering, healing.

Counterpart of ``visiondepth3d_tpu/ops/edges.py``. ``feather_shift_edges``
followed by ``heal_missing_pixels`` is the plain version of the post-fx
kernel (``kernels/postfx.py``).
"""

from __future__ import annotations

import torch

from .filters import box_blur, forward_diff_grad


def suppress_artifacts_with_edge_mask(depth: torch.Tensor, total_shift: torch.Tensor,
                                      feather_strength: float = 10.0,
                                      edge_threshold: float = 0.02) -> torch.Tensor:
    """Soft-suppress the shift map near sharp depth edges. [H, W] in/out."""
    dx, dy = forward_diff_grad(depth)
    dx, dy = torch.abs(dx), torch.abs(dy)
    grad_mag = torch.sqrt(dx * dx + dy * dy)
    edge_mask = 1.0 / (1.0 + torch.exp(-((grad_mag - edge_threshold)
                                         * feather_strength * 5.0)))
    return total_shift * box_blur(1.0 - edge_mask, 5)


def feather_shift_edges(shifted: torch.Tensor, original: torch.Tensor,
                        warped_depth: torch.Tensor, blur_ksize: int = 7,
                        feather_strength: float = 10.0) -> torch.Tensor:
    """Blend the warped frame back toward the original at depth edges.
    shifted/original: [H, W, 3]; warped_depth: [H, W]."""
    dx, dy = forward_diff_grad(warped_depth)
    grad_mag = torch.sqrt(dx * dx + dy * dy)
    edge_mask = torch.clamp(grad_mag * feather_strength, 0.0, 1.0)
    blend = box_blur(edge_mask, blur_ksize)[..., None]
    return torch.clamp(shifted * (1.0 - blend) + original * blend, 0.0, 1.0)


def heal_missing_pixels(warped_frame: torch.Tensor, original_frame: torch.Tensor,
                        heal_strength: float = 0.5,
                        threshold: float = 0.05) -> torch.Tensor:
    """Blend the original into high-gradient (gap) areas, then re-soften
    the healed areas with a 3x3 blur. [H, W, 3] in/out."""
    dx, dy = forward_diff_grad(warped_frame.mean(dim=-1))
    grad_mag = torch.sqrt(dx * dx + dy * dy)
    missing = (grad_mag > threshold).to(warped_frame.dtype)
    m = torch.clamp(box_blur(missing, 5), 0.0, 1.0)[..., None]
    healed = (1.0 - heal_strength * m) * warped_frame + heal_strength * m * original_frame
    soft = box_blur(healed.permute(2, 0, 1), 3).permute(1, 2, 0)
    healed = (1.0 - 0.3 * m) * healed + 0.3 * m * soft
    return torch.clamp(healed, 0.0, 1.0)
