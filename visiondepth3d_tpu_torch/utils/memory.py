"""Memory-aware batch sizing (the reference's VRAM heuristic).

The reference sizes inference batches from free CUDA memory:
``min(4 * (VRAM_GB - 1), 32)`` (render_depth.py:1206-1213). The JAX package
sizes them by a per-frame activation estimate against the device's memory;
the port keeps that formula and reads the card's total memory with
``torch.cuda.mem_get_info``. Off the card there is no memory to read: the
caller passes the byte count.
"""

from __future__ import annotations

from ..device import DEFAULT_DEVICE, resolve_device


def device_memory_bytes(device=DEFAULT_DEVICE) -> float:
    """The total memory of a CUDA device, in bytes."""
    import torch

    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError(f"device {str(device)!r} has no device memory to read: pass "
                         f"total_bytes to dynamic_batch_size")
    _, total = torch.cuda.mem_get_info(dev)
    return float(total)


def dynamic_batch_size(
    frame_hw: tuple[int, int],
    inference_size: int = 518,
    model_params_bytes: float = 100e6,
    max_batch: int = 32,
    budget_fraction: float = 0.6,
    total_bytes: float | None = None,
    device=DEFAULT_DEVICE,
) -> int:
    """Frames per inference batch sized to the memory budget.

    Activation estimate per frame: the ViT token activations dominate,
    ~40 floats per pixel of the inference grid, plus the full-resolution
    frame and depth buffers. ``total_bytes``: the memory to size against;
    None reads the card's (``device``).
    """
    total = device_memory_bytes(device) if total_bytes is None else float(total_bytes)
    budget = total * budget_fraction - 3.0 * model_params_bytes
    h, w = frame_hw
    per_frame = (
        inference_size * inference_size * 40 * 4  # backbone activations
        + h * w * 3 * 4 * 2  # frame + packed output
        + h * w * 4 * 3  # depth + tracker/aux buffers
    )
    n = int(budget // max(per_frame, 1))
    return max(1, min(n, max_batch))
