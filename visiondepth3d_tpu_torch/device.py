"""The device an entry point runs on: the CUDA card unless the caller asks
for the CPU. A CUDA device that is not there is an error, never a silent
fall back to the CPU."""

from __future__ import annotations

import numpy as np
import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device=DEFAULT_DEVICE) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {str(device)!r} requested but no CUDA device is available "
                           f"(pass device='cpu' to run on the CPU)")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(device)!r}")
    return dev


def same_device(a, b) -> bool:
    """Whether two devices name one: "cuda" without an index is the
    current card."""
    def canonical(d):
        d = torch.device(d)
        if d.type == "cuda" and d.index is None:
            return torch.device("cuda", torch.cuda.current_device())
        return d

    return canonical(a) == canonical(b)


def host_to_device(arr: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A host array on ``dev``: through pinned memory and an asynchronous
    copy for a CUDA device (the copy overlaps the host's next work)."""
    t = torch.from_numpy(arr)
    if dev.type == "cuda":
        return t.pin_memory().to(dev, non_blocking=True)
    return t
