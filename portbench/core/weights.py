"""A model's weights from the seed, made on the device in one draw: one
``torch.randn`` of every normal leaf from a ``torch.Generator`` on the
device, sliced into the upstream names and scaled; norm gains, layer-scale
gains and biases are constants. The same seed gives the same tensors, so
the reference makes them again after the program's run."""

from __future__ import annotations

import torch


def state_dict(specs, seed: int, device, dtype=torch.float32) -> tuple[dict, float]:
    """(state dict, checksum) of (name, shape, init, scale) specs."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    sizes = [torch.Size(s).numel() for _, s, kind, _ in specs if kind == "normal"]
    buf = torch.randn(sum(sizes), generator=gen, device=dev, dtype=dtype)
    sd, off = {}, 0
    for name, shape, kind, scale in specs:
        if kind == "normal":
            n = torch.Size(shape).numel()
            sd[name] = buf[off: off + n].view(shape).mul_(scale)
            off += n
        else:
            sd[name] = torch.full(shape, scale, device=dev, dtype=dtype)
    checksum = float(sum(t.double().abs().sum() for t in sd.values()))
    return sd, checksum
