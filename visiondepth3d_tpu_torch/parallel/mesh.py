"""Device meshes: named axes over a list of torch devices.

Counterpart of ``visiondepth3d_tpu/parallel/mesh.py``. The axes keep their
meaning:

- ``dp``  frame/data parallel: independent video segments, batch rows or
  diffusion windows, one device each;
- ``sp``  spatial parallel: frame rows within a frame;
- ``tp``  tensor parallel: attention heads / MLP columns of depth models.

One controller process drives the whole mesh: each device's work is
enqueued (asynchronous launches) before any result is read back, so
distinct cards overlap. A device may appear more than once (``[cuda:0,
cuda:0]`` runs a two-way mesh on one card; ``[cpu, cpu]`` on the host),
and work for a repeated device shares one replica of a model.

The JAX module's ``frame_dp_sharding``, ``spatial_sharding`` and
``replicated`` are GSPMD sharding annotations with no PyTorch meaning: the
mesh routes place each piece of work on its device themselves, so they are
not carried.
"""

from __future__ import annotations

import copy
import dataclasses

import numpy as np
import torch
from torch import nn

AXES = ("dp", "sp", "tp")


@dataclasses.dataclass
class Mesh:
    """``devices``: an object array of ``torch.device`` shaped by the axes
    (``(dp, sp, tp)`` from ``make_mesh``); ``shape``: axis name -> size, as
    the JAX package reads ``mesh.shape``."""

    devices: np.ndarray

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(AXES, self.devices.shape))

    @property
    def device_list(self) -> list[torch.device]:
        return list(self.devices.reshape(-1))


def visible_devices() -> list[torch.device]:
    """The visible CUDA cards; raises without one (a mesh never falls back
    to the CPU: pass CPU devices explicitly)."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise RuntimeError("no CUDA device is available for the mesh (pass devices=["
                           "torch.device('cpu'), ...] to run it on the CPU)")
    return [torch.device("cuda", i) for i in range(n)]


def make_mesh(dp: int | None = None, sp: int = 1, tp: int = 1, devices=None) -> Mesh:
    devices = [torch.device(d) for d in (devices if devices is not None
                                         else visible_devices())]
    n = len(devices)
    if dp is None:
        dp = n // (sp * tp)
    assert dp * sp * tp == n, (
        f"mesh {dp}x{sp}x{tp} != {n} devices"
    )
    arr = np.empty(n, dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(dp, sp, tp))


def _collect(x, seen: set, out: list) -> None:
    """Every tensor reachable from x through modules, containers and object
    attributes, each once."""
    if id(x) in seen:
        return
    seen.add(id(x))
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, nn.Module):
        for t in (*x.parameters(), *x.buffers()):
            _collect(t, seen, out)
        for v in vars(x).values():
            _collect(v, seen, out)
    elif isinstance(x, dict):
        for v in x.values():
            _collect(v, seen, out)
    elif isinstance(x, (list, tuple)):
        for v in x:
            _collect(v, seen, out)
    elif hasattr(x, "__dict__") and not isinstance(x, type):
        for v in vars(x).values():
            _collect(v, seen, out)


def _retarget(x, device: torch.device, seen: set) -> None:
    """Set every ``device`` attribute reachable from x to ``device``."""
    if id(x) in seen or isinstance(x, (torch.Tensor, type)):
        return
    seen.add(id(x))
    if isinstance(x, dict):
        for v in x.values():
            _retarget(v, device, seen)
    elif isinstance(x, (list, tuple)):
        for v in x:
            _retarget(v, device, seen)
    elif hasattr(x, "__dict__"):
        if isinstance(getattr(x, "device", None), torch.device) \
                and not isinstance(x, nn.Module):
            x.device = device
        for v in vars(x).values():
            _retarget(v, device, seen)


def replicate(obj, device):
    """``obj`` (a predictor, a pipeline, a module) on ``device``: obj
    itself when all its tensors are there, else a copy whose every
    tensor is moved there (parameters stay parameters) and whose ``device``
    attributes name it. Each tensor is copied once, straight to ``device``."""
    device = torch.device(device)
    tensors: list = []
    _collect(obj, set(), tensors)
    if all(t.device == device for t in tensors):
        return obj
    memo = {}
    for t in tensors:
        moved = t.detach().to(device)
        if isinstance(t, nn.Parameter):
            moved = nn.Parameter(moved, requires_grad=t.requires_grad)
        memo[id(t)] = moved
    out = copy.deepcopy(obj, memo)
    _retarget(out, device, set())
    return out


def replicas(obj, devices) -> dict[torch.device, object]:
    """One replica of obj per distinct device (``replicate``)."""
    return {d: replicate(obj, d) for d in dict.fromkeys(map(torch.device, devices))}
