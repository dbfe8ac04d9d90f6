"""Depth model fine-tuning: scale-shift-invariant loss + one training step.

Counterpart of ``visiondepth3d_tpu/train/trainer.py``. The loss is the
MiDaS scale-and-shift-invariant MSE (per-image closed-form (s, t)
alignment of the prediction to the target) plus a multi-scale
gradient-matching term, ported line for line. The optimizer is
``torch.optim.AdamW`` with optax ``adamw``'s defaults (betas 0.9 / 0.999,
eps 1e-8, decoupled weight decay on every parameter).

Data parallelism is PyTorch's: one process per card (``torchrun``), the
model wrapped in ``DistributedDataParallel`` once a process group is
initialized; every rank is handed the whole batch and takes its own
contiguous shard, and DDP's gradient all-reduce (a mean over ranks) gives
every rank the whole batch's gradient, as the JAX package's ``P("dp")``
batch constraint does. Without a process group the trainer runs on its
one device. A mesh with ``tp=K`` splits the ViT's attention and MLP blocks
Megatron-style over its first ``tp`` group's K devices in this process
(``parallel/tp.py``, the JAX trainer's ``shard_params``); under DDP each
rank's module then spans its own group. The JAX trainer shards no rows, so
a mesh with ``sp`` > 1 raises. The attention kernel K7 has no backward:
with its opt-in set, a step raises instead of training on a graph it cut.
"""

from __future__ import annotations

import copy

import torch
import torch.distributed as dist
from torch.nn.parallel import DistributedDataParallel

from ..depth.configs import DPTConfig
from ..depth.convert import from_jax_params, load_hf_state_dict
from ..depth.dpt import DepthAnything
from ..depth.model import init_random_fan_in_
from ..device import DEFAULT_DEVICE, resolve_device, same_device
from ..parallel.tp import shard_module


def ssi_align(pred: torch.Tensor, target: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Per-image least-squares (scale, shift) aligning pred to target.

    pred/target/mask: [B, H, W]. Returns aligned pred.
    """
    m = mask.to(pred.dtype)
    n = torch.clamp(torch.sum(m, dim=(1, 2)), min=1.0)
    sp = torch.sum(pred * m, dim=(1, 2))
    st = torch.sum(target * m, dim=(1, 2))
    spp = torch.sum(pred * pred * m, dim=(1, 2))
    spt = torch.sum(pred * target * m, dim=(1, 2))
    det = torch.clamp(n * spp - sp * sp, min=1e-6)
    scale = (n * spt - sp * st) / det
    shift = (st - scale * sp) / n
    return pred * scale[:, None, None] + shift[:, None, None]


def ssi_loss(pred, target, mask=None, grad_weight: float = 0.5, grad_scales: int = 4):
    """Scale-shift-invariant MSE + multi-scale gradient matching."""
    if mask is None:
        mask = torch.ones_like(target)
    aligned = ssi_align(pred, target, mask)
    m = mask.to(pred.dtype)
    n = torch.clamp(torch.sum(m, dim=(1, 2)), min=1.0)
    data = torch.sum(((aligned - target) ** 2) * m, dim=(1, 2)) / n

    reg = 0.0
    diff = aligned - target
    for s in range(grad_scales):
        step = 2**s
        d = diff[:, ::step, ::step]
        mm = m[:, ::step, ::step]
        gx = torch.abs(d[:, :, 1:] - d[:, :, :-1]) * mm[:, :, 1:] * mm[:, :, :-1]
        gy = torch.abs(d[:, 1:, :] - d[:, :-1, :]) * mm[:, 1:, :] * mm[:, :-1, :]
        # the JAX loss counts every pixel of the scale (mm[:, ::1]), not the
        # differences: kept as it is
        cnt = torch.clamp(torch.sum(mm[:, ::1], dim=(1, 2)), min=1.0)
        reg = reg + (torch.sum(gx, dim=(1, 2)) + torch.sum(gy, dim=(1, 2))) / cnt
    return torch.mean(data + grad_weight * reg)


class Trainer:
    """A ``DepthAnything`` (the JAX package's, exact head) and its AdamW
    state on ``device`` (the CUDA card unless the caller passes the CPU;
    without a card the default raises). ``init`` sets the weights and the
    optimizer; ``step(frames, targets)`` takes one AdamW step on [B, H, W,
    3] ImageNet-normalized frames and [B, H, W] targets and returns the
    batch's loss."""

    def __init__(self, cfg: DPTConfig, learning_rate: float = 1e-4,
                 weight_decay: float = 1e-2, device=DEFAULT_DEVICE):
        self.cfg = cfg
        self.learning_rate, self.weight_decay = learning_rate, weight_decay
        self.device = resolve_device(device)
        self.module = DepthAnything(cfg).to(self.device)
        self.model = self.module  # DDP's wrapper under a process group
        self.optimizer: torch.optim.AdamW | None = None

    def init(self, source=None, mesh=None) -> "Trainer":
        """Weights from ``source``: a ``torch.Generator`` (drawn on the CPU
        as flax's default initializers draw the JAX trainer's: N(0,
        1/fan_in) with the true fan-in; the inference path's rule, a k x k
        conv's fan-in taken as k, blows DPT's fusion up to outputs near
        1e12, on which the loss only wanders), the JAX package's params
        tree (``depth/convert.from_jax_params``), or None (seed 0).
        Under an initialized process group the model is wrapped in DDP
        (rank 0's weights are broadcast). ``mesh``: its dp axis is the
        process group's business; with tp > 1 the model is split over
        ``mesh.devices[0, 0, :]`` (the first is this trainer's device); sp
        > 1 raises."""
        if mesh is not None and mesh.shape.get("sp", 1) > 1:
            raise ValueError("the trainer shards no rows, as the JAX trainer does not "
                             "(it shards the batch over dp and the ViT over tp): drop sp")
        if isinstance(source, dict):
            load_hf_state_dict(self.module, from_jax_params(source, self.cfg))
        else:
            gen = source if source is not None else torch.Generator().manual_seed(0)
            init_random_fan_in_(self.module.cpu(), gen)
            self.module.to(self.device)
        if mesh is not None and mesh.shape.get("tp", 1) > 1:
            group = list(mesh.devices[0, 0, :])
            if not same_device(group[0], self.device):
                raise ValueError(f"the tp group starts on {group[0]}, the trainer is on "
                                 f"{self.device}")
            self.module = self.model = shard_module(self.module, group)
        self._setup()
        return self

    def _setup(self) -> None:
        """DDP under a process group, and a fresh optimizer."""
        if dist.is_available() and dist.is_initialized():
            one_device = len({p.device for p in self.module.parameters()}) == 1
            ids = [self.device] if self.device.type == "cuda" and one_device else None
            self.model = DistributedDataParallel(self.module, device_ids=ids)
        self.optimizer = torch.optim.AdamW(self.module.parameters(), lr=self.learning_rate,
                                           betas=(0.9, 0.999), eps=1e-8,
                                           weight_decay=self.weight_decay)

    def _shard(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's contiguous share of the batch (all of it alone)."""
        if not isinstance(self.model, DistributedDataParallel):
            return x
        world, rank = dist.get_world_size(), dist.get_rank()
        if x.shape[0] % world:
            raise ValueError(f"batch {x.shape[0]} does not split over {world} ranks")
        k = x.shape[0] // world
        return x[rank * k: (rank + 1) * k]

    def step(self, frames, targets) -> float:
        """One AdamW step on the batch; returns its loss (under DDP the mean
        of the ranks' losses: the whole batch's). The gradients stay in the
        parameters' ``.grad`` until the next step."""
        if self.optimizer is None:
            raise RuntimeError("Trainer.init() first")
        frames = self._shard(torch.as_tensor(frames)).to(self.device, torch.float32)
        targets = self._shard(torch.as_tensor(targets)).to(self.device, torch.float32)
        self.model.train()
        self.optimizer.zero_grad(set_to_none=True)
        loss = ssi_loss(self.model(frames.permute(0, 3, 1, 2)), targets)
        loss.backward()
        self.optimizer.step()
        loss = loss.detach()
        if isinstance(self.model, DistributedDataParallel):
            dist.all_reduce(loss)
            loss = loss / dist.get_world_size()
        return float(loss)

    def state_dict(self) -> dict:
        """A copy of the weights and the optimizer state (later steps do not
        change it)."""
        return copy.deepcopy({"model": self.module.state_dict(),
                              "optimizer": self.optimizer.state_dict()})

    def load_state_dict(self, state: dict) -> None:
        """The weights and the optimizer state of ``state_dict()`` (instead
        of ``init``, or over it)."""
        self.module.load_state_dict(state["model"])
        if self.optimizer is None:
            self._setup()
        self.optimizer.load_state_dict(state["optimizer"])
