"""Tensor parallelism: Megatron-style splits of the ViT blocks over the
``tp`` devices of a mesh group.

Counterpart of ``visiondepth3d_tpu/parallel/tp.py``, whose
``vit_param_spec`` places the attention's ``qkv`` kernel and bias and
``mlp/fc1`` column-wise and the attention's ``proj`` kernel and ``mlp/fc2``
kernel row-wise, everything else replicated, and lets GSPMD insert one psum
per attention and MLP block. Here the same parameters are split (q/k/v,
``output.dense``'s weight, ``fc1``, ``fc2``'s weight; ``split_plan``
lists them under their unsharded names).

One controller process drives the group: ``shard_module`` replaces each
``dinov2.Attention`` and ``dinov2.Mlp`` with a split twin whose parts live
on the group's devices, and moves everything else to the group's first
device. The attention is split by head (as evenly as possible where the
heads do not divide ``tp``: the JAX rule shards whatever divides, and
every ``tp`` it accepts is accepted here), the MLP's hidden units as evenly
as possible. Each part computes its heads or units from a copy of the
block's input and a partial product with its share of the row-wise
weight; the partial products are summed on the first device in device
order, then the bias is added: one reduction per attention or MLP block.
The partial products and their sum are float32 whatever the model's type
(a bf16 model's parts run bf16 GEMMs with float32 outputs on the card),
and the sum is rounded to the model's type once, as one device's GEMM
rounds its float32 accumulation once. The split still sums in another
order than one GEMM, so about 0.02-0.08 % of a block's bf16 outputs move
by one ulp; a model that amplifies rounding (the random-weight ones)
carries that to the output as it carries bf16 against float32.
Attention runs on each device's heads through ``ops/attention.py``, so
with the K7 opt-in K7 launches once per device at [B, N, heads / tp, D].
Gradients flow back through the ``.to()`` copies under autograd, so a
trainer takes ``tp`` in one process. A model with no such block (another
family) runs whole on the first device, as JAX replicates it.
"""

from __future__ import annotations

import copy

import torch
import torch.nn.functional as F
from torch import nn

from ..depth.dinov2 import Attention, Mlp
from ..ops.attention import multi_head_attention
from .halo import lead_sum
from .mesh import replicate


def even_split(n: int, k: int) -> list[tuple[int, int]]:
    """[a, b) ranges of n items over k parts, sizes differing by at most one
    (the larger first)."""
    cuts = [i * (n // k) + min(i, n % k) for i in range(k + 1)]
    return list(zip(cuts[:-1], cuts[1:]))


def partial_product(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """x @ weight.T (x [..., k], weight [out, k]) in float32: on the card a
    bf16/f16 GEMM with a float32 output; on the CPU in float32."""
    if x.dtype == torch.float32:
        return F.linear(x, weight)
    x2 = x.reshape(-1, x.shape[-1])
    if x.is_cuda:
        out = torch.mm(x2, weight.t(), out_dtype=torch.float32)
    else:
        out = torch.mm(x2.float(), weight.t().float())
    return out.reshape(*x.shape[:-1], weight.shape[0])


def reduce_parts(partial: list[torch.Tensor], bias: torch.Tensor, device,
                 dtype: torch.dtype) -> torch.Tensor:
    """The float32 partial products summed on ``device`` in order, plus the
    bias, rounded once to ``dtype``."""
    return (lead_sum(partial, device) + bias.float()).to(dtype)


def _linear(weight: torch.Tensor, bias: torch.Tensor | None, device) -> nn.Linear:
    """An nn.Linear holding copies of weight [out, in] and bias on device."""
    lin = nn.Linear(weight.shape[1], weight.shape[0], bias=bias is not None,
                    device=device, dtype=weight.dtype)
    with torch.no_grad():
        lin.weight.copy_(weight)
        if bias is not None:
            lin.bias.copy_(bias)
    return lin


class _AttentionPart(nn.Module):
    def __init__(self, attn: Attention, h0: int, h1: int, head_dim: int, device):
        super().__init__()
        a, rows = attn.attention, slice(h0 * head_dim, h1 * head_dim)
        self.num_heads = h1 - h0
        self.query = _linear(a.query.weight[rows], a.query.bias[rows], device)
        self.key = _linear(a.key.weight[rows], a.key.bias[rows], device)
        self.value = _linear(a.value.weight[rows], a.value.bias[rows], device)
        self.dense = _linear(attn.output.dense.weight[:, rows], None, device)


class TPAttention(nn.Module):
    """``dinov2.Attention`` with its heads split over ``devices``."""

    # the parameters split, under dinov2.Attention's names: "col" splits the
    # output features, "row" the input features
    SPLIT = {**{f"attention.{n}.{leaf}": "col" for n in ("query", "key", "value")
                for leaf in ("weight", "bias")}, "output.dense.weight": "row"}

    def __init__(self, attn: Attention, devices):
        super().__init__()
        self.num_heads = attn.num_heads
        c = attn.output.dense.weight.shape[0]
        self.head_dim = c // self.num_heads
        self.devices = [torch.device(d) for d in devices]
        self.parts = nn.ModuleList(
            _AttentionPart(attn, h0, h1, self.head_dim, d)
            for (h0, h1), d in zip(even_split(self.num_heads, len(self.devices)), self.devices)
            if h1 > h0)
        self.bias = nn.Parameter(attn.output.dense.bias.detach().to(self.devices[0]))

    def forward(self, x):  # [B, N, C] on the first device
        b, n, _ = x.shape
        partial = []
        for part in self.parts:
            xi = x.to(part.dense.weight.device, non_blocking=True)

            def heads(t):
                return t.reshape(b, n, part.num_heads, self.head_dim)

            out = multi_head_attention(heads(part.query(xi)), heads(part.key(xi)),
                                       heads(part.value(xi)))
            partial.append(partial_product(out.reshape(b, n, -1), part.dense.weight))
        return reduce_parts(partial, self.bias, self.devices[0], x.dtype)

    def full_state(self, grads: bool = False) -> dict:
        """The parameters (or their gradients) under ``dinov2.Attention``'s
        names, whole, on the first device."""
        def get(p):
            return (p.grad if grads else p).detach().to(self.devices[0])

        out = {}
        for name in ("query", "key", "value"):
            out[f"attention.{name}.weight"] = torch.cat(
                [get(getattr(q, name).weight) for q in self.parts])
            out[f"attention.{name}.bias"] = torch.cat(
                [get(getattr(q, name).bias) for q in self.parts])
        out["output.dense.weight"] = torch.cat([get(q.dense.weight) for q in self.parts], dim=1)
        out["output.dense.bias"] = get(self.bias)
        return out


class TPMlp(nn.Module):
    """``dinov2.Mlp`` with its hidden units split over ``devices``."""

    SPLIT = {"fc1.weight": "col", "fc1.bias": "col", "fc2.weight": "row"}

    def __init__(self, mlp: Mlp, devices):
        super().__init__()
        self.devices = [torch.device(d) for d in devices]
        hidden = mlp.fc1.weight.shape[0]
        self.fc1 = nn.ModuleList()
        self.fc2 = nn.ModuleList()
        for (a, b), d in zip(even_split(hidden, len(self.devices)), self.devices):
            if b > a:
                self.fc1.append(_linear(mlp.fc1.weight[a:b], mlp.fc1.bias[a:b], d))
                self.fc2.append(_linear(mlp.fc2.weight[:, a:b], None, d))
        self.bias = nn.Parameter(mlp.fc2.bias.detach().to(self.devices[0]))

    def forward(self, x):
        partial = [partial_product(F.gelu(f1(x.to(f1.weight.device, non_blocking=True))),
                                   f2.weight) for f1, f2 in zip(self.fc1, self.fc2)]
        return reduce_parts(partial, self.bias, self.devices[0], x.dtype)

    def full_state(self, grads: bool = False) -> dict:
        def get(p):
            return (p.grad if grads else p).detach().to(self.devices[0])

        return {"fc1.weight": torch.cat([get(f.weight) for f in self.fc1]),
                "fc1.bias": torch.cat([get(f.bias) for f in self.fc1]),
                "fc2.weight": torch.cat([get(f.weight) for f in self.fc2], dim=1),
                "fc2.bias": get(self.bias)}


def shard_module(model: nn.Module, devices) -> nn.Module:
    """``model`` (changed in place) with every ``dinov2.Attention`` and
    ``dinov2.Mlp`` split over ``devices`` and everything else on
    devices[0]."""
    devices = [torch.device(d) for d in devices]
    model.to(devices[0])
    for parent in list(model.modules()):
        for name, child in list(parent.named_children()):
            if isinstance(child, (Attention, Mlp)):
                split = (TPAttention if isinstance(child, Attention) else TPMlp)(child, devices)
                setattr(parent, name, split.train(child.training))
    return model


def split_plan(model: nn.Module) -> dict[str, str]:
    """The parameters ``shard_module`` split in ``model``, under their
    unsharded names: "col" or "row"."""
    return {f"{prefix}.{k}": v for prefix, mod in model.named_modules()
            if isinstance(mod, (TPAttention, TPMlp)) for k, v in mod.SPLIT.items()}


def full_state_dict(model: nn.Module, grads: bool = False) -> dict:
    """The parameters (or gradients) of a model under its unsharded names,
    whole, each on the first device of its split."""
    out, inside = {}, []
    for prefix, mod in model.named_modules():
        if any(prefix.startswith(p) for p in inside):
            continue
        pre = f"{prefix}." if prefix else ""
        if isinstance(mod, (TPAttention, TPMlp)):
            inside.append(pre)
            out.update({pre + k: v for k, v in mod.full_state(grads).items()})
            continue
        for leaf, p in mod.named_parameters(recurse=False):
            out[pre + leaf] = (p.grad if grads else p).detach()
    return out


def tp_predictor(predictor, devices):
    """A copy of ``predictor`` (a ``DepthPredictor``) whose model is split
    over ``devices`` (``shard_module``); its inputs land on devices[0]."""
    devices = [torch.device(d) for d in devices]
    rep = replicate(predictor, devices[0])
    if rep is predictor:
        rep = copy.copy(predictor)
        rep.model = copy.deepcopy(predictor.model)
    rep.model = shard_module(rep.model, devices)
    return rep
