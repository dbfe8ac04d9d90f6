"""Depth model wrapper: preprocessing, forward, per-batch normalization.

Counterpart of ``visiondepth3d_tpu/depth/model.py``: batches of frames in,
batches of depth maps out, at a fixed inference size snapped to the
backbone's patch multiple. The public layout is the JAX package's: frames
[B, H, W, 3] float RGB in [0, 1], depth [B, h, w]. Any family's model fits:
an ``nn.Module`` with a ``cfg`` that maps normalized [B, 3, H, W] pixels to
[B, h, w] depth (or a tuple holding it, picked by ``select``).
"""

from __future__ import annotations

import torch
from torch import nn

from ..device import DEFAULT_DEVICE, resolve_device
from ..ops.resize import resize_bilinear
from .configs import DPTConfig
from .dpt import DepthAnything

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
# HF's IMAGENET_STANDARD statistics (ZoeDepth's processor)
STANDARD_MEAN = (0.5, 0.5, 0.5)
STANDARD_STD = (0.5, 0.5, 0.5)
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def snap(value: int, multiple: int) -> int:
    """Largest multiple of ``multiple`` that is <= value (min one)."""
    return max(multiple, (value // multiple) * multiple)


def snap_hw(size, multiple: int) -> tuple[int, int]:
    """Per-dimension snap of a square int or an (h, w) inference size."""
    if isinstance(size, (tuple, list)):
        h, w = int(size[0]), int(size[1])
    else:
        h = w = int(size)
    return snap(h, multiple), snap(w, multiple)


def patch_multiple(cfg) -> int:
    """The size multiple a config's backbone takes: ``cfg.backbone``'s patch,
    else ``cfg.base.backbone``'s (ZoeDepth-NK nests its trunk)."""
    bb = getattr(cfg, "backbone", None)
    if bb is None:
        bb = getattr(getattr(cfg, "base", None), "backbone", None)
    if bb is None:
        raise ValueError(f"{type(cfg).__name__} names no backbone: pass snap_multiple")
    return bb.patch_size


class DepthPredictor:
    """A depth model at a fixed inference size on one device.

    ``model``: any family's model with its weights loaded (it carries its
    ``cfg``). A bfloat16 predictor casts the weights once here, not per
    call. ``device``: the CUDA card unless the caller passes "cpu"; without
    a card the default raises. ``mean``/``std``: the family's input
    statistics. ``select``: the index of the depth in a model that returns
    a tuple (ZoeDepth-NK: (depth, domain_logits)). ``snap_multiple``: the
    size multiple where it is not the backbone's patch (MiDaS v2: 32).
    """

    def __init__(self, model: nn.Module, inference_size: int | tuple = 518,
                 dtype: str = "float32", device=DEFAULT_DEVICE,
                 mean: tuple = IMAGENET_MEAN, std: tuple = IMAGENET_STD,
                 select: int | None = None, snap_multiple: int | None = None):
        if dtype not in _DTYPES:
            raise ValueError(f"dtype {dtype!r} not in {tuple(_DTYPES)}")
        self.dtype = dtype
        self.device = resolve_device(device)
        self.cfg = model.cfg
        self.model = model.to(device=self.device, dtype=_DTYPES[dtype]).eval()
        self.inference_size = inference_size
        self.select = select
        multiple = snap_multiple if snap_multiple is not None else patch_multiple(self.cfg)
        self._size = snap_hw(inference_size, multiple)  # (h, w)
        self._mean = torch.tensor(mean, dtype=_DTYPES[dtype], device=self.device)
        self._std = torch.tensor(std, dtype=_DTYPES[dtype], device=self.device)

    @torch.no_grad()
    def __call__(self, frames01: torch.Tensor) -> torch.Tensor:
        """[B, H, W, 3] float RGB in [0, 1] -> [B, h, w] float32 raw depth."""
        x = frames01.to(device=self.device, dtype=_DTYPES[self.dtype])
        x = resize_bilinear(x, self._size, channel_last=True)
        x = (x - self._mean) / self._std
        depth = self.model(x.permute(0, 3, 1, 2))
        if self.select is not None:
            depth = depth[self.select]
        return depth.float()

    def predict_01(self, frames01: torch.Tensor, out_hw: tuple[int, int] | None = None):
        """Depth normalized per frame to [0, 1], resized to out_hw."""
        d = self(frames01)
        lo = torch.amin(d, dim=(1, 2), keepdim=True)
        hi = torch.amax(d, dim=(1, 2), keepdim=True)
        d01 = (d - lo) / torch.clamp(hi - lo, min=1e-6)
        if out_hw is not None:
            d01 = resize_bilinear(d01, tuple(out_hw), channel_last=False)
        return d01


def _flax_fan_in(module: nn.Module, module_name: str, p: torch.Tensor) -> int:
    """fan_in as the JAX package's init rule sees it: shape[0] of the flax
    parameter (layout (I, O), (k, k, I, O) or (C, f, f, O)) when it has two
    or more axes, else its size."""
    if isinstance(module, nn.ConvTranspose2d):  # (C, O, f, f) -> (C, f, f, O)
        return p.shape[0]
    if isinstance(module, nn.Conv2d):
        if module_name.endswith("patch_embeddings.projection"):
            return p.shape[1] * p.shape[2] * p.shape[3]  # dense (p * p * 3, C)
        # 1x1 conv -> Dense (I, O); k x k conv -> (k, k, I, O)
        return p.shape[1] if p.shape[2] == 1 else p.shape[2]
    if isinstance(module, nn.Linear):  # (O, I) -> (I, O)
        return p.shape[1]
    return p.shape[0] if p.ndim >= 2 else p.numel()  # cls token, position embeddings


def init_random_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Random weights with the JAX package's init rule
    (``init_random_model_args``): LayerNorm and GroupNorm scales and DINOv2
    layer-scale gains 1, BEiT's gains (``lambda_1``/``lambda_2``) at the
    layer's ``layerscale_value``, biases 0, everything else (bias tables,
    class tokens and position embeddings included) N(0, fan_in^-1/2).
    Drawn on the CPU from ``generator``, so one seed gives the same weights
    on every device."""
    with torch.no_grad():
        for module_name, module in model.named_modules():
            for leaf, p in module.named_parameters(recurse=False):
                if leaf in ("lambda_1", "lambda_2"):
                    p.fill_(module.layerscale_value)
                elif leaf == "lambda1" or (isinstance(module, (nn.LayerNorm, nn.GroupNorm))
                                           and leaf == "weight"):
                    p.fill_(1.0)
                elif leaf == "bias":
                    p.zero_()
                else:
                    std = _flax_fan_in(module, module_name, p) ** -0.5
                    p.copy_(torch.randn(p.shape, generator=generator) * std)
    return model


def init_random_fan_in_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Random weights as flax's default initializers draw them (what the JAX
    package's ``model.init`` gives Depth Pro and the diffusion modules):
    N(0, 1 / fan_in) with the true fan-in (input channels times kernel
    area; a stride-f transposed conv's input channels), norm scales and
    layer-scale gains 1, biases 0. The JAX package's ``init_random_`` rule
    (a k x k conv's fan-in taken as k) makes Depth Pro's deep conv fusion
    explode. Drawn on the CPU from ``generator``: one seed, the same
    weights on every device."""
    with torch.no_grad():
        for module in model.modules():
            for leaf, p in module.named_parameters(recurse=False):
                if leaf == "bias":
                    p.zero_()
                elif leaf == "lambda1" or isinstance(module, (nn.GroupNorm, nn.LayerNorm)):
                    p.fill_(1.0)
                else:
                    fan_in = (p.shape[0] if isinstance(module, nn.ConvTranspose2d)
                              else p[0].numel())  # Linear (O, I), Conv2d (O, I, k, k)
                    p.copy_(torch.randn(p.shape, generator=generator) * fan_in ** -0.5)
    return model


def build_random_model(model: nn.Module, seed: int = 0, init=init_random_) -> nn.Module:
    """Any family's model with seeded random weights (tests, benchmarks)."""
    return init(model, torch.Generator().manual_seed(seed))


def build_random(cfg: DPTConfig, seed: int = 0, fast_head: bool = False) -> DepthAnything:
    """A DepthAnything with seeded random weights (tests, benchmarks)."""
    return build_random_model(DepthAnything(cfg, fast_head=fast_head), seed)

