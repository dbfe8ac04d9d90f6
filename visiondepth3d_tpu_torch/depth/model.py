"""Depth model wrapper: preprocessing, forward, per-batch normalization.

Counterpart of ``visiondepth3d_tpu/depth/model.py``: batches of frames in,
batches of depth maps out, at a fixed inference size snapped to the ViT
patch multiple. The public layout is the JAX package's: frames
[B, H, W, 3] float RGB in [0, 1], depth [B, h, w].
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


class DepthPredictor:
    """A depth model at a fixed inference size on one device.

    ``model``: a ``DepthAnything`` with its weights loaded. A bfloat16
    predictor casts the weights once here, not per call. ``device``: the
    CUDA card unless the caller passes "cpu"; without a card the default
    raises.
    """

    def __init__(self, model: DepthAnything, inference_size: int | tuple = 518,
                 dtype: str = "float32", device=DEFAULT_DEVICE,
                 mean: tuple = IMAGENET_MEAN, std: tuple = IMAGENET_STD):
        if dtype not in _DTYPES:
            raise ValueError(f"dtype {dtype!r} not in {tuple(_DTYPES)}")
        self.dtype = dtype
        self.device = resolve_device(device)
        self.cfg = model.cfg
        self.model = model.to(device=self.device, dtype=_DTYPES[dtype]).eval()
        self.inference_size = inference_size
        self._size = snap_hw(inference_size, self.cfg.backbone.patch_size)  # (h, w)
        self._mean = torch.tensor(mean, dtype=_DTYPES[dtype], device=self.device)
        self._std = torch.tensor(std, dtype=_DTYPES[dtype], device=self.device)

    @torch.no_grad()
    def __call__(self, frames01: torch.Tensor) -> torch.Tensor:
        """[B, H, W, 3] float RGB in [0, 1] -> [B, h, w] float32 raw depth."""
        x = frames01.to(device=self.device, dtype=_DTYPES[self.dtype])
        x = resize_bilinear(x, self._size, channel_last=True)
        x = (x - self._mean) / self._std
        depth = self.model(x.permute(0, 3, 1, 2))
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
    (``init_random_model_args``): LayerNorm scales and layer-scale gains 1,
    biases 0, everything else N(0, fan_in^-1/2). Drawn on the CPU from
    ``generator``, so one seed gives the same weights on every device."""
    with torch.no_grad():
        for module_name, module in model.named_modules():
            for leaf, p in module.named_parameters(recurse=False):
                if leaf == "lambda1" or (isinstance(module, nn.LayerNorm) and leaf == "weight"):
                    p.fill_(1.0)
                elif leaf == "bias":
                    p.zero_()
                else:
                    std = _flax_fan_in(module, module_name, p) ** -0.5
                    p.copy_(torch.randn(p.shape, generator=generator) * std)
    return model


def build_random(cfg: DPTConfig, seed: int = 0, fast_head: bool = False) -> DepthAnything:
    """A DepthAnything with seeded random weights (tests, benchmarks)."""
    return init_random_(DepthAnything(cfg, fast_head=fast_head),
                        torch.Generator().manual_seed(seed))

