"""Depth model catalog of the port: Depth Anything V2-Small only.

Counterpart of ``visiondepth3d_tpu/depth/registry.py`` for the one model
of the fused render route; the other families are not ported yet.
"""

from __future__ import annotations

import torch

from ..device import DEFAULT_DEVICE
from . import configs
from .convert import load_hf_state_dict, load_safetensors
from .dpt import DepthAnything
from .model import DepthPredictor, build_random

CATALOG = {"depth-anything-v2-small": configs.DA_V2_SMALL}

# named presets, width-first like the reference's labels
INFERENCE_RESOLUTIONS: dict[str, tuple[int, int]] = {
    "dc-fastest": (512, 256),
    "dc-balanced": (704, 384),
    "dc-good-quality": (960, 540),
    "dc-max-quality": (1024, 576),
    "depth-anything-wide": (910, 518),
    "720p": (1280, 720),
    "1080p": (1920, 1080),
}


def parse_inference_size(spec) -> int | tuple[int, int]:
    """CLI size spec -> square int or (h, w): "518", "WxH" (width first)
    or a named preset."""
    if isinstance(spec, int):
        return spec
    s = str(spec).strip().lower()
    if s in INFERENCE_RESOLUTIONS:
        w, h = INFERENCE_RESOLUTIONS[s]
        return (h, w)
    if "x" in s:
        w, h = s.split("x", 1)
        return (int(h), int(w))
    try:
        return int(s)
    except ValueError:
        raise ValueError(f"--inference-size {spec!r}: expected an int, WxH, or one of "
                         f"{sorted(INFERENCE_RESOLUTIONS)}") from None


def load_predictor(name: str, checkpoint=None, inference_size: int | tuple = 518,
                   seed: int = 0, dtype: str = "float32", device=DEFAULT_DEVICE,
                   fast_head: bool = False, config=None) -> DepthPredictor:
    """A predictor for a catalog entry on ``device`` (the CUDA card unless
    the caller passes "cpu"; without a card the default raises).

    checkpoint: an HF ``.safetensors`` file, an HF-keyed state dict, or None
    for seeded random weights (shape and speed testing only).
    config: overrides the catalog config (tiny configs in tests).
    """
    if name not in CATALOG:
        raise KeyError(f"model {name!r} is not ported; available: {sorted(CATALOG)}")
    cfg = config if config is not None else CATALOG[name]
    if checkpoint is None:
        model = build_random(cfg, seed, fast_head=fast_head)
    else:
        state = checkpoint if isinstance(checkpoint, dict) else load_safetensors(checkpoint)
        state = {k: v.to(torch.float32) for k, v in state.items()}
        model = load_hf_state_dict(DepthAnything(cfg, fast_head=fast_head), state)
    return DepthPredictor(model, inference_size, dtype=dtype, device=device)
