"""Depth model catalog of the port: the ``dpt_dinov2`` family.

Counterpart of ``visiondepth3d_tpu/depth/registry.py`` for the ViT/DINOv2
+ DPT family: Depth Anything V1/V2 Small/Base/Large, Distill-Any-Depth
Small/Large and the two metric Depth Anything V2 models, each entry with
its config, upstream checkpoint id and the reference dropdown names it
covers. The other families of the JAX catalog are not ported yet.
"""

from __future__ import annotations

import dataclasses

import torch

from ..device import DEFAULT_DEVICE
from . import configs
from .convert import load_hf_state_dict, load_safetensors
from .dpt import DepthAnything
from .model import DepthPredictor, build_random


@dataclasses.dataclass(frozen=True)
class ModelEntry:
    name: str
    family: str
    config: object | None
    hf_id: str | None
    reference_names: tuple = ()


PORTED_FAMILIES = ("dpt_dinov2",)

CATALOG: dict[str, ModelEntry] = {e.name: e for e in (
    ModelEntry("depth-anything-v2-small", "dpt_dinov2", configs.DA_V2_SMALL,
               "depth-anything/Depth-Anything-V2-Small-hf", ("Depth Anything V2 Small",)),
    ModelEntry("depth-anything-v2-base", "dpt_dinov2", configs.DA_V2_BASE,
               "depth-anything/Depth-Anything-V2-Base-hf", ("Depth Anything V2 Base",)),
    ModelEntry("depth-anything-v2-large", "dpt_dinov2", configs.DA_V2_LARGE,
               "depth-anything/Depth-Anything-V2-Large-hf", ("Depth Anything V2 Large",)),
    ModelEntry("depth-anything-v1-small", "dpt_dinov2", configs.DA_V2_SMALL,
               "LiheYoung/depth-anything-small-hf", ("Depth Anything V1 Small",)),
    ModelEntry("depth-anything-v1-base", "dpt_dinov2", configs.DA_V2_BASE,
               "LiheYoung/depth-anything-base-hf", ("Depth Anything V1 Base",)),
    # vitl14 is the pre-hf upload of the same ViT-L architecture
    ModelEntry("depth-anything-v1-large", "dpt_dinov2", configs.DA_V2_LARGE,
               "LiheYoung/depth-anything-large-hf", ("Depth Anything V1 Large", "vitl14")),
    # keetrap/* are re-uploads of the same checkpoints (render_depth.py:694-695)
    ModelEntry("distill-any-depth-small", "dpt_dinov2", configs.DA_V2_SMALL,
               "xingyang1/Distill-Any-Depth-Small-hf",
               ("Distil-Any-Depth-Small", "keetrap-Distil-Any-Depth-Small")),
    ModelEntry("distill-any-depth-large", "dpt_dinov2", configs.DA_V2_LARGE,
               "xingyang1/Distill-Any-Depth-Large-hf",
               ("Distil-Any-Depth-Large", "keetrap-Distil-Any-Depth-Large")),
    ModelEntry("depth-anything-v2-metric-indoor", "dpt_dinov2", configs.DA_V2_METRIC_INDOOR,
               "depth-anything/Depth-Anything-V2-Metric-Indoor-Large-hf",
               ("V2-Metric-Indoor-Large",)),
    ModelEntry("depth-anything-v2-metric-outdoor", "dpt_dinov2", configs.DA_V2_METRIC_OUTDOOR,
               "depth-anything/Depth-Anything-V2-Metric-Outdoor-Large-hf",
               ("V2-Metric-Outdoor-Large",)),
)}

# recommended square inference sizes per family (/14 patch)
_FAMILY_RESOLUTIONS = {"dpt_dinov2": (518, 392, 266, 700, 924)}


def inference_resolutions(name: str) -> tuple:
    """Recommended square inference sizes for a catalog entry."""
    return _FAMILY_RESOLUTIONS.get(CATALOG[name].family, (384,))


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
        raise KeyError(f"model {name!r} is not ported: the port has the "
                       f"{', '.join(PORTED_FAMILIES)} family ({', '.join(CATALOG)})")
    cfg = config if config is not None else CATALOG[name].config
    if checkpoint is None:
        model = build_random(cfg, seed, fast_head=fast_head)
    else:
        state = checkpoint if isinstance(checkpoint, dict) else load_safetensors(checkpoint)
        state = {k: v.to(torch.float32) for k, v in state.items()}
        model = load_hf_state_dict(DepthAnything(cfg, fast_head=fast_head), state)
    return DepthPredictor(model, inference_size, dtype=dtype, device=device)
