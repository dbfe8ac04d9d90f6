"""Depth model catalog of the port: the feed-forward families that fit the
plain predictor.

Counterpart of ``visiondepth3d_tpu/depth/registry.py``, each entry with its
family, config, upstream checkpoint id and the reference dropdown names it
covers:
- ``dpt_dinov2``: Depth Anything V1/V2 Small/Base/Large, Distill-Any-Depth
  Small/Large and the two metric Depth Anything V2 models;
- ``dpt_classic``: DPT-Large (Intel/dpt-large);
- ``dpt_beit``: DPT-BEiT-Large-512 (MiDaS v3.1);
- ``dpt_hybrid``: DPT-Hybrid (MiDaS 3.0);
- ``zoedepth`` / ``zoedepth_nk``: ZoeDepth NYU and NYU+KITTI (metric);
- ``dpt_vit``: MiDaS v2.1-small (the JAX catalog's family name);
- ``depth_pro``: Apple Depth Pro (at the published widths: the JAX
  catalog's config holds ViT-S/14 encoders, ROADMAP Queue 3 F10);
- ``vda``: Video Depth Anything Small (a windowed video predictor);
- ``diffusion``: Marigold and DepthCrafter (diffusion pipelines).
Besides the catalog, ``load_predictor`` takes ``onnx:<path>`` (any ONNX
depth graph, through ``onnx_exec.py``) and ``local:<dir>``: a folder
holding a raw ``model.onnx``, or a ``vd3d.json`` naming the catalog entry
whose architecture its ``.safetensors`` holds, in the upstream names
(``format: "hf"``) or as a flat "a/b/c"-keyed JAX params tree
(``format: "native"``, the default), which goes through the family's
``from_jax_params*``. ``save_local_params`` writes such a native folder
(``vd3d-torch convert``), and ``discover_local_models`` lists the folders
of a weights directory.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os

import torch

from ..device import DEFAULT_DEVICE, resolve_device
from ..utils.observability import span
from . import configs
from .convert import load_hf_state_dict, load_safetensors
from .depth_pro import DepthProConfig
from .dpt import DepthAnything
from .dpt_beit import DPT_BEIT_LARGE_512
from .dpt_classic import DPT_LARGE
from .dpt_hybrid import DPT_HYBRID
from .midas_v2 import MIDAS_V2_SMALL
from .model import (STANDARD_MEAN, STANDARD_STD, DepthPredictor, build_random_model,
                    init_random_, init_random_fan_in_)
from .vda import VDAConfig
from .zoedepth import ZoeDepthConfig, ZoeDepthNKConfig


@dataclasses.dataclass(frozen=True)
class ModelEntry:
    name: str
    family: str
    config: object | None
    hf_id: str | None
    reference_names: tuple = ()


PORTED_FAMILIES = ("dpt_dinov2", "dpt_classic", "dpt_beit", "zoedepth", "zoedepth_nk",
                   "dpt_hybrid", "dpt_vit", "depth_pro", "vda", "diffusion")

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
    # Manojb/dpt-large is a mirror of Intel/dpt-large
    ModelEntry("dpt-large", "dpt_classic", DPT_LARGE, "Intel/dpt-large",
               ("DPT-Large", "Manojb - DPT-Large")),
    ModelEntry("dpt-beit-large-512", "dpt_beit", DPT_BEIT_LARGE_512,
               "Intel/dpt-beit-large-512", ("dpt-beit-large-512",)),
    ModelEntry("zoedepth-nyu", "zoedepth", ZoeDepthConfig(), "Intel/zoedepth-nyu",
               ("ZoeDepth",)),
    ModelEntry("zoedepth-nyu-kitti", "zoedepth_nk", ZoeDepthNKConfig(),
               "Intel/zoedepth-nyu-kitti", ("ZoeDepth",)),
    ModelEntry("midas-v3-hybrid", "dpt_hybrid", DPT_HYBRID, "Intel/dpt-hybrid-midas",
               ("DPT-Hybrid (MiDaS 3.0)",)),
    ModelEntry("midas-v2", "dpt_vit", MIDAS_V2_SMALL, "qualcomm/Midas-V2", ("Midas-V2",)),
    ModelEntry("depth-pro", "depth_pro", DepthProConfig(), "apple/DepthPro-hf", ("DepthPro",)),
    ModelEntry("video-depth-anything", "vda", VDAConfig(),
               "depth-anything/Video-Depth-Anything-Small", ("Video Depth Anything (ONNX)",)),
    ModelEntry("marigold", "diffusion", None, "prs-eth/marigold-depth-v1-0",
               ("Marigold Depth (Diffusers)", "marigold-depth-v1-0", "marigold-depth-v1-1")),
    ModelEntry("depthcrafter", "diffusion", None, "tencent/DepthCrafter",
               ("DepthCrafter (Video Diffusion)",)),
)}

# recommended square inference sizes per family; the first is the default
_FAMILY_RESOLUTIONS = {
    "dpt_dinov2": (518, 392, 266, 700, 924),  # /14 patch
    "dpt_classic": (384, 256, 512),  # /16 patch
    "dpt_beit": (512, 384, 256),
    "dpt_hybrid": (384, 256, 512),
    "zoedepth": (384, 512),
    "zoedepth_nk": (384, 512),
    "dpt_vit": (384, 256),  # snapped to 32
    "depth_pro": (1536, 768),  # 384 * 2^k; 768 runs at 1536 (depth_pro_size)
    "diffusion": (576, 480, 768),
    "vda": (518, 392),
}


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


def _family_model(family: str, cfg, fast_head: bool):
    """(model, unused HF keys, predictor options) of a family."""
    if family == "dpt_dinov2":
        from .convert import UNUSED_HF_KEYS

        return DepthAnything(cfg, fast_head=fast_head), UNUSED_HF_KEYS, {}
    if family == "dpt_classic":
        from .dpt_classic import UNUSED_HF_KEYS, DPTClassic

        return DPTClassic(cfg, fast_head=fast_head), UNUSED_HF_KEYS, {}
    if family == "dpt_beit":
        from .dpt_beit import UNUSED_HF_KEYS, DPTBEiT

        return DPTBEiT(cfg, fast_head=fast_head), UNUSED_HF_KEYS, {}
    if family == "dpt_hybrid":
        from .dpt_hybrid import UNUSED_HF_KEYS, DPTHybrid

        return DPTHybrid(cfg, fast_head=fast_head), UNUSED_HF_KEYS, {}
    if family in ("zoedepth", "zoedepth_nk"):
        from .zoedepth import UNUSED_HF_KEYS, ZoeDepth, ZoeDepthNK

        nk = family == "zoedepth_nk"
        return ((ZoeDepthNK if nk else ZoeDepth)(cfg), UNUSED_HF_KEYS,
                dict(mean=STANDARD_MEAN, std=STANDARD_STD, select=0 if nk else None))
    if family == "dpt_vit":
        from .midas_v2 import MidasNetSmall

        return MidasNetSmall(cfg), (), dict(snap_multiple=32)
    raise NotImplementedError(f"family {family} is not ported")


def _square(name: str, inference_size) -> int:
    """A square inference size as an int; the windowed and pyramid families
    refuse rectangles."""
    if isinstance(inference_size, (tuple, list)):
        if inference_size[0] != inference_size[1]:
            raise ValueError(f"{name} runs at a square size; pass an int inference size")
        return int(inference_size[0])
    return int(inference_size)


def depth_pro_size(cfg, size: int) -> int:
    """Depth Pro's input size: image_size * 2^k with k the power nearest
    ``size`` (as the JAX registry picks it), but never so small that the
    smallest scale holds no window (ROADMAP Queue 3, F13): 1536 at the
    published config."""
    base = cfg.image_model.image_size
    k_min = max(0, math.ceil(math.log2(cfg.patch_size / (base * min(cfg.scaled_images_ratios)))))
    return base * 2 ** max(k_min, round(math.log2(max(size, base) / base)))


def resolve_local_model(path: str) -> ModelEntry:
    """A local folder's catalog entry: its ``vd3d.json`` names the entry
    (``base``) whose architecture the folder's weights hold."""
    meta_path = os.path.join(path, "vd3d.json")
    if not os.path.isdir(path) or not os.path.exists(meta_path):
        raise FileNotFoundError(f"local model dir {path!r} needs a vd3d.json ({{'family': ..., "
                                f"'base': <catalog name>}}) with converted .safetensors, or a "
                                f"raw model.onnx (runs through the ONNX interpreter)")
    with open(meta_path) as f:
        base = json.load(f)["base"]
    if base not in CATALOG:
        raise KeyError(f"local model {path!r}: base {base!r} is not ported: the port has the "
                       f"{', '.join(PORTED_FAMILIES)} families")
    return dataclasses.replace(CATALOG[base], name=f"local:{path}")


def load_local_params(root: str):
    """A local folder's weights and whether they are native: the
    ``.safetensors`` path for ``format: "hf"`` (the family's loader reads
    the upstream names), else the JAX params tree its flat "a/b/c" keys
    spell (numpy leaves)."""
    with open(os.path.join(root, "vd3d.json")) as f:
        meta = json.load(f)
    path = next((os.path.join(root, fn) for fn in ("model.safetensors",
                                                   "diffusion_pytorch_model.safetensors")
                 if os.path.exists(os.path.join(root, fn))), None)
    if path is None:
        raise FileNotFoundError(f"{root}: no .safetensors weights found")
    if meta.get("format", "native") != "native":
        return path, False
    tree: dict = {}
    for key, val in load_safetensors(path).items():
        node = tree
        *parents, leaf = key.split("/")
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = val.float().numpy()
    return tree, True


def discover_local_models(root: str) -> dict[str, ModelEntry]:
    """The loadable model folders of a weights directory, keyed
    ``"[Local] <folder>"`` as the reference's dropdown lists them."""
    found = {}
    if not os.path.isdir(root):
        return found
    for folder in sorted(os.listdir(root)):
        try:
            found[f"[Local] {folder}"] = resolve_local_model(os.path.join(root, folder))
        except (FileNotFoundError, KeyError):
            continue
    return found


def save_local_params(root: str, base_name: str, params: dict) -> str:
    """Write a JAX-layout params tree (``convert.to_jax_params``) as a
    ``local:`` folder: flat "a/b/c"-keyed float32 ``model.safetensors`` and a
    ``vd3d.json`` naming the catalog entry whose architecture it holds, the
    layout of the JAX package's ``save_local_params``, so either package
    loads the folder the other wrote."""
    from .convert import save_safetensors

    if base_name not in CATALOG:
        raise KeyError(f"{base_name!r}: not a catalog entry")
    os.makedirs(root, exist_ok=True)
    flat: dict = {}

    def walk(node, prefix):
        for k, v in node.items():
            key = f"{prefix}/{k}" if prefix else k
            if isinstance(v, dict):
                walk(v, key)
            else:
                flat[key] = v

    walk(params, "")
    save_safetensors(os.path.join(root, "model.safetensors"), flat)
    with open(os.path.join(root, "vd3d.json"), "w") as f:
        json.dump({"base": base_name, "format": "native"}, f, indent=2)
    return root


def _onnx_predictor(path: str, inference_size, device):
    from .onnx_exec import OnnxDepthPredictor

    return OnnxDepthPredictor(path, _square(f"onnx:{path}", inference_size), device=device)


def load_predictor(name: str, checkpoint=None, inference_size: int | tuple = 518,
                   seed: int = 0, dtype: str = "float32", config=None,
                   device=DEFAULT_DEVICE, fast_head: bool = False, **diffusion_kw):
    """A predictor for a catalog entry on ``device`` (the CUDA card unless
    the caller passes "cpu"; without a card the default raises before any
    model is built): a ``DepthPredictor`` for the feed-forward families, a
    ``VDAPredictor`` (windowed video) for ``vda``, a ``MarigoldPipeline`` or
    a ``DepthCrafterPipeline`` for ``diffusion``, an ``OnnxDepthPredictor``
    for ``onnx:<path>`` and for a ``local:<dir>`` holding a raw
    ``model.onnx`` (square sizes, float32). A ``local:`` folder with a
    ``vd3d.json`` loads its base entry's family from its weights.

    checkpoint: the upstream weights (HF ``.safetensors``; for MiDaS v2 the
    isl-org ``.pt``, ``.safetensors`` or ``.onnx``; for VDA the upstream
    ``.pth``, ``.safetensors`` or ``.onnx``; for Marigold and DepthCrafter a
    diffusers checkpoint directory), a state dict with the upstream keys, or None for
    seeded random weights (shape and speed testing only). ``fast_head``
    goes to the DPT families that take it (Depth Anything, DPT-Large,
    DPT-BEiT, DPT-Hybrid). Depth Pro runs at ``depth_pro_size`` (square
    only). ``diffusion_kw``: ``steps``, ``window``, ``overlap``,
    ``ensemble``, ``allow_random`` of ``load_diffusion_pipeline``.
    config: overrides the catalog config (tiny configs in tests).
    """
    with span("load"):
        return _load_predictor(name, checkpoint, inference_size, seed, dtype, config, device,
                               fast_head, diffusion_kw)


def _load_predictor(name, checkpoint, inference_size, seed, dtype, config, device, fast_head,
                    diffusion_kw):
    if name.startswith("onnx:"):
        return _onnx_predictor(name[len("onnx:"):], inference_size, device)
    native = False
    if name.startswith("local:"):
        root = name[len("local:"):]
        onnx_path = root if root.endswith(".onnx") else os.path.join(root, "model.onnx")
        if not os.path.exists(os.path.join(root, "vd3d.json")) and os.path.exists(onnx_path):
            return _onnx_predictor(onnx_path, inference_size, device)
        entry = resolve_local_model(root)
        if checkpoint is None:
            checkpoint, native = load_local_params(root)
    elif name not in CATALOG:
        raise KeyError(f"model {name!r} is not ported: the port has the "
                       f"{', '.join(PORTED_FAMILIES)} families ({', '.join(CATALOG)})")
    else:
        entry = CATALOG[name]
    resolve_device(device)
    cfg = config if config is not None else entry.config
    if native:
        from . import convert

        if entry.family not in convert.JAX_FAMILIES:
            raise NotImplementedError(
                f"{name}: a native (JAX params) folder of the {entry.family} family has no "
                f"converter; the families that have one: {', '.join(convert.JAX_FAMILIES)}")
        if entry.family == "depth_pro":  # the encoders' widths are the tree's
            cfg = convert.depth_pro_config_from_jax(checkpoint, cfg)
        checkpoint = convert.from_jax_tree(entry.family, checkpoint, cfg)
    if entry.family == "diffusion":
        from .diffusion import load_diffusion_pipeline

        return load_diffusion_pipeline(name, checkpoint, dtype=dtype, device=device,
                                       **diffusion_kw)
    if diffusion_kw:
        raise TypeError(f"{name}: unexpected arguments {sorted(diffusion_kw)}")
    if entry.family == "vda":
        from .vda import VDAPredictor, VideoDepthAnything, convert_vda

        _square(name, inference_size)
        model = VideoDepthAnything(cfg)
        if checkpoint is None:
            build_random_model(model, seed)
        else:
            load_hf_state_dict(model, checkpoint if native else convert_vda(checkpoint, cfg), ())
        return VDAPredictor(model, dtype=dtype, device=device)
    if entry.family == "depth_pro":
        from .depth_pro import UNUSED_HF_KEYS, DepthPro

        s = depth_pro_size(cfg, _square(name, inference_size))
        with torch.device("meta"):  # every parameter is loaded or drawn below
            model = DepthPro(cfg).to_empty(device="cpu")
        unused = UNUSED_HF_KEYS
        options = dict(mean=STANDARD_MEAN, std=STANDARD_STD, select=0, snap_multiple=s)
        inference_size = s
    else:
        model, unused, options = _family_model(entry.family, cfg, fast_head)
    if checkpoint is None:
        build_random_model(model, seed, init_random_fan_in_ if entry.family == "depth_pro"
                           else init_random_)
    elif entry.family == "dpt_vit" and not native:
        from .midas_v2 import convert_midas_small

        load_hf_state_dict(model, convert_midas_small(checkpoint, cfg), unused)
    else:
        state = checkpoint if isinstance(checkpoint, dict) else load_safetensors(checkpoint)
        load_hf_state_dict(model, {k: v.to(torch.float32) for k, v in state.items()}, unused)
    return DepthPredictor(model, inference_size, dtype=dtype, device=device, **options)
