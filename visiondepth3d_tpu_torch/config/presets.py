"""Preset and settings persistence.

The port's copy of ``visiondepth3d_tpu/config/presets.py`` over its own
``StereoParams`` and ``RenderConfig``. Presets are JSON dicts of the
canonical parameter names; loading clamps values to the GUI's slider
ranges, fills missing keys with defaults and drops keys that are not
fields. So the two packages read each other's files: the port's own fields
(``dof_backend``, ``device``) are dropped by the JAX package, the JAX
package's (``device_yuv``, ``mesh_snap_scenes``, ...) by the port, and the
JAX package's backend names "pallas" and "xla" load as the port's "cuda"
and "torch".
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

from ..pipeline.stereo_pipeline import RenderConfig
from ..stereo import StereoParams

# clamp ranges for preset sanitization (GUI slider bounds)
_CLAMPS = {
    "fg_shift": (0.0, 30.0),
    "mg_shift": (-10.0, 10.0),
    "bg_shift": (-20.0, 0.0),
    "sharpness_factor": (-1.0, 1.0),
    "feather_strength": (0.0, 20.0),
    "max_pixel_shift_percent": (0.005, 0.20),
    "parallax_balance": (0.1, 1.0),
    "zero_parallax_strength": (-0.05, 0.05),
    "convergence_strength": (-0.05, 0.05),
    "ipd_factor": (0.0, 1.5),
    "depth_pop_gamma": (0.6, 1.2),
    "depth_pop_mid": (0.2, 0.8),
    "depth_stretch_lo": (0.0, 0.3),
    "depth_stretch_hi": (0.7, 1.0),
    "fg_pop_multiplier": (1.0, 1.6),
    "bg_push_multiplier": (1.0, 1.6),
    "subject_lock_strength": (0.0, 1.5),
    "color_saturation": (0.0, 2.0),
    "color_contrast": (0.5, 1.5),
    "color_brightness": (-0.5, 0.5),
    "heal_strength": (0.0, 1.0),
    "dof_strength": (0.0, 5.0),
    "blur_ksize": (1, 15),
}

_PARAM_FIELDS = {f.name for f in dataclasses.fields(StereoParams)}
_RENDER_FIELDS = {f.name for f in dataclasses.fields(RenderConfig)}
# the JAX package's backend names -> the port's
_BACKEND_NAMES = {"pallas": "cuda", "xla": "torch"}


def _clamp(name, value):
    if name in _CLAMPS and isinstance(value, (int, float)):
        lo, hi = _CLAMPS[name]
        return min(max(value, lo), hi)
    return value


# params_to_dict floats every scalar; bool and int fields come back as such
_FIELD_TYPES = {
    f.name: type(f.default)
    for f in dataclasses.fields(StereoParams)
    if isinstance(f.default, (bool, int)) and f.default is not None
}


def _coerce(name, value):
    t = _FIELD_TYPES.get(name)
    if t is bool:
        return bool(value)
    if t is int and isinstance(value, (bool, int, float)):
        return int(value)
    if name in ("warp_backend", "postfx_backend"):
        return _BACKEND_NAMES.get(value, value)
    return value


def params_from_dict(d: dict) -> tuple[StereoParams, RenderConfig]:
    pkw = {k: _coerce(k, _clamp(k, v)) for k, v in d.items() if k in _PARAM_FIELDS}
    rkw = {k: v for k, v in d.items() if k in _RENDER_FIELDS}
    if "warp_hw" in pkw and pkw["warp_hw"] is not None:
        pkw["warp_hw"] = tuple(int(x) for x in pkw["warp_hw"])
    return StereoParams(**pkw), RenderConfig(**rkw)


def params_to_dict(p: StereoParams, cfg: RenderConfig | None = None) -> dict:
    out = {}
    for f in dataclasses.fields(StereoParams):
        v = getattr(p, f.name)
        try:
            v = float(v)
        except (TypeError, ValueError):
            pass
        out[f.name] = v
    if cfg is not None:
        out.update(dataclasses.asdict(cfg))
    return out


def load_preset(path) -> tuple[StereoParams, RenderConfig]:
    return params_from_dict(json.loads(Path(path).read_text()))


def save_preset(path, p: StereoParams, cfg: RenderConfig | None = None) -> None:
    Path(path).write_text(json.dumps(params_to_dict(p, cfg), indent=2))


# the presets shipped with the reference, by value
BUILTIN_PRESETS: dict[str, dict] = {
    "best3d": dict(
        fg_shift=12.0, mg_shift=-4.0, bg_shift=-8.0, feather_strength=12.0,
        blur_ksize=9, max_pixel_shift_percent=0.025, parallax_balance=0.85,
        use_subject_tracking=True, enable_floating_window=True,
        depth_pop_gamma=0.85, fg_pop_multiplier=1.2, bg_push_multiplier=1.1,
    ),
    "balanced_depth": dict(
        fg_shift=8.0, mg_shift=-3.0, bg_shift=-6.0, feather_strength=10.0,
        blur_ksize=7, max_pixel_shift_percent=0.02, parallax_balance=0.8,
    ),
}


def load_builtin(name: str) -> tuple[StereoParams, RenderConfig]:
    return params_from_dict(BUILTIN_PRESETS[name])
