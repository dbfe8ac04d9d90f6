"""Settings persistence (the reference's settings.json auto save/load,
VisionDepth3D.py:143-160, 3062-3129).

The port's copy of ``visiondepth3d_tpu/config/settings.py`` over its own
``presets.py``: a flat JSON of the canonical parameter names plus app
state (language, last paths). The schema is ``params_to_dict``'s, which
each package reads from the other's files (``presets.py``), so a
``settings.json`` written by either package loads in the other.
"""

from __future__ import annotations

import json
from pathlib import Path

from .presets import params_from_dict, params_to_dict

DEFAULT_PATH = Path.home() / ".vd3d" / "settings.json"
_EXTRAS = ("language", "last_input", "last_depth", "last_output")


def load_settings(path: Path | str = DEFAULT_PATH):
    """(StereoParams, RenderConfig, extras dict), or the defaults."""
    path = Path(path)
    if not path.exists():
        from ..pipeline.stereo_pipeline import RenderConfig
        from ..stereo import StereoParams

        return StereoParams(), RenderConfig(), {}
    data = json.loads(path.read_text())
    params, cfg = params_from_dict(data)
    return params, cfg, {k: v for k, v in data.items() if k in _EXTRAS}


def save_settings(params, cfg=None, extras: dict | None = None,
                  path: Path | str = DEFAULT_PATH) -> None:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    data = params_to_dict(params, cfg)
    if extras:
        data.update(extras)
    path.write_text(json.dumps(data, indent=2))
