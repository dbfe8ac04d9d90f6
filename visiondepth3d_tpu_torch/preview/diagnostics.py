"""Single-frame diagnostic renders: the live-preview backend.

Counterpart of ``visiondepth3d_tpu/preview/diagnostics.py``. The
reference's preview window re-renders one frame through the real engine in
10 view modes (generate_preview_image, preview_utils.py:23-84; the window in
preview_gui.py). Here that is a function: one ``stereo_frame_step`` from
fresh trackers on one frame, then any diagnostic view of its output. On the
card the step runs the render's kernels (K1-K4, K6 with depth of field) in
the image type of ``params`` (float32 by default).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from ..device import DEFAULT_DEVICE, host_to_device, resolve_device
from ..ops.convert import float_to_u8_round
from ..ops.filters import grad_magnitude
from ..ops.formats import anaglyph_red_cyan, interlaced
from ..state import init_trackers
from ..stereo import StereoParams
from ..stereo.step import stereo_frame_step

PREVIEW_MODES = (
    "left",
    "right",
    "sbs",
    "anaglyph",
    "interlaced",
    "shift_heatmap",
    "lr_diff",
    "feather_mask",
    "depth",
    "overlay_arrows",
)


def _heatmap(x01: torch.Tensor) -> torch.Tensor:
    """Simple blue->red colormap for [H, W] data in [0, 1]."""
    r = torch.clamp(x01 * 2.0 - 1.0, 0.0, 1.0)
    b = torch.clamp(1.0 - x01 * 2.0, 0.0, 1.0)
    g = 1.0 - r - b
    return torch.stack([r, torch.clamp(g, 0.0, 1.0), b], dim=-1)


@torch.inference_mode()
def render_preview(frame01: np.ndarray, depth01: np.ndarray,
                   params: StereoParams | None = None, mode: str = "sbs",
                   device=DEFAULT_DEVICE) -> np.ndarray:
    """frame01: [H, W, 3] float RGB; depth01: [H, W]. Returns uint8 RGB
    [H, W', 3] on the host. ``device``: the CUDA card unless "cpu" is
    passed; without a card the default raises."""
    if mode not in PREVIEW_MODES:
        raise ValueError(f"unknown preview mode {mode!r}; one of {PREVIEW_MODES}")
    params = params or StereoParams()
    dev = resolve_device(device)
    frame = host_to_device(np.ascontiguousarray(frame01, np.float32), dev)
    depth = host_to_device(np.ascontiguousarray(depth01, np.float32), dev)
    h, w = frame.shape[:2]
    _, out = stereo_frame_step(params, init_trackers(h, w, device=dev), frame, depth)

    if mode == "left":
        img = out.left
    elif mode == "right":
        img = out.right
    elif mode == "sbs":
        img = torch.cat([out.left, out.right], dim=1)
    elif mode == "anaglyph":
        img = anaglyph_red_cyan(out.left, out.right)
    elif mode == "interlaced":
        img = interlaced(out.left, out.right)
    elif mode == "shift_heatmap":
        s = out.shift_map
        lo, hi = torch.min(s), torch.max(s)
        img = _heatmap((s - lo) / torch.clamp(hi - lo, min=1e-9))
    elif mode == "lr_diff":
        d = torch.mean(torch.abs(out.left - out.right), dim=-1)
        img = _heatmap(torch.clamp(d * 4.0, 0.0, 1.0))
    elif mode == "feather_mask":
        mask = torch.clamp(grad_magnitude(depth) * params.feather_strength, 0.0, 1.0)
        img = torch.stack([mask] * 3, dim=-1)
    elif mode == "depth":
        img = torch.stack([depth] * 3, dim=-1)
    else:  # overlay_arrows: brighten pixels by their signed shift
        s = out.shift_map
        peak = torch.clamp(torch.max(torch.abs(s)), min=1e-9)
        pos = torch.clamp(s, min=0.0) / peak
        neg = torch.clamp(-s, min=0.0) / peak
        base = out.left
        img = torch.stack([torch.clamp(base[..., 0] + pos, 0.0, 1.0), base[..., 1],
                           torch.clamp(base[..., 2] + neg, 0.0, 1.0)], dim=-1)
    return float_to_u8_round(img).cpu().numpy()


def save_preview_set(frame01, depth01, out_dir, params=None, mode="sbs",
                     device=DEFAULT_DEVICE):
    """Save the preview, input and depth PNG triplet (preview_gui.py:424-445
    analog) through Pillow; returns the folder."""
    from PIL import Image

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    prev = render_preview(frame01, depth01, params, mode, device)
    Image.fromarray(prev).save(out_dir / f"preview_{mode}.png")
    Image.fromarray((np.asarray(frame01) * 255).astype(np.uint8)).save(
        out_dir / "preview_input.png")
    d8 = (np.asarray(depth01) * 255).astype(np.uint8)
    Image.fromarray(np.stack([d8] * 3, axis=-1)).save(out_dir / "preview_depth.png")
    return out_dir
