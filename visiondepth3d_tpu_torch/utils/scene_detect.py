"""Content-based scene detection.

The port's copy of ``visiondepth3d_tpu/utils/scene_detect.py`` (numpy
only). The reference uses PySceneDetect's ContentDetector over HSV deltas
(VisionDepth3D.py:1187-1247, run_scene_detect) to split a video into scenes
and re-encode each span. Equivalent detector here: per-frame content score =
mean absolute HSV delta (weighted like ContentDetector's default
delta_hue/sat/luma = 1.0 each), a cut when the score exceeds ``threshold``
(PySceneDetect default 27) with a minimum scene length.
"""

from __future__ import annotations

import numpy as np


def rgb_to_hsv_np(frame_rgb: np.ndarray) -> np.ndarray:
    """uint8 RGB -> float32 HSV with cv2-like ranges (H 0..180, S/V 0..255)."""
    rgb = frame_rgb.astype(np.float32) / 255.0
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    mx = np.max(rgb, axis=-1)
    mn = np.min(rgb, axis=-1)
    diff = mx - mn
    h = np.zeros_like(mx)
    mask = diff > 1e-9
    rm = mask & (mx == r)
    gm = mask & (mx == g) & ~rm
    bm = mask & ~rm & ~gm
    h[rm] = (60.0 * (g[rm] - b[rm]) / diff[rm]) % 360.0
    h[gm] = 60.0 * (b[gm] - r[gm]) / diff[gm] + 120.0
    h[bm] = 60.0 * (r[bm] - g[bm]) / diff[bm] + 240.0
    s = np.where(mx > 0, diff / np.maximum(mx, 1e-9), 0.0)
    return np.stack([h / 2.0, s * 255.0, mx * 255.0], axis=-1)


def content_score(prev_hsv: np.ndarray, hsv: np.ndarray) -> float:
    """Mean absolute per-channel HSV delta, averaged over channels."""
    delta = np.abs(hsv - prev_hsv)
    # hue wraps at 180
    dh = np.minimum(delta[..., 0], 180.0 - delta[..., 0])
    return float((dh.mean() + delta[..., 1].mean() + delta[..., 2].mean()) / 3.0)


def detect_scenes(frames, threshold: float = 27.0, min_scene_len: int = 15):
    """Iterate frames (uint8 RGB) -> list of scene start indices (always
    includes 0). Frames may be any iterable; memory use is O(1)."""
    cuts = [0]
    prev_hsv = None
    last_cut = 0
    for i, frame in enumerate(frames):
        hsv = rgb_to_hsv_np(frame)
        if prev_hsv is not None:
            score = content_score(prev_hsv, hsv)
            if score >= threshold and (i - last_cut) >= min_scene_len:
                cuts.append(i)
                last_cut = i
        prev_hsv = hsv
    return cuts


def scenes_to_spans(cuts: list[int], total: int) -> list[tuple[int, int]]:
    ends = cuts[1:] + [total]
    return [(s, e) for s, e in zip(cuts, ends) if e > s]
