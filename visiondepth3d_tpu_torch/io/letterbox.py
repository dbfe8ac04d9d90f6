"""Letterbox (black bar) detection subsystem: the port's copy of
``visiondepth3d_tpu/io/letterbox.py`` (pure numpy; copied, not imported,
so the port loads nothing of the JAX package).

Behavioral port of the reference's robust letterbox stack
(render_depth.py:271-583): per-row luma/variance/saturation/edge-density
gates, scene-cut + near-black guards, multi-frame median bootstrap with
confidence, and the runtime ``LetterboxTracker`` state machine with
hysteresis (min_change 8 px, confirm 3, cooldown 3 s) that re-checks only at
scene cuts.

Host-side numpy (this runs on decoded frames before batching to the
device). One deviation: the reference's Canny edge-density gate
(render_depth.py:330-334) is a Sobel-magnitude threshold here — no OpenCV
in the runtime; for the purpose (uniform bar rows have ~zero edges) the
gates are interchangeable.

Frames here are RGB uint8 (the framework decodes to RGB; the reference's
BGR order only mattered for its cv2 calls).
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np


def luma_saturation(frame_rgb: np.ndarray):
    """(Y, S) float32 in 0..255 — Rec.709 luma + HSV saturation."""
    r = frame_rgb[..., 0].astype(np.float32)
    g = frame_rgb[..., 1].astype(np.float32)
    b = frame_rgb[..., 2].astype(np.float32)
    y = 0.2126 * r + 0.7152 * g + 0.0722 * b
    mx = np.maximum(np.maximum(r, g), b)
    mn = np.minimum(np.minimum(r, g), b)
    s = np.where(mx > 0, (mx - mn) / np.maximum(mx, 1e-6) * 255.0, 0.0)
    return y, s.astype(np.float32)


def to_gray(frame_rgb: np.ndarray) -> np.ndarray:
    return (
        0.299 * frame_rgb[..., 0].astype(np.float32)
        + 0.587 * frame_rgb[..., 1].astype(np.float32)
        + 0.114 * frame_rgb[..., 2].astype(np.float32)
    )


def is_scene_cut(prev_gray, gray, mad_thresh: float = 28.0,
                 corr_thresh: float = 0.60) -> bool:
    """MAD > 28 or 64-bin histogram Pearson correlation < 0.6."""
    if prev_gray is None or gray is None:
        return False
    if prev_gray.shape != gray.shape:
        return True
    mad = float(np.mean(np.abs(prev_gray - gray)))
    if mad > mad_thresh:
        return True
    h1, _ = np.histogram(prev_gray, bins=64, range=(0, 256))
    h2, _ = np.histogram(gray, bins=64, range=(0, 256))
    h1 = h1.astype(np.float64)
    h2 = h2.astype(np.float64)
    d1, d2 = h1 - h1.mean(), h2 - h2.mean()
    denom = np.sqrt((d1 * d1).sum() * (d2 * d2).sum())
    corr = float((d1 * d2).sum() / denom) if denom > 0 else 1.0
    return corr < corr_thresh


def _row_edge_density(gray: np.ndarray, mag_thresh: float = 60.0) -> np.ndarray:
    """Fraction of strong-gradient pixels per row (Canny-gate stand-in)."""
    gx = np.zeros_like(gray)
    gy = np.zeros_like(gray)
    gx[:, 1:-1] = gray[:, 2:] - gray[:, :-2]
    gy[1:-1, :] = gray[2:, :] - gray[:-2, :]
    mag = np.hypot(gx, gy)
    return (mag > mag_thresh).mean(axis=1)


def detect_letterbox_single(
    frame_rgb: np.ndarray,
    y_thresh=16.0,
    var_thresh=3.0,
    sat_thresh=6.0,
    max_scan_frac=0.25,
    min_band_frac=0.06,
    edge_max=0.04,
) -> tuple[int, int]:
    """Single-frame (top, bottom) bar guess (detect_letterbox_strict_robust
    parity: all four row gates, min band 6%, even-px snap, 60% sanity cap)."""
    h, w = frame_rgb.shape[:2]
    if h < 64 or w < 64:
        return 0, 0
    y, s = luma_saturation(frame_rgb)
    y_mean, y_var = y.mean(axis=1), y.var(axis=1)
    s_mean = s.mean(axis=1)
    row_edge = _row_edge_density(to_gray(frame_rgb))

    ok = (
        (y_mean < y_thresh)
        & (y_var < var_thresh)
        & (s_mean < sat_thresh)
        & (row_edge <= edge_max)
    )

    def scan(indices):
        limit = int(h * max_scan_frac)
        run = 0
        for i in indices[:limit]:
            if ok[i]:
                run += 1
            else:
                break
        if run < int(h * min_band_frac):
            run = 0
        if run % 2 == 1:
            run -= 1
        return max(run, 0)

    top = scan(list(range(h)))
    bot = scan(list(range(h - 1, -1, -1)))
    if top + bot >= h * 0.6:
        return 0, 0
    return int(top), int(bot)


def is_near_black_frame(frame_rgb, mean_thresh=18.0, edge_thresh=0.02) -> bool:
    y, _ = luma_saturation(frame_rgb)
    edge = _row_edge_density(to_gray(frame_rgb)).mean()
    return float(y.mean()) < mean_thresh and edge < edge_thresh


def detect_letterbox_multiframe(frames, original_height: int):
    """((top, bottom), confidence) over a list of probe frames — median of
    single-frame guesses, skipping blacks & cuts (render_depth.py:394-455)."""
    tops, bottoms = [], []
    prev_gray = None
    for frame in frames:
        gray = to_gray(frame)
        if is_near_black_frame(frame) or is_scene_cut(prev_gray, gray):
            prev_gray = gray
            continue
        t, b = detect_letterbox_single(frame)
        if 0 <= t < original_height and 0 <= b < original_height and (
            t + b
        ) < original_height:
            tops.append(t)
            bottoms.append(b)
        prev_gray = gray
    if not tops:
        return (0, 0), 0.0
    t_med, b_med = int(np.median(tops)), int(np.median(bottoms))
    if t_med % 2:
        t_med -= 1
    if b_med % 2:
        b_med -= 1
    t_med, b_med = max(t_med, 0), max(b_med, 0)
    if t_med + b_med >= original_height * 0.6:
        return (0, 0), 0.0
    agree = sum(
        1 for t, b in zip(tops, bottoms) if abs(t - t_med) <= 4 and abs(b - b_med) <= 4
    )
    return (t_med, b_med), agree / max(1, len(tops))


class LetterboxTracker:
    """Runtime bar tracker with locks & hysteresis (render_depth.py:458-573).

    Defaults: min_change 8 px, confirm 3 consecutive candidates, total bars
    capped at 35% of height, enable at >=70% bootstrap confidence, 3 s
    cooldown between re-locks; re-checks happen only at scene cuts on
    non-black frames.
    """

    def __init__(self, h, fps, min_change=8, confirm_needed=3,
                 max_total_frac=0.35, conf_enable=0.7, conf_disable=0.6,
                 cooldown_sec=3.0):
        self.h = int(h)
        self.fps = float(fps) if fps and fps > 0 else 30.0
        self.min_change = int(min_change)
        self.confirm_needed = int(confirm_needed)
        self.max_total_frac = float(max_total_frac)
        self.conf_enable = float(conf_enable)
        self.conf_disable = float(conf_disable)
        self.cooldown_frames = int(self.fps * cooldown_sec)
        self.top = 0
        self.bot = 0
        self.locked_zero = True
        self.locked_bars = False
        self._cand = (0, 0)
        self._streak = 0
        self._cooldown = 0
        self.prev_gray = None

    def bootstrap(self, probe_frames):
        (t, b), conf = detect_letterbox_multiframe(probe_frames, self.h)
        if conf >= self.conf_enable and (t + b) > 0:
            self.top, self.bot = t, b
            self.locked_bars, self.locked_zero = True, False
        else:
            self.top, self.bot = 0, 0
            self.locked_bars, self.locked_zero = False, True
        self._cooldown = self.cooldown_frames
        return self.top, self.bot, (self.locked_bars, self.locked_zero)

    def update(self, frame_rgb, frame_idx=0):
        if self._cooldown > 0:
            self._cooldown -= 1
        if is_near_black_frame(frame_rgb):
            self.prev_gray = to_gray(frame_rgb)
            return self.top, self.bot
        gray = to_gray(frame_rgb)
        if not is_scene_cut(self.prev_gray, gray):
            self.prev_gray = gray
            return self.top, self.bot
        self.prev_gray = gray
        if self._cooldown > 0:
            return self.top, self.bot

        mt, mb = detect_letterbox_single(frame_rgb)
        if (mt + mb) > int(self.h * self.max_total_frac):
            mt, mb = 0, 0
        if mt % 2:
            mt -= 1
        if mb % 2:
            mb -= 1
        mt, mb = max(mt, 0), max(mb, 0)

        change = abs(mt - self.top) + abs(mb - self.bot)
        if change < self.min_change:
            self._streak = 0
            self._cand = (self.top, self.bot)
            return self.top, self.bot
        cand = (mt, mb)
        if cand == self._cand:
            self._streak += 1
        else:
            self._cand = cand
            self._streak = 1
        if self._streak >= self.confirm_needed:
            if self.locked_zero and (mt + mb) > 0:
                self.top, self.bot = mt, mb
                self.locked_zero, self.locked_bars = False, True
                self._cooldown = self.cooldown_frames
            elif self.locked_bars:
                self.top, self.bot = mt, mb
                self.locked_zero = (mt + mb) == 0
                self.locked_bars = (mt + mb) > 0
                self._cooldown = self.cooldown_frames
        return self.top, self.bot


def crop_by_bars(frame, top: int, bottom: int):
    h = frame.shape[0]
    top, bottom = max(int(top), 0), max(int(bottom), 0)
    if top + bottom >= h or h <= 0:
        return frame
    return frame[top : h - bottom]


def reinsert_bars(depth_u8: np.ndarray, top: int, bottom: int,
                  fill: int = 128) -> np.ndarray:
    """Neutral-fill bar reinsertion into output depth
    (render_depth.py:1920-1933 analog)."""
    if top <= 0 and bottom <= 0:
        return depth_u8
    h, w = depth_u8.shape[:2]
    out = np.full((h + top + bottom, w) + depth_u8.shape[2:], fill,
                  dtype=depth_u8.dtype)
    out[top : top + h] = depth_u8
    return out


def save_sidecar(path, top: int, bottom: int, segments=None) -> None:
    """JSON sidecar next to the depth output (render_depth.py:1736-1744).
    ``segments``: optional [{"frame", "top", "bottom"}, ...] recording
    mid-video bar changes confirmed by the tracker."""
    doc = {"top": int(top), "bottom": int(bottom)}
    if segments:
        doc["segments"] = [
            {"frame": int(s[0]), "top": int(s[1]), "bottom": int(s[2])}
            for s in segments
        ]
    Path(str(path) + ".letterbox.json").write_text(json.dumps(doc))


def load_sidecar(path):
    p = Path(str(path) + ".letterbox.json")
    if not p.exists():
        return None
    d = json.loads(p.read_text())
    return int(d.get("top", 0)), int(d.get("bottom", 0))
