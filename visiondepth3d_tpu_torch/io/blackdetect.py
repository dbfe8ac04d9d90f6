"""Blank (black/white) frame detection with sidecar caching.

The port's copy of ``visiondepth3d_tpu/io/blackdetect.py``.

The reference runs FFmpeg's blackdetect filter over the whole input and
caches frame indices in ``<input>.blankcache.json``
(core/ffmpeg_blackdetect.py:37-75). We do the same when FFmpeg exists;
otherwise a host-side numpy scan over decoded frames (the decode already
happens once for rendering, so the scan shares it in-pipeline).
"""

from __future__ import annotations

import json
import re
import subprocess
from pathlib import Path

import numpy as np

from . import ffmpeg as ff


def _cache_path(input_path: str) -> Path:
    return Path(str(input_path) + ".blankcache.json")


def load_cached(input_path: str) -> list[int] | None:
    p = _cache_path(input_path)
    if p.exists():
        try:
            return json.loads(p.read_text())["blank_frames"]
        except Exception:
            return None
    return None


def save_cache(input_path: str, frames: list[int]) -> None:
    try:
        _cache_path(input_path).write_text(json.dumps({"blank_frames": frames}))
    except OSError:
        pass


def frame_is_blank(frame_rgb_u8: np.ndarray, mode: str = "black",
                   pixel_threshold: float = 0.10) -> bool:
    """Single-frame test: fraction of pixels brighter/darker than the pixel
    threshold (blackdetect pic_th/pix_th analog)."""
    gray = frame_rgb_u8.mean(axis=-1) / 255.0
    if mode == "black":
        return float((gray < pixel_threshold).mean()) > 0.98
    return float((gray > 1.0 - pixel_threshold).mean()) > 0.98


def detect_blank_frames_ffmpeg(
    input_path: str, fps: float, mode: str = "black",
    duration_threshold: float = 0.1, pixel_threshold: float = 0.10,
) -> list[int]:
    """FFmpeg blackdetect pass -> list of blank frame indices."""
    if not ff.have_ffmpeg():
        raise RuntimeError("ffmpeg not available")
    filt = (
        f"blackdetect=d={duration_threshold}:pix_th={pixel_threshold}"
        if mode == "black"
        else f"negate,blackdetect=d={duration_threshold}:pix_th={pixel_threshold}"
    )
    out = subprocess.run(
        [ff.FFMPEG, "-v", "info", "-i", str(input_path), "-vf", filt,
         "-an", "-f", "null", "-"],
        capture_output=True, text=True,
    )
    frames: list[int] = []
    for m in re.finditer(
        r"black_start:([\d.]+)\s+black_end:([\d.]+)", out.stderr
    ):
        s, e = float(m.group(1)), float(m.group(2))
        frames.extend(range(int(s * fps), int(e * fps) + 1))
    return frames


def detect_blank_frames(
    input_path: str, fps: float, mode: str = "black",
    duration_threshold: float = 0.1, pixel_threshold: float = 0.10,
    cache: bool = True,
) -> list[int]:
    """Full-file blank scan with sidecar cache (ffmpeg_blackdetect.py parity)."""
    if cache:
        cached = load_cached(input_path)
        if cached is not None:
            return cached
    if ff.have_ffmpeg():
        frames = detect_blank_frames_ffmpeg(
            input_path, fps, mode, duration_threshold, pixel_threshold
        )
    else:
        from .video import open_video

        frames = []
        with open_video(input_path) as rd:
            for i, frame in enumerate(rd):
                if frame_is_blank(frame, mode, pixel_threshold):
                    frames.append(i)
    if cache:
        save_cache(input_path, frames)
    return frames
