"""Depth video I/O: 8-bit grayscale video and 16-bit raw streams.

The port's copy of ``visiondepth3d_tpu/io/depth_io.py``.

The reference stores depth as grayscale 8-bit video (XVID .mkv,
render_depth.py:1750) plus optional 16-bit FFV1 gray16le for Marigold
(render_depth.py:1699-1714) and raw .npz dumps for DepthCrafter
(render_depth.py:1161-1184). Equivalents here:

- 8-bit: ordinary video via io.video (y4m/ffmpeg), all three channels equal.
- 16-bit: a streamable ``.vd16`` raw format (magic + dims + fps, then
  little-endian uint16 frames) — no external codec needed, plus .npz export,
  plus interoperable FFV1 ``gray16le`` video (render_depth.py:1704-1714)
  when ffmpeg is present: any non-``.vd16`` 16-bit output path dispatches
  to the FFV1 writer, so the result plays in standard tooling.
"""

from __future__ import annotations

import struct

import numpy as np

from . import ffmpeg as ff
from .video import open_video

_MAGIC = b"VD3D16\x00\x01"


class Depth16Writer:
    def __init__(self, path, width: int, height: int, fps: float):
        self._f = open(path, "wb")
        self._f.write(_MAGIC)
        self._f.write(struct.pack("<iif", width, height, fps))
        self.width, self.height = width, height

    def write(self, depth_u16: np.ndarray):
        d = np.ascontiguousarray(depth_u16, dtype="<u2")
        assert d.shape == (self.height, self.width)
        self._f.write(d.tobytes())

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class Depth16Reader:
    def __init__(self, path):
        self._f = open(path, "rb")
        magic = self._f.read(len(_MAGIC))
        if magic != _MAGIC:
            raise IOError(f"not a vd16 stream: {path}")
        self.width, self.height, self.fps = struct.unpack("<iif", self._f.read(12))
        self._frame_bytes = self.width * self.height * 2

    def read(self) -> np.ndarray | None:
        buf = self._f.read(self._frame_bytes)
        if len(buf) < self._frame_bytes:
            return None
        return np.frombuffer(buf, dtype="<u2").reshape(self.height, self.width)

    def seek(self, frame_idx: int) -> bool:
        self._f.seek(len(_MAGIC) + 12 + frame_idx * self._frame_bytes)
        return True

    def count(self) -> int:
        import os

        size = os.fstat(self._f.fileno()).st_size
        return (size - len(_MAGIC) - 12) // self._frame_bytes

    def __iter__(self):
        while True:
            d = self.read()
            if d is None:
                return
            yield d

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class Ffv1Gray16Writer:
    """Stream uint16 depth frames into an FFV1 ``gray16le`` video, the
    reference's interoperable 16-bit export (render_depth.py:1704-1714) —
    lossless and playable by standard tooling, unlike ``.vd16``."""

    def __init__(self, path, width: int, height: int, fps: float):
        if not ff.have_ffmpeg():
            raise RuntimeError(
                "16-bit video export needs ffmpeg; use a .vd16 output path "
                "for the raw-stream fallback")
        self._proc = ff.popen_writer(
            ff.rawvideo_gray16_encode_cmd(path, width, height, fps))
        self.width, self.height = width, height

    def write(self, depth_u16: np.ndarray):
        d = np.ascontiguousarray(depth_u16, dtype="<u2")
        assert d.shape == (self.height, self.width)
        self._proc.stdin.write(d.tobytes())

    def close(self):
        self._proc.stdin.close()
        self._proc.wait()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class Ffv1Gray16Reader:
    """Decode a gray16le-pixel video (FFV1 .mkv) back to uint16 frames."""

    def __init__(self, path):
        if not ff.have_ffmpeg():
            raise RuntimeError("reading 16-bit video needs ffmpeg")
        info = ff.probe(path)
        vs = next(s for s in info["streams"] if s["codec_type"] == "video")
        self.width, self.height = int(vs["width"]), int(vs["height"])
        num, den = (vs.get("avg_frame_rate") or "30/1").split("/")
        self.fps = float(num) / float(den or 1)
        self._proc = ff.popen_reader(ff.rawvideo_gray16_decode_cmd(path))
        self._frame_bytes = self.width * self.height * 2

    def read(self) -> np.ndarray | None:
        buf = self._proc.stdout.read(self._frame_bytes)
        if len(buf) < self._frame_bytes:
            return None
        return np.frombuffer(buf, dtype="<u2").reshape(self.height, self.width)

    def __iter__(self):
        while True:
            d = self.read()
            if d is None:
                return
            yield d

    def close(self):
        self._proc.stdout.close()
        self._proc.wait()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def open_depth16_writer(path, width: int, height: int, fps: float):
    """16-bit depth writer dispatched on extension: ``.vd16`` raw stream,
    anything else FFV1 gray16le via ffmpeg (render_depth.py:1704-1714)."""
    if str(path).endswith(".vd16"):
        return Depth16Writer(path, width, height, fps)
    return Ffv1Gray16Writer(path, width, height, fps)


def _is_gray16_video(path: str) -> bool:
    if not ff.have_ffprobe():
        return False
    try:
        info = ff.probe(path)
    except Exception:
        return False
    return any(s.get("codec_type") == "video"
               and "gray16" in (s.get("pix_fmt") or "")
               for s in info.get("streams", []))


def open_depth_reader(path):
    """Open a depth stream: .vd16 raw 16-bit, gray16le video (FFV1 export)
    at full precision, else a video decoded to 8-bit.

    Returns an iterator of float32 [H, W] depth in [0, 1] plus metadata via
    attributes width/height/fps.
    """
    p = str(path)
    if p.endswith(".vd16"):
        return _Scaled16(Depth16Reader(p))
    if not p.endswith(".y4m") and _is_gray16_video(p):
        return _Scaled16(Ffv1Gray16Reader(p))
    return _ScaledVideo(open_video(p))


class _Scaled16:
    def __init__(self, rd):
        self._rd = rd
        self.width, self.height, self.fps = rd.width, rd.height, rd.fps

    def seek(self, frame_idx: int) -> bool:
        inner = getattr(self._rd, "seek", None)
        return bool(inner and inner(frame_idx))

    def count(self):
        inner = getattr(self._rd, "count", None)
        return inner() if inner else None

    def read(self):
        d = self._rd.read()
        return None if d is None else d.astype(np.float32) / 65535.0

    def __iter__(self):
        while True:
            d = self.read()
            if d is None:
                return
            yield d

    def close(self):
        self._rd.close()


class _ScaledVideo:
    """8-bit depth video -> [0, 1] float via the reference's gray conversion
    (depth_to_tensor, render_3d.py:140-143)."""

    def __init__(self, rd):
        self._rd = rd
        self.width, self.height, self.fps = rd.width, rd.height, rd.fps

    def seek(self, frame_idx: int) -> bool:
        inner = getattr(self._rd, "seek", None)
        return bool(inner and inner(frame_idx))

    def count(self):
        inner = getattr(self._rd, "count", None)
        return inner() if inner else None

    def read(self):
        f = self._rd.read()
        if f is None:
            return None
        gray = 0.299 * f[..., 0] + 0.587 * f[..., 1] + 0.114 * f[..., 2]
        return (np.round(gray) / 255.0).astype(np.float32)

    def __iter__(self):
        while True:
            d = self.read()
            if d is None:
                return
            yield d

    def close(self):
        self._rd.close()


def save_depth_npz(path, depths: np.ndarray):
    """DepthCrafter-style raw dump (render_depth.py:1184 analog)."""
    np.savez_compressed(path, depth=depths.astype(np.float32))


def depth01_to_u16(depth01: np.ndarray) -> np.ndarray:
    return np.clip(depth01 * 65535.0 + 0.5, 0, 65535).astype(np.uint16)


def normalize_to_u8(depth: np.ndarray, invert: bool = False,
                    p_lo: float = 1.0, p_hi: float = 99.0) -> np.ndarray:
    """Percentile-clip normalize to uint8 (render_depth.py:173-194 analog)."""
    lo, hi = np.percentile(depth, [p_lo, p_hi])
    if hi - lo < 1e-9:
        out = np.zeros_like(depth, dtype=np.uint8)
    else:
        out = np.clip((depth - lo) / (hi - lo) * 255.0, 0, 255).astype(np.uint8)
    if invert:
        out = 255 - out
    return out
