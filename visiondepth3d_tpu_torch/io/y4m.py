"""Native Y4M (YUV4MPEG2) video reader/writer via the C++ media library.

The port's copy of ``visiondepth3d_tpu/io/y4m.py``, with the same classes
and behaviour. The raw-video interchange path: FFmpeg (when present) speaks
y4m over pipes; without FFmpeg, .y4m files are read/written directly. The
C++ side (``native/vd3d_media.cpp``) does YUV420<->RGB conversion and
background prefetch. It is compiled with g++ at first use into ``_build/``,
under a file name keyed by a hash of the source and flags.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent / "native" / "vd3d_media.cpp"
_BUILD_DIR = Path(__file__).resolve().parent / "_build"
_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")
_lock = threading.Lock()
_lib = None


def build_library() -> Path:
    """Compile native/vd3d_media.cpp into _build/ unless that build exists."""
    digest = hashlib.sha256(" ".join(_FLAGS).encode() + _SRC.read_bytes()).hexdigest()[:16]
    out = _BUILD_DIR / f"libvd3d_media_{digest}.so"
    if out.exists():
        return out
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("g++ not found: the y4m library cannot be built")
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    res = subprocess.run([cxx, *_FLAGS, str(_SRC), "-o", str(tmp)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"g++ failed (rc={res.returncode}):\n{res.stderr}")
    os.replace(tmp, out)
    return out


def _load_lib() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            _lib = _declare(ctypes.CDLL(str(build_library())))
        return _lib


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.vd3d_y4m_open.restype = ctypes.c_void_p
    lib.vd3d_y4m_open.argtypes = [ctypes.c_char_p]
    lib.vd3d_y4m_info.argtypes = [ctypes.c_void_p] + [
        ctypes.POINTER(ctypes.c_int)
    ] * 4
    lib.vd3d_y4m_read.restype = ctypes.c_int
    lib.vd3d_y4m_read.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.vd3d_y4m_close.argtypes = [ctypes.c_void_p]
    lib.vd3d_y4m_writer_open.restype = ctypes.c_void_p
    lib.vd3d_y4m_writer_open.argtypes = [ctypes.c_char_p] + [ctypes.c_int] * 4
    lib.vd3d_y4m_writer_open2.restype = ctypes.c_void_p
    lib.vd3d_y4m_writer_open2.argtypes = [ctypes.c_char_p] + [ctypes.c_int] * 5
    lib.vd3d_y4m_write.restype = ctypes.c_int
    lib.vd3d_y4m_write.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.vd3d_y4m_write_planes.restype = ctypes.c_int
    lib.vd3d_y4m_write_planes.argtypes = [ctypes.c_void_p] + [
        ctypes.c_char_p
    ] * 3
    lib.vd3d_y4m_writer_close.argtypes = [ctypes.c_void_p]
    lib.vd3d_y4m_count.restype = ctypes.c_long
    lib.vd3d_y4m_count.argtypes = [ctypes.c_void_p]
    lib.vd3d_y4m_open_raw.restype = ctypes.c_void_p
    lib.vd3d_y4m_open_raw.argtypes = [ctypes.c_char_p]
    lib.vd3d_y4m_seek.restype = ctypes.c_int
    lib.vd3d_y4m_seek.argtypes = [ctypes.c_void_p, ctypes.c_long]
    return lib


class Y4MReader:
    """Iterates uint8 RGB [H, W, 3] frames with native background prefetch."""

    def __init__(self, path: str | os.PathLike):
        lib = _load_lib()
        self._lib = lib
        self._h = lib.vd3d_y4m_open(str(path).encode())
        if not self._h:
            raise IOError(f"cannot open y4m: {path}")
        w, h, fn, fd = (ctypes.c_int() for _ in range(4))
        lib.vd3d_y4m_info(self._h, w, h, fn, fd)
        self.width, self.height = w.value, h.value
        self.fps = fn.value / max(fd.value, 1)
        self.fps_num, self.fps_den = fn.value, fd.value
        self._buf = ctypes.create_string_buffer(self.width * self.height * 3)

    def read(self) -> np.ndarray | None:
        if self._h is None:
            return None
        ok = self._lib.vd3d_y4m_read(self._h, self._buf)
        if not ok:
            return None
        return np.frombuffer(self._buf, dtype=np.uint8).reshape(
            self.height, self.width, 3
        ).copy()

    def __iter__(self):
        while True:
            frame = self.read()
            if frame is None:
                return
            yield frame

    def count(self) -> int | None:
        """Total frame count, O(1) from the file size (fixed-size FRAME
        records — what this muxer and ffmpeg emit). None when the stream
        has per-frame parameters or isn't a regular file."""
        n = self._lib.vd3d_y4m_count(self._h)
        return None if n < 0 else int(n)

    def seek(self, frame_idx: int) -> bool:
        """Reposition to an absolute frame index (segment-parallel reads).
        Returns False when the stream isn't seekable at fixed records."""
        return bool(self._lib.vd3d_y4m_seek(self._h, int(frame_idx)))

    def close(self):
        if self._h is not None:
            self._lib.vd3d_y4m_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class Y4MPlaneReader:
    """Raw-plane reader: yields (Y [H,W], U [H/2,W/2], V [H/2,W/2]) uint8.

    The input analog of ``Y4MWriter.write_yuv420``: the host does a pure
    fread (no colorspace math) and the DEVICE converts
    (ops/convert.py:yuv420_to_rgb_u8, bit-exact vs the C++ path) — half
    the host->device bytes of RGB and near-zero host decode CPU."""

    def __init__(self, path: str | os.PathLike):
        lib = _load_lib()
        self._lib = lib
        self._h = lib.vd3d_y4m_open_raw(str(path).encode())
        if not self._h:
            raise IOError(f"cannot open y4m: {path}")
        w, h, fn, fd = (ctypes.c_int() for _ in range(4))
        lib.vd3d_y4m_info(self._h, w, h, fn, fd)
        self.width, self.height = w.value, h.value
        self.fps = fn.value / max(fd.value, 1)
        self._cw = (self.width + 1) // 2
        self._ch = (self.height + 1) // 2
        self._ysz = self.width * self.height
        self._csz = self._cw * self._ch
        self._buf = ctypes.create_string_buffer(self._ysz + 2 * self._csz)

    def read(self):
        if self._h is None:
            return None
        ok = self._lib.vd3d_y4m_read(self._h, self._buf)
        if not ok:
            return None
        raw = np.frombuffer(self._buf, dtype=np.uint8)
        y = raw[: self._ysz].reshape(self.height, self.width).copy()
        u = raw[self._ysz : self._ysz + self._csz].reshape(
            self._ch, self._cw).copy()
        v = raw[self._ysz + self._csz :].reshape(self._ch, self._cw).copy()
        return y, u, v

    def seek(self, frame_idx: int) -> bool:
        return bool(self._lib.vd3d_y4m_seek(self._h, int(frame_idx)))

    def count(self) -> int | None:
        n = self._lib.vd3d_y4m_count(self._h)
        return None if n < 0 else int(n)

    def close(self):
        if self._h is not None:
            self._lib.vd3d_y4m_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class Y4MWriter:
    """Writes uint8 RGB [H, W, 3] frames to a .y4m file (C420jpeg)."""

    def __init__(self, path: str | os.PathLike, width: int, height: int,
                 fps: float, append: bool = False):
        lib = _load_lib()
        self._lib = lib
        fps_num, fps_den = _fps_to_ratio(fps)
        self._h = lib.vd3d_y4m_writer_open2(
            str(path).encode(), width, height, fps_num, fps_den, int(append)
        )
        if not self._h:
            raise IOError(f"cannot open y4m for writing: {path}")
        self.width, self.height = width, height

    def write(self, frame_rgb_u8: np.ndarray):
        frame = np.ascontiguousarray(frame_rgb_u8, dtype=np.uint8)
        assert frame.shape == (self.height, self.width, 3), frame.shape
        ok = self._lib.vd3d_y4m_write(self._h, frame.ctypes.data_as(ctypes.c_char_p))
        if not ok:
            raise IOError("y4m write failed")

    def write_yuv420(self, y: np.ndarray, u: np.ndarray, v: np.ndarray):
        """Plane passthrough: Y [H, W], U/V [H/2, W/2] uint8 — produced on
        device by ops.convert.rgb_u8_to_yuv420; the host only fwrites."""
        y = np.ascontiguousarray(y, dtype=np.uint8)
        u = np.ascontiguousarray(u, dtype=np.uint8)
        v = np.ascontiguousarray(v, dtype=np.uint8)
        assert y.shape == (self.height, self.width), y.shape
        ch, cw = (self.height + 1) // 2, (self.width + 1) // 2
        assert u.shape == (ch, cw) and v.shape == (ch, cw), (u.shape, v.shape)
        ok = self._lib.vd3d_y4m_write_planes(
            self._h,
            y.ctypes.data_as(ctypes.c_char_p),
            u.ctypes.data_as(ctypes.c_char_p),
            v.ctypes.data_as(ctypes.c_char_p),
        )
        if not ok:
            raise IOError("y4m plane write failed")

    def close(self):
        if self._h is not None:
            self._lib.vd3d_y4m_writer_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _fps_to_ratio(fps: float) -> tuple[int, int]:
    for num, den in ((24000, 1001), (30000, 1001), (60000, 1001)):
        if abs(fps - num / den) < 1e-3:
            return num, den
    if abs(fps - round(fps)) < 1e-6:
        return int(round(fps)), 1
    return int(round(fps * 1000)), 1000
