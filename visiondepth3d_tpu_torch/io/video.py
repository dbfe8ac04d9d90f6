"""Unified video reader/writer: FFmpeg-backed for arbitrary containers,
native y4m when FFmpeg is absent or the file is already y4m. The port's
copy of ``visiondepth3d_tpu/io/video.py``.

All frames are uint8 RGB [H, W, 3] on the host side. Readers expose
``read()``/iteration and width/height/fps; writers expose ``write()``.
"""

from __future__ import annotations

import os
import tempfile
from pathlib import Path

import numpy as np

from . import ffmpeg as ff
from .y4m import Y4MReader, Y4MWriter


class FFmpegY4MReader:
    """Decode any container through ffmpeg into the native y4m reader."""

    def __init__(self, path, start_s=None, end_s=None):
        if not ff.have_ffmpeg():
            raise RuntimeError("ffmpeg not available")
        # Use a named pipe so the native prefetch thread does the reading.
        self._fifo_dir = tempfile.mkdtemp(prefix="vd3d_y4m_")
        fifo = os.path.join(self._fifo_dir, "stream.y4m")
        os.mkfifo(fifo)
        import subprocess

        cmd = ff.decode_to_y4m_cmd(path, start_s, end_s)
        cmd[-1:] = ["-y", fifo]
        self._proc = subprocess.Popen(cmd)
        self._reader = Y4MReader(fifo)
        self.width = self._reader.width
        self.height = self._reader.height
        self.fps = self._reader.fps

    def read(self):
        return self._reader.read()

    def __iter__(self):
        return iter(self._reader)

    def close(self):
        self._reader.close()
        if self._proc.poll() is None:
            self._proc.kill()
        self._proc.wait()
        import shutil

        shutil.rmtree(self._fifo_dir, ignore_errors=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def open_video(path, start_s=None, end_s=None):
    """Open a video for reading. y4m natively; anything else via ffmpeg.

    Raises on AV1 when no decoder exists (AV1 guard analog,
    render_depth.py:1987-2036 — the reference refuses AV1 outright because
    of OpenCV; we only refuse when we genuinely can't decode)."""
    p = str(path)
    if p.endswith(".y4m") and start_s is None and end_s is None:
        return Y4MReader(p)
    if p.endswith(".y4m") and not ff.have_ffmpeg():
        # native clip window: y4m frames are fixed-size records, so the
        # C reader seeks by index (vd3d_y4m_seek); non-seekable streams
        # fall back to a sequential skip
        rd = Y4MReader(p)
        f0 = int(round((start_s or 0.0) * rd.fps))
        if f0 > 0 and not rd.seek(f0):
            for _ in range(f0):
                if rd.read() is None:
                    break
        n = None
        if end_s is not None:
            n = max(0, int(round(end_s * rd.fps)) - f0)
        return _ClippedReader(rd, n)
    if not ff.have_ffmpeg():
        raise RuntimeError(
            f"cannot open {p}: ffmpeg not available and input is not .y4m"
        )
    return FFmpegY4MReader(p, start_s, end_s)


class _ClippedReader:
    """Frame-limited view over a reader (native y4m clip windows)."""

    def __init__(self, rd, n_frames: int | None):
        self._rd = rd
        self._left = n_frames  # None = until EOF
        self.width, self.height = rd.width, rd.height
        self.fps = rd.fps

    def read(self):
        if self._left is not None:
            if self._left <= 0:
                return None
            self._left -= 1
        return self._rd.read()

    def close(self):
        self._rd.close()

    def __getattr__(self, name):  # read_planes, fps_num, ... passthrough
        return getattr(self._rd, name)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class FFmpegEncoder:
    """Encode RGB frames through ffmpeg (y4m over stdin)."""

    def __init__(self, path, width, height, fps, codec="libx264", crf=23):
        if not ff.have_ffmpeg():
            raise RuntimeError("ffmpeg not available")
        codec = ff.validate_codec(codec)
        self._proc = ff.popen_writer(ff.encode_from_y4m_cmd(path, codec, crf))
        from .y4m import _fps_to_ratio

        fn, fd = _fps_to_ratio(fps)
        header = f"YUV4MPEG2 W{width} H{height} F{fn}:{fd} Ip A1:1 C420jpeg\n"
        self._proc.stdin.write(header.encode())
        self.width, self.height = width, height

    def write(self, frame_rgb_u8: np.ndarray):
        frame = np.ascontiguousarray(frame_rgb_u8, dtype=np.uint8)
        y, u, v = _rgb_to_yuv420_np(frame)
        self._proc.stdin.write(b"FRAME\n")
        self._proc.stdin.write(y.tobytes())
        self._proc.stdin.write(u.tobytes())
        self._proc.stdin.write(v.tobytes())

    def close(self):
        self._proc.stdin.close()
        self._proc.wait()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _rgb_to_yuv420_np(rgb: np.ndarray):
    """Vectorized BT.601 limited-range RGB -> YUV420 (matches the C++ path)."""
    r = rgb[..., 0].astype(np.int32)
    g = rgb[..., 1].astype(np.int32)
    b = rgb[..., 2].astype(np.int32)
    y = ((66 * r + 129 * g + 25 * b + 128 + (16 << 8)) >> 8).clip(0, 255)
    h, w = rgb.shape[:2]
    ph, pw = h + (h & 1), w + (w & 1)
    rp = np.zeros((ph, pw), np.int32)
    gp = np.zeros((ph, pw), np.int32)
    bp = np.zeros((ph, pw), np.int32)
    for src, dst in ((r, rp), (g, gp), (b, bp)):
        dst[:h, :w] = src
        if ph > h:
            dst[h:, :w] = src[-1:, :]
        if pw > w:
            dst[:h, w:] = src[:, -1:]
    # 2x2 means
    def pool(x):
        return (x[0::2, 0::2] + x[0::2, 1::2] + x[1::2, 0::2] + x[1::2, 1::2]) // 4

    rm, gm, bm = pool(rp), pool(gp), pool(bp)
    u = (((-38 * rm - 74 * gm + 112 * bm + 128) >> 8) + 128).clip(0, 255)
    v = (((112 * rm - 94 * gm - 18 * bm + 128) >> 8) + 128).clip(0, 255)
    return y.astype(np.uint8), u.astype(np.uint8), v.astype(np.uint8)


def open_writer(path, width, height, fps, codec="libx264", crf=23,
                append=False):
    p = str(path)
    if p.endswith(".y4m") or not ff.have_ffmpeg():
        if not p.endswith(".y4m"):
            p = str(Path(p).with_suffix(".y4m"))
        return Y4MWriter(p, width, height, fps, append=append)
    if append:
        raise ValueError(
            "resume/append is only supported for .y4m outputs; encoded "
            "containers need a segment-concat strategy"
        )
    return FFmpegEncoder(p, width, height, fps, codec, crf)
