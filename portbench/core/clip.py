"""The input clip: synthetic frames from the seed, written once as a y4m
(C420jpeg) under the temporary directory, and read back by frame index.

The pattern is ``chip_smoke.py``'s ``write_clip`` (gradients and a box
moving across the frame), seeded: the seed sets the gradients' phases, a
second box's path and the boxes' colours, so every frame is distinct and
every seed has the same sizes and the same work. Frames are made on the
device in integer arithmetic and converted to YUV420 with the benchmark's
own conversion; the y4m writer and reader here are the benchmark's own.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np
import torch

from ..reference.convert import rgb_u8_to_yuv420


def _layout(rng: np.random.Generator) -> dict:
    return {"r0": int(rng.integers(0, 256)), "g0": int(rng.integers(0, 256)),
            "b0": int(rng.integers(60, 160)), "step": int(rng.integers(2, 7)),
            "box": [int(c) for c in rng.integers(0, 256, 3)],
            "box2": [int(c) for c in rng.integers(0, 256, 3)],
            "phase": int(rng.integers(0, 1 << 16)), "speed2": int(rng.integers(1, 4))}


def frames_rgb(seed: int, w: int, h: int, first: int, count: int, device) -> torch.Tensor:
    """Frames first .. first + count - 1 of the seed's clip: RGB uint8
    [count, h, w, 3] on ``device``."""
    lay = _layout(np.random.default_rng(seed))
    xx = torch.arange(w, device=device, dtype=torch.int64)[None, :]
    yy = torch.arange(h, device=device, dtype=torch.int64)[:, None]
    out = []
    for i in range(first, first + count):
        f = torch.empty((h, w, 3), dtype=torch.int64, device=device)
        f[..., 0] = (xx * 255 // max(w - 1, 1) + lay["step"] * i + lay["r0"]) % 256
        f[..., 1] = (yy * 255 // max(h - 1, 1) + lay["g0"]) % 256
        f[..., 2] = (lay["b0"] + (xx + yy + lay["phase"] + 3 * i) % 64)
        x0 = w // 8 + (w // 64) * i % (w // 2)
        f[h // 4: h // 2, x0: x0 + w // 6] = torch.tensor(lay["box"], device=device)
        x1 = (w * 3 // 4 - (w // 128 + 1) * lay["speed2"] * i) % max(w - w // 8, 1)
        f[h * 5 // 8: h * 7 // 8, x1: x1 + w // 8] = torch.tensor(lay["box2"], device=device)
        out.append(f)
    return torch.stack(out).to(torch.uint8)


def header(w: int, h: int, fps: int) -> bytes:
    return f"YUV4MPEG2 W{w} H{h} F{fps}:1 Ip A1:1 C420jpeg\n".encode()


def write_clip(path: Path, seed: int, w: int, h: int, n: int, fps: int, device,
               batch: int = 8) -> int:
    """Write the seed's n-frame clip and sync it to disk; the bytes written."""
    path.parent.mkdir(parents=True, exist_ok=True)
    written = 0
    with open(path, "wb") as f:
        written += f.write(header(w, h, fps))
        for first in range(0, n, batch):
            planes = rgb_u8_to_yuv420(frames_rgb(seed, w, h, first, min(batch, n - first),
                                                 device))
            y, u, v = (p.cpu().numpy() for p in planes)
            for i in range(y.shape[0]):
                written += f.write(b"FRAME\n")
                for p in (y[i], u[i], v[i]):
                    written += f.write(p.tobytes())
        # on disk before the window: its writeback would otherwise share
        # the host with the measured render
        f.flush()
        os.fsync(f.fileno())
    return written


def read_planes(path: Path, w: int, h: int, indices) -> tuple[np.ndarray, ...]:
    """The (Y, U, V) planes of the given frames, each stacked [len, ...]."""
    with open(path, "rb") as f:
        head = f.readline()
        start = len(head)
        size = w * h + 2 * ((w + 1) // 2) * ((h + 1) // 2)
        rec = len(b"FRAME\n") + size
        ys, us, vs = [], [], []
        for i in indices:
            f.seek(start + i * rec)
            if f.read(6) != b"FRAME\n":
                raise ValueError(f"{path}: no frame {i}")
            raw = np.frombuffer(f.read(size), dtype=np.uint8)
            cw, ch = (w + 1) // 2, (h + 1) // 2
            ys.append(raw[: w * h].reshape(h, w))
            us.append(raw[w * h: w * h + cw * ch].reshape(ch, cw))
            vs.append(raw[w * h + cw * ch:].reshape(ch, cw))
    return np.stack(ys), np.stack(us), np.stack(vs)


def clip_path(mix: str, seed: int) -> Path:
    """Under the temporary directory (``TMPDIR``), named by mix and seed."""
    import tempfile

    return Path(tempfile.gettempdir()) / "portbench" / f"{mix}.{seed}.y4m"


def remove(path: Path) -> None:
    try:
        os.unlink(path)
    except FileNotFoundError:
        pass
