"""How the port's tests call the JAX package as their reference, so that one
stuck reference call cannot stall a whole run.

F23: the JAX package's native y4m reader (``visiondepth3d_tpu/native/
vd3d_media.cpp``) stores ``stop`` and notifies without its mutex in
``vd3d_y4m_close`` and ``vd3d_y4m_seek``. A close (or seek) while the
prefetch thread waits to stage its next frame can lose the wake-up, and
``join`` then blocks forever: about one hang in 50,000 early closes with
eight processes at once on an 8-core host. The port's own reader has the
fix (``tests/test_torch_mesh.py::test_reader_close_never_hangs``).

- The port's tests therefore pass the JAX render ``device_yuv_in=False``
  (its plane input reads frame 0 and closes the clip's RGB reader at
  once), read JAX-written files to their end or with the port's reader,
  and run every JAX route, render or CLI call that opens a native reader
  through ``bounded``: on a daemon thread, joined with a timeout, so that a
  hang fails that one case with a message naming F23.
- ``bounded`` returns the call's value, re-raises its exception, and fails
  (naming F23) when the call outlives its timeout.
- The JAX render with ``device_yuv_in`` True and False writes the same
  bytes (the JAX package's comment calls the device YUV path bit-exact),
  checked in a subprocess with a timeout, since the True case itself
  closes a reader early.
"""

from __future__ import annotations

import subprocess
import sys
import threading
from pathlib import Path

import pytest

REPO = str(Path(__file__).resolve().parents[1])
# a JAX reference call on the toy shapes these tests use takes seconds to a
# minute under a loaded run; five minutes is far beyond that and well inside
# the suite's own limit
BOUND_S = 300.0


def bounded(fn, *args, timeout: float = BOUND_S, **kwargs):
    """``fn(*args, **kwargs)`` on a daemon thread, joined for at most
    ``timeout`` seconds: its value, or its exception re-raised here; a call
    still running then fails the case (F23: the JAX reader's lost wake-up
    in an early close)."""
    out: dict = {}

    def run():
        try:
            out["value"] = fn(*args, **kwargs)
        except BaseException as e:  # re-raised on the test's thread
            out["error"] = e

    th = threading.Thread(target=run, daemon=True,
                          name=f"jax-reference-{getattr(fn, '__name__', 'call')}")
    th.start()
    th.join(timeout)
    if th.is_alive():
        pytest.fail(f"{getattr(fn, '__qualname__', fn)} still ran after {timeout:.0f} s: the "
                    f"JAX package's native y4m reader can hang in an early close (F23, a lost "
                    f"wake-up in vd3d_y4m_close)", pytrace=False)
    if "error" in out:
        raise out["error"]
    return out.get("value")


def test_bounded_returns_the_value():
    assert bounded(lambda a, b=0: a + b, 2, b=3) == 5
    assert bounded(lambda: None) is None


def test_bounded_reraises_the_exception():
    def boom():
        raise KeyError("x")

    with pytest.raises(KeyError, match="x"):
        bounded(boom)


def test_bounded_fails_a_hang_naming_f23():
    release = threading.Event()
    try:
        with pytest.raises(pytest.fail.Exception, match="F23"):
            bounded(release.wait, timeout=0.2)
    finally:
        release.set()


_YUV_IN = r"""
import sys
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
from visiondepth3d_tpu.io import Y4MWriter
from visiondepth3d_tpu.pipeline.stereo_pipeline import RenderConfig, render_stereo_video

tmp = sys.argv[1]
h, w = 48, 64
yy, xx = np.mgrid[0:h, 0:w]
rng = np.random.default_rng(0)
with Y4MWriter(f"{tmp}/clip.y4m", w, h, 24.0) as wr, \
        Y4MWriter(f"{tmp}/depth.y4m", w, h, 24.0) as wd:
    for i in range(7):
        f = np.stack([(xx * 3 + 9 * i) % 256, (yy * 5) % 256, np.full_like(xx, 90)], -1)
        f[10:30, 3 * i:3 * i + 14] = (240, 50, 50)
        wr.write((f + rng.integers(0, 9, f.shape)).clip(0, 255).astype(np.uint8))
        d = (xx * 3 + 30).astype(np.uint8)
        d[10:30, 3 * i:3 * i + 14] = 220
        wd.write(np.repeat(d[..., None], 3, -1))
for fmt in ("Full-SBS", "Red-Cyan Anaglyph"):
    outs = []
    for yuv_in in (True, False):
        out = f"{tmp}/{fmt[:3]}_{yuv_in}.y4m"
        render_stereo_video(f"{tmp}/clip.y4m", f"{tmp}/depth.y4m", out, None,
                            RenderConfig(mesh="off", output_format=fmt, chunk_size=4,
                                         preserve_original_aspect=True, device_yuv_in=yuv_in))
        outs.append(open(out, "rb").read())
    assert len(outs[0]) > 7 * h * w and outs[0] == outs[1], fmt
print("ok")
"""


def test_jax_device_yuv_in_is_byte_identical(tmp_path):
    """The JAX render of a 7-frame y4m clip and its depth clip (chunks of 4,
    Full-SBS and the anaglyph) with ``device_yuv_in`` True and False: the
    same bytes, so the port's tests may take the JAX reference with False.
    In a subprocess, so that the True case's own early close cannot stall
    the run."""
    try:
        res = subprocess.run([sys.executable, "-c", _YUV_IN, str(tmp_path)],
                             capture_output=True, text=True, cwd=REPO, timeout=BOUND_S)
    except subprocess.TimeoutExpired:
        pytest.fail(f"the JAX renders still ran after {BOUND_S:.0f} s (F23: the JAX reader's "
                    f"lost wake-up in an early close)", pytrace=False)
    assert res.returncode == 0 and res.stdout.strip().endswith("ok"), res.stderr[-3000:]
