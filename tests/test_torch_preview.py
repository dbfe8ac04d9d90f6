"""The port's live preview against the JAX package's: the ten diagnostic
views of one frame, the session files of the watch loop, the watch loop
itself and its web page.

- ``render_preview`` on the CPU (the kernels' plain versions) against the
  JAX function on the CPU, same 128x48 frame and depth, every mode: mean
  |d| <= 0.1 and max |d| <= 3 u8, the surface tests' render bound.
- A session file written by either package reads into equal StereoParams
  in the other.
- The watch loop and the preview server, as ``tests/test_preview_watch.py``
  and ``tests/test_preview_server.py`` drive the JAX package's.
- The entry points default to the card and raise without one.
- On the card (``cuda``-marked, skips here): every mode within a mean of
  1 u8 and SSIM >= 0.99 of the CPU, K1-K4 launched 1/1/2/3 times a render.
"""

from __future__ import annotations

import dataclasses
import json
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch
torch.set_num_threads(1)

from visiondepth3d_tpu_torch.cli.main import main as cli_main
from visiondepth3d_tpu_torch.io import Y4MWriter
from visiondepth3d_tpu_torch.io.depth_io import Depth16Writer
from visiondepth3d_tpu_torch.preview import (PREVIEW_MODES, render_preview, serve_preview,
                                             watch_preview, write_session_template)
from visiondepth3d_tpu_torch.preview.watch import _read_session
from visiondepth3d_tpu_torch.stereo import StereoParams as TParams

H, W = 48, 128


def _jax():
    """The JAX package's preview modules and StereoParams, imported where a
    case compares against them (the card's test runner mocks jax and flax,
    under which the JAX package's presets module cannot import)."""
    from visiondepth3d_tpu.preview import diagnostics, watch
    from visiondepth3d_tpu.stereo import StereoParams

    return diagnostics, watch, StereoParams


def _frame_depth():
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:H, 0:W]
    f = np.stack([0.5 + 0.4 * np.sin(xx / 7 + yy / 11), 0.5 + 0.4 * np.cos(yy / 5),
                  0.5 + 0.3 * np.sin((xx + yy) / 9)], -1)
    f = np.clip(f + 0.02 * rng.random((H, W, 3)), 0, 1).astype(np.float32)
    f[12:30, 40:70] = (0.9, 0.2, 0.2)
    d = np.clip(0.3 + 0.5 * xx / W + 0.1 * np.sin(yy / 6), 0, 1).astype(np.float32)
    d[12:30, 40:70] = 0.85
    return f, d


@pytest.mark.parametrize("mode", PREVIEW_MODES)
def test_render_preview_matches_jax(mode):
    jdiag, _, JParams = _jax()
    frame, depth = _frame_depth()
    params = dict(fg_shift=10.0, enable_healing=True)
    want = jdiag.render_preview(frame, depth, JParams(**params), mode)
    got = render_preview(frame, depth, TParams(**params), mode, device="cpu")
    assert got.dtype == np.uint8 and got.shape == want.shape
    d = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert d.mean() <= 0.1 and d.max() <= 3, (mode, d.mean(), d.max())
    assert want.std() > 0  # a view with content, not a flat image


def test_render_preview_rejects_unknown_mode():
    frame, depth = _frame_depth()
    with pytest.raises(ValueError, match="unknown preview mode"):
        render_preview(frame, depth, mode="nope", device="cpu")


_EDITED = dict(fg_shift=11.5, mg_shift=-2.0, blur_ksize=7, enable_healing=True,
               enable_floating_window=False, image_dtype="bfloat16", dof_strength=1.5)


def test_session_files_cross_read(tmp_path):
    """A session written by either package reads into equal StereoParams
    (every field both packages have) in the other, with its mode and frame."""
    _, jwatch, JParams = _jax()
    common = [f.name for f in dataclasses.fields(JParams)
              if f.name in {g.name for g in dataclasses.fields(TParams)}]
    jpath, tpath = tmp_path / "jax.json", tmp_path / "torch.json"
    jwatch.write_session_template(jpath, JParams(**_EDITED), mode="anaglyph", frame=2)
    write_session_template(tpath, TParams(**_EDITED), mode="anaglyph", frame=2)
    tp, tmode, tframe, tquit = _read_session(jpath)
    jp, jmode, jframe, jquit = jwatch._read_session(tpath)
    assert (tmode, tframe, tquit) == (jmode, jframe, jquit) == ("anaglyph", 2, False)
    assert tp == TParams(**_EDITED)
    assert {k: getattr(jp, k) for k in common} == {k: getattr(TParams(**_EDITED), k)
                                                   for k in common}
    assert jp == JParams(**_EDITED)


def test_session_template_roundtrip(tmp_path):
    sess = tmp_path / "s.json"
    write_session_template(sess, mode="anaglyph", frame=1)
    d = json.loads(sess.read_text())
    assert d["mode"] == "anaglyph" and d["frame"] == 1
    assert "fg_shift" in d and "quit" in d


def _make_clip(tmp_path, t=3, h=32, w=48):
    src, dep = tmp_path / "in.y4m", tmp_path / "d.vd16"
    with Y4MWriter(str(src), w, h, 24.0) as wr:
        for i in range(t):
            wr.write(np.full((h, w, 3), 40 * i + 20, np.uint8))
    _, xx = np.mgrid[0:h, 0:w]
    with Depth16Writer(str(dep), w, h, 24.0) as dw:
        for _ in range(t):
            dw.write(((xx / w) * 65535).astype(np.uint16))
    return src, dep


def _wait_for(cond, timeout=60.0):
    t0 = time.time()
    while not cond():
        assert time.time() - t0 < timeout, "timed out"
        time.sleep(0.05)


def test_watch_rerenders_on_edit_and_quits(tmp_path):
    src, dep = _make_clip(tmp_path)
    sess, out = tmp_path / "s.json", tmp_path / "out"
    msgs = []
    th = threading.Thread(target=lambda: watch_preview(
        src, dep, sess, out, poll_s=0.05, debounce_s=0.05, status_cb=msgs.append,
        device="cpu"), daemon=True)
    th.start()
    _wait_for(lambda: len(msgs) >= 1)  # the template is written, then rendered
    assert (out / "preview_sbs.png").exists()

    d = json.loads(sess.read_text())
    d.update({"mode": "depth", "frame": 2})
    sess.write_text(json.dumps(d))
    _wait_for(lambda: len(msgs) >= 2)
    assert (out / "preview_depth.png").exists()
    assert "frame 2" in msgs[-1] and "mode depth" in msgs[-1]

    d["quit"] = True
    sess.write_text(json.dumps(d))
    th.join(timeout=20)
    assert not th.is_alive()


def _get(url):
    with urllib.request.urlopen(url, timeout=10) as r:
        return r.read()


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(), method="POST")
    return urllib.request.urlopen(req, timeout=10).read()


def test_preview_server_end_to_end(tmp_path):
    src, dep = _make_clip(tmp_path, t=4, h=48, w=64)
    out = tmp_path / "prev"
    started, result = threading.Event(), {}

    def on_start(port):
        result["port"] = port
        started.set()

    th = threading.Thread(target=lambda: result.update(n=serve_preview(
        src, dep, out, port=0, max_renders=3, server_started=on_start, device="cpu")),
        daemon=True)
    th.start()
    assert started.wait(30)
    base = f"http://127.0.0.1:{result['port']}"

    page = _get(base + "/").decode()
    assert "vd3d preview" in page and "/state" in page
    _wait_for(lambda: json.loads(_get(base + "/state"))["renders"] >= 1)
    st = json.loads(_get(base + "/state"))
    assert "fg_shift" in st["session"]
    assert _get(base + "/img/preview_sbs.png")[:8] == b"\x89PNG\r\n\x1a\n"
    assert _get(base + "/img/preview_input.png")[:4] == b"\x89PNG"

    # two-way binding: a posted param change is re-rendered
    _post(base + "/update", {"fg_shift": 9.0})
    _wait_for(lambda: json.loads(_get(base + "/state"))["renders"] >= 2)
    assert json.loads(_get(base + "/state"))["session"]["fg_shift"] == 9.0

    _post(base + "/update", {"quit": True})
    th.join(timeout=30)
    assert not th.is_alive()
    assert result["n"] >= 2


def test_cli_preview_writes_the_set(tmp_path):
    src, dep = _make_clip(tmp_path)
    out = tmp_path / "cli"
    assert cli_main(["preview", "--input", str(src), "--depth", str(dep), "--frame", "1",
                     "--mode", "anaglyph", "--output-dir", str(out), "--device", "cpu"]) == 0
    from PIL import Image

    from visiondepth3d_tpu_torch.preview.watch import _load_frame_pair

    f01, d01 = _load_frame_pair(src, dep, 1)
    got = np.asarray(Image.open(out / "preview_anaglyph.png"))
    assert np.array_equal(got, render_preview(f01, d01, mode="anaglyph", device="cpu"))
    assert (out / "preview_input.png").exists() and (out / "preview_depth.png").exists()


def test_preview_needs_a_card_by_default(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    src, dep = _make_clip(tmp_path)
    frame, depth = _frame_depth()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        render_preview(frame, depth)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_preview(src, dep, tmp_path / "out", port=0, max_renders=1)
    assert not (tmp_path / "out").exists()  # raised before anything started


def _ssim(a, b):
    def box(x, k=7):
        c = np.cumsum(np.cumsum(np.pad(x, ((1, 0), (1, 0))), 0), 1)
        return (c[k:, k:] - c[:-k, k:] - c[k:, :-k] + c[:-k, :-k]) / (k * k)

    wts = np.array([0.299, 0.587, 0.114])
    x, y = (np.asarray(v, np.float64) @ wts for v in (a, b))
    c1, c2 = (0.01 * 255) ** 2, (0.03 * 255) ** 2
    mx, my = box(x), box(y)
    vx, vy, cxy = box(x * x) - mx * mx, box(y * y) - my * my, box(x * y) - mx * my
    return float((((2 * mx * my + c1) * (2 * cxy + c2))
                  / ((mx * mx + my * my + c1) * (vx + vy + c2))).mean())


@pytest.mark.cuda
def test_cuda_preview_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    from visiondepth3d_tpu_torch.kernels import launch_counts, reset_launch_counts

    frame, depth = _frame_depth()
    params = TParams(enable_healing=True)
    for mode in PREVIEW_MODES:
        reset_launch_counts()
        got = render_preview(frame, depth, params, mode, device="cuda")
        counts = dict(launch_counts)
        want = render_preview(frame, depth, params, mode, device="cpu")
        d = np.abs(got.astype(np.int16) - want.astype(np.int16))
        assert d.mean() <= 1.0 and _ssim(got, want) >= 0.99, (mode, d.mean())
        assert [counts[k] for k in ("stereo_warp", "feather_heal", "quantile_pair",
                                    "subject_stats")] == [1, 1, 2, 3], counts
