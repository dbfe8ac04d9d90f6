"""The render route's surface around the kernels, against the JAX package:
output formats, blank frames, black-bar crop, resume, batch, presets and
the control file.

- Formats, op by op: the float32 anaglyph against the JAX function run op
  by op (jitted XLA fuses its multiply-adds): within 2.4e-7 (two float32
  ulps at 1). bfloat16: the port sums the three
  Dubois products in float32 and rounds once; that equals the JAX function
  run in float32 on the same bf16 values, rounded to bf16, exactly, and
  stays within 2 bf16 ulps at 1 (2^-7) of the JAX bf16 function, which
  rounds each product and each sum. Interlaced is exact. Every format after
  the per-eye letterbox: within 1e-6 in float32 (the area resize's
  summation order), one more bf16 ulp (2^-8) in bfloat16.
- Renders: the same 64x48 clip and depth video through both
  ``render_stereo_video``s (the depth-video route, float32), each new
  format, a clip with blank frames (``skip_blank_frames``, the frame-scan
  detector on both sides: no ffmpeg here) and a letterboxed clip
  (``auto_crop_black_bars``): mean |d| <= 0.1 and max |d| <= 3 u8, the
  render gate of ``test_torch_slice.py``.
- Resume: a render cancelled after its second chunk and resumed is
  bit-identical to an unbroken one; sidecars written by either package load
  into the other's trackers field for field.
"""

from __future__ import annotations

import dataclasses
import json
import threading
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visiondepth3d_tpu.config import presets as jpresets
from visiondepth3d_tpu.io import blackdetect as jblack
from visiondepth3d_tpu.io import Y4MReader, Y4MWriter
from visiondepth3d_tpu.ops import formats as jformats
from visiondepth3d_tpu.pipeline import resume as jresume
from visiondepth3d_tpu.pipeline import stereo_pipeline as jpipe
from visiondepth3d_tpu.state import init_trackers as jinit
from visiondepth3d_tpu.stereo import StereoParams as JParams
from visiondepth3d_tpu.utils.observability import make_control_check as jcontrol
from visiondepth3d_tpu_torch.cli.main import main as cli_main
from visiondepth3d_tpu_torch.config import presets as tpresets
from visiondepth3d_tpu_torch.io import blackdetect as tblack
from visiondepth3d_tpu_torch.ops import formats as tformats
from visiondepth3d_tpu_torch.pipeline import batch as tbatch
from visiondepth3d_tpu_torch.pipeline import resume as tresume
from visiondepth3d_tpu_torch.pipeline import stereo_pipeline as tpipe
from visiondepth3d_tpu_torch.state import init_trackers as tinit
from visiondepth3d_tpu_torch.stereo import StereoParams as TParams
from visiondepth3d_tpu_torch.utils.observability import make_control_check as tcontrol

H, W = 48, 64
TRACKER_FIELDS = ("initialized", "prev_depth", "prev_norm_depth", "norm_lo", "norm_hi",
                  "norm_init", "conv_val", "conv_init", "fg", "mg", "bg", "shift_init",
                  "fw_offset", "fw_counter", "bar_width", "focal", "focal_init")


def _eyes(seed=0, h=H, w=W):
    rng = np.random.default_rng(seed)
    return rng.random((h, w, 3), dtype=np.float32), rng.random((h, w, 3), dtype=np.float32)


def _read(path):
    with Y4MReader(str(path)) as rd:
        return np.stack(list(rd))


def _write_clip(path, n=8, h=H, w=W, blank=(), bars=0, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    with Y4MWriter(str(path), w, h, 24.0) as wr:
        for i in range(n):
            f = np.empty((h, w, 3), np.uint8)
            f[..., 0] = (xx * 4 + i * 4) % 256
            f[..., 1] = (yy * 5) % 256
            f[..., 2] = 100
            f[10:30, 10 + 3 * i: 25 + 3 * i] = (240, 50, 50)
            f = np.clip(f.astype(int) + rng.integers(0, 8, f.shape), 0, 255).astype(np.uint8)
            if bars:
                f[:bars] = 0
                f[h - bars:] = 0
            if i in blank:
                f[:] = 0
            wr.write(f)


def _write_depth(path, n=8, h=H, w=W):
    yy, xx = np.mgrid[0:h, 0:w]
    with Y4MWriter(str(path), w, h, 24.0) as wr:
        for i in range(n):
            d = (xx * 3 + 30).astype(np.uint8)
            d[10:30, 10 + 3 * i: 25 + 3 * i] = 220
            wr.write(np.repeat(d[..., None], 3, -1))


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    d = tmp_path_factory.mktemp("surface")
    _write_clip(d / "clip.y4m")
    _write_depth(d / "depth.y4m")
    return d / "clip.y4m", d / "depth.y4m"


# ---------------------------------------------------------------- formats


@pytest.mark.parametrize("bgr", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_anaglyph_formula(dtype, bgr):
    left, right = _eyes()
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    tl, tr = torch.from_numpy(left).to(tdt), torch.from_numpy(right).to(tdt)
    got = tformats.anaglyph_red_cyan(tl, tr, bgr)
    assert got.dtype == tdt and got.shape == (H, W, 3)
    got = got.float().numpy()
    with jax.disable_jit():
        want = np.asarray(jformats.anaglyph_red_cyan(jnp.asarray(left).astype(jdt),
                                                     jnp.asarray(right).astype(jdt), bgr),
                          np.float32)
        if dtype == "bfloat16":
            f32 = jformats.anaglyph_red_cyan(jnp.asarray(tl.float().numpy()),
                                             jnp.asarray(tr.float().numpy()), bgr)
            np.testing.assert_array_equal(got, np.asarray(f32.astype(jnp.bfloat16), np.float32))
    tol = 2.4e-7 if dtype == "float32" else 2.0 ** -7
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)
    # the red channel is the left eye's Dubois row (the JAX package's own check)
    if dtype == "float32" and not bgr:
        red = 0.4561 * left[..., 0] + 0.5005 * left[..., 1] + 0.1762 * left[..., 2]
        np.testing.assert_allclose(got[..., 0], np.clip(red, 0, 1), atol=1e-6)


@pytest.mark.parametrize("fmt", list(tformats.FORMATS) + ["Top-Bottom"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_format_3d_output_matches_jax(fmt, dtype):
    """Every format name through pack_per_eye + format_3d_output on both
    sides (a name outside FORMATS, here "Top-Bottom", packs as the JAX
    package packs it: letterboxed eyes side by side), the anaglyph in the
    reference's BGR convention."""
    left, right = _eyes(seed=2, h=36, w=64)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    kw = dict(vr_eye_hw=(40, 36), anaglyph_bgr_convention=True)
    with jax.disable_jit():
        jl, jr = jformats.pack_per_eye(jnp.asarray(left).astype(jdt),
                                       jnp.asarray(right).astype(jdt), fmt, 48, 32)
        want = np.asarray(jformats.format_3d_output(jl, jr, fmt, **kw), np.float32)
    tl, tr = tformats.pack_per_eye(torch.from_numpy(left).to(tdt),
                                   torch.from_numpy(right).to(tdt), fmt, 48, 32)
    got = tformats.format_3d_output(tl, tr, fmt, **kw)
    assert got.dtype == tdt and tuple(got.shape) == want.shape
    # the letterbox's area resize differs by a float32 ulp here and there,
    # which can flip a bf16 rounding
    if dtype == "float32":
        tol = 1e-6
    else:
        tol = 2.0 ** -7 if fmt == "Red-Cyan Anaglyph" else 2.0 ** -8
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=0)


def test_interlaced_rows():
    left, right = _eyes(seed=4)
    out = tformats.interlaced(torch.from_numpy(left), torch.from_numpy(right)).numpy()
    np.testing.assert_array_equal(out[::2], left[::2])
    np.testing.assert_array_equal(out[1::2], right[1::2])


RENDER_FORMATS = {"vr": ("VR", False, (2, 1600, 2880, 3)),
                  "anaglyph": ("Red-Cyan Anaglyph", False, (8, H, W, 3)),
                  "anaglyph_bgr": ("Red-Cyan Anaglyph", True, (8, H, W, 3)),
                  "interlaced": ("Passive Interlaced", False, (8, H, W, 3))}


def _renders(tmp_path, clip, depth, tcfg: dict, jcfg: dict | None = None, n=None):
    jcfg = dict(tcfg if jcfg is None else jcfg)
    jpipe.render_stereo_video(clip, depth, tmp_path / "jax.y4m", None,
                              jpipe.RenderConfig(mesh="off", **jcfg))
    prog = tpipe.render_stereo_video(clip, depth, tmp_path / "port.y4m", None,
                                     tpipe.RenderConfig(device="cpu", **tcfg))
    want, got = _read(tmp_path / "jax.y4m"), _read(tmp_path / "port.y4m")
    assert got.shape == want.shape
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.mean() <= 0.1 and diff.max() <= 3, (diff.mean(), diff.max())
    return prog, got


@pytest.mark.parametrize("case", sorted(RENDER_FORMATS))
def test_render_format_matches_jax(case, tmp_path):
    fmt, bgr, shape = RENDER_FORMATS[case]
    clip, depth = tmp_path / "clip.y4m", tmp_path / "depth.y4m"
    n = shape[0]
    _write_clip(clip, n)
    _write_depth(depth, n)
    prog, got = _renders(tmp_path, clip, depth,
                         dict(output_format=fmt, anaglyph_bgr_convention=bgr,
                              preserve_original_aspect=True, chunk_size=4))
    assert prog.frames_done == n and got.shape == shape


# ---------------------------------------------------------------- blank frames


def test_frame_is_blank_matches_jax():
    rng = np.random.default_rng(0)
    frames = [np.zeros((16, 16, 3), np.uint8), np.full((16, 16, 3), 255, np.uint8),
              rng.integers(0, 256, (16, 16, 3)).astype(np.uint8),
              np.full((16, 16, 3), 20, np.uint8), np.full((16, 16, 3), 30, np.uint8)]
    frames[3][0, 0] = 255  # 1 of 256 pixels bright: still blank (> 98 % dark)
    for f in frames:
        for mode in ("black", "white"):
            assert tblack.frame_is_blank(f, mode) == jblack.frame_is_blank(f, mode)
    assert tblack.frame_is_blank(frames[0]) and not tblack.frame_is_blank(frames[2])


def test_detect_blank_frames_matches_jax(tmp_path):
    """The frame-scan detector (no ffmpeg here) and its sidecar cache: the
    port's and the JAX package's give the same indices and read each
    other's cache."""
    clip = tmp_path / "clip.y4m"
    _write_clip(clip, 10, blank=(3, 4, 7))
    assert not tblack.ff.have_ffmpeg()
    got = tblack.detect_blank_frames(str(clip), 24.0, cache=False)
    assert got == jblack.detect_blank_frames(str(clip), 24.0, cache=False) == [3, 4, 7]
    tblack.save_cache(str(clip), [1, 2])
    assert jblack.detect_blank_frames(str(clip), 24.0) == [1, 2]
    assert tblack.detect_blank_frames(str(clip), 24.0) == [1, 2]


def test_render_blank_frames_matches_jax(tmp_path):
    clip, depth = tmp_path / "clip.y4m", tmp_path / "depth.y4m"
    _write_clip(clip, 8, blank=(2, 3, 6))
    _write_depth(depth, 8)
    _, got = _renders(tmp_path, clip, depth, dict(skip_blank_frames=True,
                                                  preserve_original_aspect=True, chunk_size=4))
    for i in range(8):  # a blank frame's halves are the same source
        assert np.array_equal(got[i, :, :W], got[i, :, W:]) == (i in (2, 3, 6)), i


def test_blank_detection_failure_warns_and_skips_nothing(tmp_path, pair, monkeypatch, capsys):
    clip, depth = pair

    def broken(*a, **k):
        raise OSError("no such decoder")

    monkeypatch.setattr(tblack, "detect_blank_frames", broken)
    cfg = tpipe.RenderConfig(device="cpu", preserve_original_aspect=True, chunk_size=4)
    tpipe.render_stereo_video(clip, depth, tmp_path / "plain.y4m", None, cfg)
    tpipe.render_stereo_video(clip, depth, tmp_path / "x.y4m", None,
                              dataclasses.replace(cfg, skip_blank_frames=True))
    assert "warning: blank-frame detection failed (OSError: no such decoder)" in \
        capsys.readouterr().err
    np.testing.assert_array_equal(_read(tmp_path / "x.y4m"), _read(tmp_path / "plain.y4m"))


# ---------------------------------------------------------------- black bars


@pytest.mark.parametrize("case", ["letterbox", "top_only", "all_black", "none", "dim_rows"])
def test_detect_black_bars_matches_jax(case):
    rng = np.random.default_rng(1)
    f = rng.integers(40, 220, (60, 80, 3)).astype(np.uint8)
    if case == "letterbox":
        f[:9] = 0
        f[-7:] = 3
    elif case == "top_only":
        f[:12] = 0
    elif case == "all_black":
        f[:] = 0
    elif case == "dim_rows":
        f[:5] = 12  # mean luma 12 > 10: not a bar
    got = tpipe._detect_black_bars_host(f)
    assert got == jpipe._detect_black_bars_host(f)
    assert got == {"letterbox": (9, 7), "top_only": (12, 0), "all_black": (0, 0),
                   "none": (0, 0), "dim_rows": (0, 0)}[case]


def test_render_black_bar_crop_matches_jax(tmp_path):
    """A 64x48 clip with 6 black rows top and bottom, cropped to 64x36 then
    to the 16:9 target, rendered at 1080p Half-SBS geometry (960x540 eyes)
    on both sides."""
    clip, depth = tmp_path / "clip.y4m", tmp_path / "depth.y4m"
    _write_clip(clip, 2, bars=6)
    _write_depth(depth, 2)
    kw = dict(auto_crop_black_bars=True, output_format="Half-SBS", output_height=72,
              chunk_size=2)
    _, got = _renders(tmp_path, clip, depth, kw)
    geom = tpipe.resolve_geometry(W, H, "Half-SBS", 72, crop_black_top=6, crop_black_bottom=6)
    assert (geom.crop_y, geom.crop_h) == (6, 36)
    assert got.shape == (2, geom.out_h, geom.out_w, 3)


# ---------------------------------------------------------------- resume


def _cancel_after(chunks):
    calls = {"n": 0}

    def check():
        calls["n"] += 1
        return calls["n"] > chunks

    return check


def test_resume_is_bit_identical(tmp_path, pair):
    clip, depth = pair
    cfg = tpipe.RenderConfig(device="cpu", preserve_original_aspect=True, chunk_size=2,
                             checkpoint_every_chunks=1)
    tpipe.render_stereo_video(clip, depth, tmp_path / "full.y4m", None, cfg)
    part = tmp_path / "part.y4m"
    prog = tpipe.render_stereo_video(clip, depth, part, None, cfg,
                                     cancel_check=_cancel_after(2))
    assert prog.frames_done == 4 and tresume.checkpoint_path(part).exists()
    assert _read(part).shape[0] == 4
    prog = tpipe.render_stereo_video(clip, depth, part, None,
                                     dataclasses.replace(cfg, resume=True))
    assert prog.frames_done == 8
    assert part.read_bytes() == (tmp_path / "full.y4m").read_bytes()
    assert not tresume.checkpoint_path(part).exists()  # cleared at the end


def test_resume_fused_route_truncates(tmp_path):
    """The fused route reads raw planes, which the resume fast-forwards.
    The checkpoint is every second chunk, so the cancelled file holds a
    chunk past its checkpoint and is cut back before the append."""
    from visiondepth3d_tpu_torch.depth import configs as tconfigs
    from visiondepth3d_tpu_torch.depth.model import DepthPredictor, build_random

    clip = tmp_path / "clip.y4m"
    _write_clip(clip, 10)
    pred = DepthPredictor(build_random(tconfigs.DA_TINY, 1), 28, device="cpu")
    cfg = tpipe.RenderConfig(device="cpu", preserve_original_aspect=True, chunk_size=2,
                             checkpoint_every_chunks=2)
    tpipe.render_stereo_video(clip, None, tmp_path / "full.y4m", None, cfg, predictor=pred)
    part = tmp_path / "part.y4m"
    tpipe.render_stereo_video(clip, None, part, None, cfg, cancel_check=_cancel_after(3),
                              predictor=pred)
    assert _read(part).shape[0] == 6
    idx, _ = tresume.load_checkpoint(part, tinit(H, W, "cpu"))
    assert idx == 4
    tpipe.render_stereo_video(clip, None, part, None, dataclasses.replace(cfg, resume=True),
                              predictor=pred)
    assert part.read_bytes() == (tmp_path / "full.y4m").read_bytes()


def _trackers_np(rng, h=6, w=8):
    return {"initialized": np.bool_(True), "prev_depth": rng.random((h, w), dtype=np.float32),
            "prev_norm_depth": rng.random((h, w), dtype=np.float32),
            "norm_lo": np.float32(0.1), "norm_hi": np.float32(0.9), "norm_init": np.bool_(True),
            "conv_val": np.float32(-0.01), "conv_init": np.bool_(True),
            "fg": np.float32(7.5), "mg": np.float32(-2.5), "bg": np.float32(-5.5),
            "shift_init": np.bool_(True), "fw_offset": np.float32(0.123),
            "fw_counter": np.int32(41), "bar_width": np.float32(12.0),
            "focal": np.float32(0.45), "focal_init": np.bool_(False)}


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoints_interchange_with_jax(tmp_path, writer):
    vals = _trackers_np(np.random.default_rng(0))
    out = tmp_path / "o.y4m"
    if writer == "jax":
        jresume.save_checkpoint(out, 42, jinit(6, 8).replace(
            **{k: jnp.asarray(v) for k, v in vals.items()}))
        idx, t = tresume.load_checkpoint(out, tinit(6, 8, "cpu"))
        get = lambda name: getattr(t, name).numpy()  # noqa: E731
    else:
        tresume.save_checkpoint(out, 42, tinit(6, 8, "cpu").replace(
            **{k: torch.from_numpy(np.asarray(v)) for k, v in vals.items()}))
        idx, t = jresume.load_checkpoint(out, jinit(6, 8))
        get = lambda name: np.asarray(getattr(t, name))  # noqa: E731
    assert idx == 42 and tresume.checkpoint_path(out) == jresume.checkpoint_path(out)
    assert [f.name for f in dataclasses.fields(tinit(1, 1, "cpu"))] == list(TRACKER_FIELDS)
    for name, v in vals.items():
        got = get(name)
        assert got.dtype == np.asarray(v).dtype and np.array_equal(got, v), name


def test_truncate_y4m_matches_jax(tmp_path):
    for name in ("a.y4m", "b.y4m"):
        _write_clip(tmp_path / name, 5, h=10, w=14)
    tresume.truncate_y4m_to(tmp_path / "a.y4m", 3)
    jresume.truncate_y4m_to(tmp_path / "b.y4m", 3)
    assert (tmp_path / "a.y4m").read_bytes() == (tmp_path / "b.y4m").read_bytes()
    assert _read(tmp_path / "a.y4m").shape[0] == 3


# ---------------------------------------------------------------- batch


def _batch_dirs(tmp_path, names=("one", "two"), n=4):
    vids, deps = tmp_path / "vids", tmp_path / "deps"
    vids.mkdir()
    deps.mkdir()
    for name in names:
        _write_clip(vids / f"{name}.y4m", n)
        _write_depth(deps / f"{name}_depth.y4m", n)
    return vids, deps


def test_batch_pairing_and_run(tmp_path):
    vids, deps = _batch_dirs(tmp_path)
    outs = tmp_path / "outs"
    items = tbatch.pair_videos_with_depth(vids, deps, outs)
    jitems = __import__("visiondepth3d_tpu.pipeline.batch",
                        fromlist=["x"]).pair_videos_with_depth(vids, deps, outs)
    assert [dataclasses.asdict(i) for i in items] == [dataclasses.asdict(i) for i in jitems]
    cfg = tpipe.RenderConfig(device="cpu", preserve_original_aspect=True, chunk_size=2)
    done = tbatch.run_batch(items, TParams(), cfg)
    assert [i.status for i in done] == ["done", "done"] and done[0].frames == 4
    for name in ("one", "two"):
        assert _read(outs / f"{name}_3D.y4m").shape == (4, H, 2 * W, 3)


def test_batch_continue_on_error(tmp_path, pair):
    clip, depth = pair
    items = [tbatch.BatchItem(str(tmp_path / "missing.y4m"), str(depth),
                              str(tmp_path / "bad_3D.y4m")),
             tbatch.BatchItem(str(clip), str(depth), str(tmp_path / "ok_3D.y4m"))]
    cfg = tpipe.RenderConfig(device="cpu", preserve_original_aspect=True, chunk_size=4)
    done = tbatch.run_batch(items, TParams(), cfg)
    assert done[0].status == "error" and done[1].status == "done"
    assert done[0].error.startswith("OSError")


def test_pair_skips_depth_sidecars_in_video_dir(tmp_path):
    for name in ("a.y4m", "a_depth.y4m"):
        _write_clip(tmp_path / name, 1, h=16, w=32)
    items = tbatch.pair_videos_with_depth(tmp_path, tmp_path, tmp_path)
    assert [Path(i.input_path).name for i in items] == ["a.y4m"]
    assert Path(items[0].depth_path).name == "a_depth.y4m"


def test_batch_cancel_marks_the_rest(tmp_path):
    vids, deps = _batch_dirs(tmp_path, n=2)
    items = tbatch.pair_videos_with_depth(vids, deps, tmp_path / "outs")
    done = tbatch.run_batch(items, TParams(), tpipe.RenderConfig(device="cpu"),
                            cancel_check=lambda: True)
    assert [i.status for i in done] == ["cancelled", "cancelled"]


# ---------------------------------------------------------------- control


@pytest.mark.parametrize("make", [tcontrol, jcontrol], ids=["port", "jax"])
def test_make_control_check(tmp_path, make):
    """Missing file and 'run' go on, 'cancel' stops, 'pause' blocks until
    the content changes: the port's copy and the JAX function alike."""
    ctl = tmp_path / "ctl"
    check = make(str(ctl), poll_s=0.05)
    assert check() is False
    ctl.write_text("run")
    assert check() is False
    ctl.write_text(" Cancel\n")
    assert check() is True
    ctl.write_text("pause")
    released = []
    th = threading.Thread(target=lambda: released.append(check()))
    th.start()
    time.sleep(0.15)
    assert not released
    ctl.write_text("run")
    th.join(timeout=2.0)
    assert released == [False]


# ---------------------------------------------------------------- presets


def test_preset_clamping_and_round_trip(tmp_path):
    path = tmp_path / "p.json"
    path.write_text(json.dumps({"fg_shift": 9999.0, "parallax_balance": -5.0,
                                "blur_ksize": 99, "enable_healing": 1.0}))
    p, cfg = tpresets.load_preset(path)
    jp, _ = jpresets.load_preset(path)
    assert (p.fg_shift, p.parallax_balance, p.blur_ksize) == (30.0, 0.1, 15)
    assert (float(jp.fg_shift), float(jp.parallax_balance), jp.blur_ksize) == (30.0, 0.1, 15)
    assert p.enable_healing is True and isinstance(p.blur_ksize, int)
    params = TParams(fg_shift=11.0, image_dtype="bfloat16", dof_backend="torch",
                     enable_healing=True)
    cfg = tpipe.RenderConfig(output_format="Half-SBS", device="cpu", resume=True)
    tpresets.save_preset(tmp_path / "out.json", params, cfg)
    p2, cfg2 = tpresets.load_preset(tmp_path / "out.json")
    assert p2 == params and cfg2 == cfg


def test_port_preset_loads_in_jax_and_back(tmp_path):
    """A port preset with its own fields (dof_backend, device) loads through
    the JAX function, which drops them; a JAX preset loads in the port,
    which drops the JAX package's own fields and maps its backend names."""
    params = TParams(fg_shift=12.0, dof_strength=2.0, dof_backend="torch", quantile_mode="exact")
    tpresets.save_preset(tmp_path / "port.json", params,
                         tpipe.RenderConfig(output_format="VR", device="cpu"))
    jp, jcfg = jpresets.load_preset(tmp_path / "port.json")
    assert (float(jp.fg_shift), jp.dof_strength, jp.quantile_mode) == (12.0, 2.0, "exact")
    assert jcfg.output_format == "VR"

    jpresets.save_preset(tmp_path / "jax.json",
                         JParams(bg_shift=-9.0, warp_backend="pallas", postfx_backend="xla"),
                         jpipe.RenderConfig(chunk_size=8, skip_blank_frames=True))
    p, cfg = tpresets.load_preset(tmp_path / "jax.json")
    assert (p.bg_shift, p.warp_backend, p.postfx_backend) == (-9.0, "cuda", "torch")
    assert (cfg.chunk_size, cfg.skip_blank_frames, cfg.device) == (8, True, "cuda")


@pytest.mark.parametrize("name", sorted(jpresets.BUILTIN_PRESETS))
def test_builtin_presets_match_jax(name):
    assert tpresets.BUILTIN_PRESETS[name] == jpresets.BUILTIN_PRESETS[name]
    p, _ = tpresets.load_builtin(name)
    jp, _ = jpresets.load_builtin(name)
    for f in dataclasses.fields(TParams):
        if hasattr(jp, f.name) and f.name not in ("warp_backend", "postfx_backend"):
            assert getattr(p, f.name) == pytest.approx(getattr(jp, f.name)), f.name


# ---------------------------------------------------------------- CLI


def test_cli_dry_run_matches_jax(capsys):
    argv = ["render", "--input", "a.y4m", "--depth", "d.y4m", "--dry-run", "--fg_shift", "12.5",
            "--format", "Half-SBS", "--preset", "best3d"]
    assert cli_main(argv + ["--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out)
    from visiondepth3d_tpu.cli.main import main as jmain

    assert jmain(argv) == 0
    want = json.loads(capsys.readouterr().out)
    assert got["output"] == want["output"] == "a_Half-SBS.y4m"
    for k, v in want["params"].items():
        if k in got["params"] and k not in ("mesh", "warp_backend", "postfx_backend"):
            assert got["params"][k] == v, k
    assert got["params"]["fg_shift"] == 12.5 and got["params"]["feather_strength"] == 12.0
    assert got["params"]["device"] == "cpu"


def test_cli_batch_dry_run_and_run(tmp_path, capsys):
    vids, deps = _batch_dirs(tmp_path, n=2)
    outs = tmp_path / "outs"
    base = ["render", "--batch-videos", str(vids), "--batch-depths", str(deps), "--batch-out",
            str(outs), "--device", "cpu", "--preserve-aspect", "--chunk-size", "2"]
    assert cli_main(base + ["--dry-run"]) == 0
    items = json.loads(capsys.readouterr().out)["items"]
    assert [Path(i["output_path"]).name for i in items] == ["one_3D.y4m", "two_3D.y4m"]
    assert cli_main(base) == 0
    assert _read(outs / "two_3D.y4m").shape == (2, H, 2 * W, 3)


def test_cli_control_cancel_and_resume(tmp_path, pair):
    """``--control`` with 'cancel' stops before the first chunk, leaving no
    frame and no sidecar; the same render with --resume and 'run' then
    renders every frame. A preset's RenderConfig fields reach the render
    (the BGR anaglyph of a preset file against the flag-free default)."""
    clip, depth = pair
    ctl, out = tmp_path / "ctl", tmp_path / "out.y4m"
    ctl.write_text("cancel")
    base = ["render", "--input", str(clip), "--depth", str(depth), "--device", "cpu",
            "--preserve-aspect", "--chunk-size", "4"]
    argv = base + ["--output", str(out), "--control", str(ctl)]
    assert cli_main(argv) == 0
    with Y4MReader(str(out)) as rd:
        assert rd.count() == 0
    ctl.write_text("run")
    assert cli_main(argv + ["--resume"]) == 0
    assert _read(out).shape == (8, H, 2 * W, 3)
    preset = tmp_path / "bgr.json"
    preset.write_text(json.dumps({"anaglyph_bgr_convention": True}))
    outs = {}
    for name, extra in (("rgb", []), ("bgr", ["--preset", str(preset)])):
        outs[name] = tmp_path / f"{name}.y4m"
        assert cli_main(base + ["--output", str(outs[name]), "--format", "Red-Cyan Anaglyph",
                                *extra]) == 0
    rgb, bgr = _read(outs["rgb"]), _read(outs["bgr"])
    assert rgb.shape == bgr.shape == (8, H, W, 3) and np.abs(rgb.astype(int) - bgr).max() > 8
