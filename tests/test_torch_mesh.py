"""The port's device meshes (frame-segment DP, the two-stage pipeline, the
DP depth route, frame tools and DepthCrafter windows) against the JAX
package, on the CPU twice (``[cpu, cpu]``), and the kernels' device entry.

Toy shapes: 64x48 clips of 12 frames, ``DA_TINY`` at 28^2, data from numpy
seeds. JAX runs its own meshes on the virtual CPU devices of
``tests/conftest.py``. Tolerances are the surface tests' (mean |d| <= 0.1
and max |d| <= 3 u8 steps, ``tests/test_torch_surface.py``) unless a case
says otherwise:

- the mesh helpers (``parse_mesh_spec`` on the JAX test's table,
  ``segment_bounds`` with and without cuts, ``count_video_frames``,
  ``_concat_y4m``) equal the JAX package's; ``render_segments`` equals
  ``render_chunk`` per segment;
- ``dp=2`` renders equal the port's single-device renders of the two
  segments, concatenated, byte for byte, on the depth-file and the fused
  route; against JAX's ``mesh="dp=2"`` within the bound;
- ``pp=2`` equals the port's single-device fused render byte for byte;
  JAX's ``pp=2`` within the bound;
- the ``dp=2`` depth route equals one device at the per-device sub-batch
  byte for byte; JAX's ``dp=2`` within the bound;
- ``dp=2`` frame tools equal one device byte for byte; JAX's
  ``mesh_axes={"dp": 2}`` within the bound on the written planes;
- DepthCrafter's ``run_raw_parallel`` with JAX's noise injected through
  the one noise method: within 1e-4 of the depth's range, float32; the
  route with ``mesh="dp=2"`` writes every frame;
- ``dp=2,sp=2`` over [cpu] * 4 equals the two segments rendered alone,
  byte for byte; ``sp=2`` on the fused route and ``pp=2,dp=2`` equal one
  device at the per-device chunk (``chunk_size / 2``) byte for byte, and
  JAX's one-device render within the bound (the row bands themselves are
  held to one device in ``tests/test_torch_halo.py``);
- ``render_chunk_spatial`` equals ``render_chunk``; a mesh with too few
  devices for its axes raises ValueError (``depth --mesh sp=3`` on two
  devices too); ``resume`` or a clip window with a ``dp`` mesh raises
  ValueError;
  the default ``auto`` with a window renders the window on one device; a
  cancelled ``dp=2`` render keeps a gapless start of the clip;
- every kernel wrapper launches through ``kernels/_lib.launch``, which
  enters the input's device; on a card (``cuda`` marker) every kernel runs
  from a fresh thread inside ``torch.cuda.device(0)``, the dp and pp
  renders run over ``[cuda:0, cuda:0]``, and a CPU predictor replicated
  to the card predicts what the original does.
"""

from __future__ import annotations

import dataclasses
import inspect
import re
import threading
from pathlib import Path

import numpy as np
import pytest
import torch
torch.set_num_threads(1)

from test_torch_reference import bounded
from visiondepth3d_tpu_torch.depth import configs as tconfigs
from visiondepth3d_tpu_torch.depth.dpt import DepthAnything
from visiondepth3d_tpu_torch.depth.model import DepthPredictor
from visiondepth3d_tpu_torch.io import Y4MPlaneReader, Y4MReader, Y4MWriter
from visiondepth3d_tpu_torch.kernels import _lib, attention, conv, dof, postfx, stats, warp
from visiondepth3d_tpu_torch.parallel import make_mesh, replicate, segment_bounds
from visiondepth3d_tpu_torch.pipeline import mesh_render
from visiondepth3d_tpu_torch.pipeline.depth_pipeline import DepthConfig, render_depth_video_file
from visiondepth3d_tpu_torch.pipeline.stereo_pipeline import RenderConfig, render_stereo_video

REPO = str(Path(__file__).resolve().parents[1])
H, W, T = 48, 64, 12
SIZE = 28
CPU2 = [torch.device("cpu")] * 2


def _write_clip(path, t=T, offset=0):
    yy, xx = np.mgrid[0:H, 0:W]
    with Y4MWriter(str(path), W, H, 24.0) as wr:
        for i in range(offset, offset + t):
            f = np.zeros((H, W, 3), np.uint8)
            f[..., 0] = (xx * 3 + i * 7) % 256
            f[..., 1] = (yy * 5) % 256
            f[..., 2] = 90
            x0 = (2 * i) % (W - 10)
            f[10:30, x0:x0 + 10] = (250, 40, 40)
            wr.write(f)


def _write_depth(path, t=T, offset=0):
    yy, xx = np.mgrid[0:H, 0:W]
    with Y4MWriter(str(path), W, H, 24.0) as wr:
        for i in range(offset, offset + t):
            d = (xx / W * 180 + 30).astype(np.uint8)
            x0 = (2 * i) % (W - 10)
            d[10:30, x0:x0 + 10] = 40
            wr.write(np.repeat(d[..., None], 3, -1))


def _read(path):
    with Y4MReader(str(path)) as rd:
        return np.stack(list(rd))


def _luma(path):
    with Y4MPlaneReader(str(path)) as rd:
        return np.stack([y for y, _, _ in iter(rd.read, None)])


def _within_bound(got, want):
    assert got.shape == want.shape, (got.shape, want.shape)
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.mean() <= 0.1 and diff.max() <= 3, (diff.mean(), diff.max())


def _cfg(**kw):
    return RenderConfig(preserve_original_aspect=True, chunk_size=4, device="cpu", **kw)


@pytest.fixture(scope="module")
def weights():
    """DA_TINY's JAX params at 28^2 (seed 1) and the port's predictor on them."""
    from visiondepth3d_tpu.depth.configs import DA_TINY
    from visiondepth3d_tpu.depth.model import init_random
    from visiondepth3d_tpu_torch.depth.convert import from_jax_params, load_hf_state_dict

    params = init_random(DA_TINY, seed=1, size=SIZE)
    model = DepthAnything(tconfigs.DA_TINY)
    load_hf_state_dict(model, from_jax_params(params, tconfigs.DA_TINY))
    return params, DepthPredictor(model, SIZE, device="cpu")


def _jax_predictor(params):
    from visiondepth3d_tpu.depth.configs import DA_TINY
    from visiondepth3d_tpu.depth.model import DepthPredictor as JPredictor

    return JPredictor(DA_TINY, params, SIZE)


# ------------------------------------------------------------------ helpers

SPECS = (None, "off", "", "none", "1", "auto", "dp=4", "dp=2,sp=2", "dp=2,tp=2", "pp=2",
         "pp=1", "DP=2, sp=1", "pp=3", "ep=2", "dp", "dp=0")


@pytest.mark.parametrize("spec", SPECS)
def test_parse_mesh_spec_matches_jax(spec):
    """JAX's 'auto' counts its 8 virtual devices: the port's counts 8 given."""
    from visiondepth3d_tpu.pipeline.mesh_render import parse_mesh_spec as jparse

    try:
        want = jparse(spec)
    except ValueError:
        with pytest.raises(ValueError):
            mesh_render.parse_mesh_spec(spec, 8)
        return
    assert mesh_render.parse_mesh_spec(spec, 8) == want
    # 'auto' on one card (or a CPU run) is the single-device path
    assert mesh_render.mesh_axes_for("auto", "cpu") is None
    assert mesh_render.mesh_axes_for("auto", "cpu", CPU2) == {"dp": 2}


@pytest.mark.parametrize("total,g,cuts", [(20, 4, None), (13, 2, None), (100, 3, [0, 31, 70]),
                                          (100, 3, [0, 20, 50, 64]), (7, 3, [0, 2, 3, 6]),
                                          (40, 2, [])])
def test_segment_bounds_match_jax(total, g, cuts):
    from visiondepth3d_tpu.parallel.dp import segment_bounds as jbounds

    assert segment_bounds(total, g, cuts) == jbounds(total, g, cuts)


def test_count_and_concat_match_jax(tmp_path):
    from visiondepth3d_tpu.pipeline import mesh_render as jmesh

    for i, (t, off) in enumerate(((5, 0), (4, 5), (3, 9))):
        _write_clip(tmp_path / f"s{i}.y4m", t, off)
    segs = [str(tmp_path / f"s{i}.y4m") for i in range(3)]
    assert [mesh_render.count_video_frames(p) for p in segs] == \
        [bounded(jmesh.count_video_frames, p) for p in segs] == [5, 4, 3]
    mesh_render._concat_y4m(segs, str(tmp_path / "port.y4m"))
    jmesh._concat_y4m(segs, str(tmp_path / "jax.y4m"))
    _write_clip(tmp_path / "whole.y4m", 12)
    assert (tmp_path / "port.y4m").read_bytes() == (tmp_path / "jax.y4m").read_bytes() == \
        (tmp_path / "whole.y4m").read_bytes()


def test_make_mesh_and_replicas(weights):
    mesh = make_mesh(dp=2, devices=CPU2)
    assert mesh.shape == {"dp": 2, "sp": 1, "tp": 1} and mesh.device_list == CPU2
    assert make_mesh(sp=2, devices=CPU2).shape == {"dp": 1, "sp": 2, "tp": 1}
    with pytest.raises(AssertionError):
        make_mesh(dp=3, devices=CPU2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh()
    pred = weights[1]
    assert replicate(pred, "cpu") is pred  # a repeated device shares one copy
    moved = replicate(pred, "meta")
    assert moved.device == torch.device("meta") and moved._mean.device.type == "meta"
    assert all(p.device.type == "meta" for p in moved.model.parameters())
    assert all(p.device.type == "cpu" for p in pred.model.parameters())


def test_render_segments_match_render_chunk():
    """parallel.render_segments: each segment on its mesh device with its
    own trackers, equal to render_chunk of that segment alone; the row
    split (sp, render_chunk_spatial) equals render_chunk too."""
    from visiondepth3d_tpu_torch.parallel import init_trackers_batch, render_chunk_spatial
    from visiondepth3d_tpu_torch.parallel import render_segments
    from visiondepth3d_tpu_torch.state import init_trackers
    from visiondepth3d_tpu_torch.stereo import StereoParams
    from visiondepth3d_tpu_torch.stereo.step import render_chunk

    g = torch.Generator().manual_seed(0)
    frames, depths = torch.rand(2, 3, 24, 32, 3, generator=g), torch.rand(2, 3, 24, 32, generator=g)
    params = StereoParams(blur_ksize=3).with_shift_bound(32)
    trackers, outs = render_segments(params, init_trackers_batch(2, 24, 32, CPU2), frames,
                                     depths, make_mesh(dp=2, devices=CPU2))
    for i in range(2):
        t, want = render_chunk(params, init_trackers(24, 32, device="cpu"), frames[i], depths[i])
        assert torch.equal(outs[i].left, want.left) and torch.equal(outs[i].right, want.right)
        assert torch.equal(trackers[i].prev_depth, t.prev_depth)
    from visiondepth3d_tpu_torch.parallel.dp import spatial_layout
    from visiondepth3d_tpu_torch.stereo.bands import init_band_trackers

    mesh = make_mesh(dp=1, sp=2, devices=CPU2)
    layout = spatial_layout(params, 24, 32, mesh)
    _, got = render_chunk_spatial(params, init_band_trackers(layout, 32), frames[0], depths[0],
                                  mesh)
    _, want = render_chunk(params, init_trackers(24, 32, device="cpu"), frames[0], depths[0])
    assert torch.equal(got.left, want.left) and torch.equal(got.right, want.right)


# ------------------------------------------------------------------ renders

@pytest.mark.parametrize("route", ["depth_file", "fused"])
def test_dp_render_matches_segments_and_jax(tmp_path, weights, route):
    """12 frames on dp=2: two 6-frame segments, each a chunk of 4 and a
    padded chunk of 2. The JAX side is its per-segment renders, which the
    JAX package's own tests hold equal to its dp=2 render
    (``tests/test_mesh_product.py``), with ``device_yuv_in=False``: its
    dp route and its plane input read a clip's first frame and close the
    reader at once, and the JAX package's native reader can hang in that
    close (a lost wake-up, ``test_reader_close_never_hangs``)."""
    from visiondepth3d_tpu.pipeline.stereo_pipeline import RenderConfig as JConfig
    from visiondepth3d_tpu.pipeline.stereo_pipeline import render_stereo_video as jrender

    params, pred = weights
    _write_clip(tmp_path / "clip.y4m")
    _write_depth(tmp_path / "depth.y4m")
    depth = tmp_path / "depth.y4m" if route == "depth_file" else None
    kw = {"predictor": pred} if depth is None else {}
    prog = render_stereo_video(tmp_path / "clip.y4m", depth, tmp_path / "dp.y4m", None,
                               _cfg(mesh="dp=2"), devices=CPU2, **kw)
    assert prog.frames_done == T and prog.total_frames == T
    twin = []
    for s, e in segment_bounds(T, 2):
        _write_clip(tmp_path / f"c{s}.y4m", e - s, s)
        _write_depth(tmp_path / f"d{s}.y4m", e - s, s)
        seg_depth = tmp_path / f"d{s}.y4m" if depth is not None else None
        render_stereo_video(tmp_path / f"c{s}.y4m", seg_depth, tmp_path / f"o{s}.y4m", None,
                            _cfg(mesh="off"), **kw)
        twin.append(_read(tmp_path / f"o{s}.y4m"))
    got = _read(tmp_path / "dp.y4m")
    assert got.shape == (T, H, 2 * W, 3) and np.array_equal(got, np.concatenate(twin))
    jkw = {"predictor": _jax_predictor(params)} if depth is None else {}
    want = []
    for s, _ in segment_bounds(T, 2):
        bounded(jrender, tmp_path / f"c{s}.y4m",
                tmp_path / f"d{s}.y4m" if depth is not None else None, tmp_path / f"j{s}.y4m",
                None, JConfig(mesh="off", preserve_original_aspect=True, chunk_size=4,
                              device_yuv_in=False), **jkw)
        want.append(_read(tmp_path / f"j{s}.y4m"))
    _within_bound(got, np.concatenate(want))


def test_pp_render_matches_fused_and_jax(tmp_path, weights):
    from visiondepth3d_tpu.pipeline.stereo_pipeline import RenderConfig as JConfig
    from visiondepth3d_tpu.pipeline.stereo_pipeline import render_stereo_video as jrender

    params, pred = weights
    _write_clip(tmp_path / "clip.y4m", t=10)
    prog = render_stereo_video(tmp_path / "clip.y4m", None, tmp_path / "pp.y4m", None,
                               _cfg(mesh="pp=2"), predictor=pred, devices=CPU2)
    render_stereo_video(tmp_path / "clip.y4m", None, tmp_path / "one.y4m", None,
                        _cfg(mesh="off"), predictor=pred)
    assert prog.frames_done == 10
    assert (tmp_path / "pp.y4m").read_bytes() == (tmp_path / "one.y4m").read_bytes()
    bounded(jrender, tmp_path / "clip.y4m", None, tmp_path / "jax.y4m", None,
            JConfig(mesh="pp=2", preserve_original_aspect=True, chunk_size=4,
                    device_yuv_in=False),
            predictor=_jax_predictor(params))
    _within_bound(_read(tmp_path / "pp.y4m"), _read(tmp_path / "jax.y4m"))


def test_dp_sp_render_matches_segments(tmp_path):
    """dp=2,sp=2 over [cpu] * 4 (two segments, each in two row bands): the
    segments rendered alone on one device, concatenated, byte for byte."""
    _write_clip(tmp_path / "clip.y4m")
    _write_depth(tmp_path / "depth.y4m")
    render_stereo_video(tmp_path / "clip.y4m", tmp_path / "depth.y4m", tmp_path / "m.y4m",
                        None, _cfg(mesh="dp=2,sp=2"), devices=CPU2 * 2)
    twin = []
    for s, e in segment_bounds(T, 2):
        _write_clip(tmp_path / f"c{s}.y4m", e - s, s)
        _write_depth(tmp_path / f"d{s}.y4m", e - s, s)
        render_stereo_video(tmp_path / f"c{s}.y4m", tmp_path / f"d{s}.y4m",
                            tmp_path / f"o{s}.y4m", None, _cfg(mesh="off"))
        twin.append(_read(tmp_path / f"o{s}.y4m"))
    assert np.array_equal(_read(tmp_path / "m.y4m"), np.concatenate(twin))


@pytest.mark.parametrize("spec", ["sp=2", "pp=2,dp=2"])
def test_frame_split_renders_match_one_device_and_jax(tmp_path, weights, spec):
    """The fused sp=2 render (the model on each sp device's frames, the
    stereo step in two row bands) and pp=2,dp=2 (slice A splits the frames,
    slice B renders row bands) over the CPU: one device at chunks of 2 (the
    model's batch per device) byte for byte; JAX's one-device render
    within the bound."""
    from visiondepth3d_tpu.pipeline.stereo_pipeline import RenderConfig as JConfig
    from visiondepth3d_tpu.pipeline.stereo_pipeline import render_stereo_video as jrender

    params, pred = weights
    _write_clip(tmp_path / "clip.y4m", t=10)
    n = 2 if spec == "sp=2" else 4
    prog = render_stereo_video(tmp_path / "clip.y4m", None, tmp_path / "mesh.y4m", None,
                               _cfg(mesh=spec), predictor=pred, devices=CPU2[:1] * n)
    render_stereo_video(tmp_path / "clip.y4m", None, tmp_path / "one.y4m", None,
                        dataclasses.replace(_cfg(mesh="off"), chunk_size=2), predictor=pred)
    assert prog.frames_done == 10
    assert (tmp_path / "mesh.y4m").read_bytes() == (tmp_path / "one.y4m").read_bytes()
    bounded(jrender, tmp_path / "clip.y4m", None, tmp_path / "jax.y4m", None,
            JConfig(mesh="off", preserve_original_aspect=True, chunk_size=4,
                    device_yuv_in=False),
            predictor=_jax_predictor(params))
    _within_bound(_read(tmp_path / "mesh.y4m"), _read(tmp_path / "jax.y4m"))


def test_degenerate_clip_and_snapped_segments(tmp_path):
    """Under 2 x dp frames the clip renders on the first device; with
    --mesh-snap-scenes the segments snap to a detected cut."""
    _write_clip(tmp_path / "tiny.y4m", t=3)
    _write_depth(tmp_path / "tinyd.y4m", t=3)
    prog = render_stereo_video(tmp_path / "tiny.y4m", tmp_path / "tinyd.y4m",
                               tmp_path / "o.y4m", None, _cfg(mesh="dp=2"), devices=CPU2)
    assert prog.frames_done == 3 and _read(tmp_path / "o.y4m").shape == (3, H, 2 * W, 3)
    _write_clip(tmp_path / "clip.y4m", t=40)
    _write_depth(tmp_path / "depth.y4m", t=40)
    prog = render_stereo_video(tmp_path / "clip.y4m", tmp_path / "depth.y4m",
                               tmp_path / "s.y4m", None,
                               _cfg(mesh="dp=2", mesh_snap_scenes=True), devices=CPU2)
    assert prog.frames_done == 40 and _read(tmp_path / "s.y4m").shape[0] == 40


def test_auto_mesh_with_a_window_renders_the_window(tmp_path, weights):
    """The default mesh, 'auto', over two devices with a clip window stays
    on one device: the window's frames, as mesh='off' renders them."""
    _write_clip(tmp_path / "clip.y4m")
    win = dict(start_s=2 / 24, end_s=8 / 24)
    out = {}
    for mesh in ("auto", "off"):
        prog = render_stereo_video(tmp_path / "clip.y4m", None, tmp_path / f"{mesh}.y4m", None,
                                   _cfg(mesh=mesh, **win), predictor=weights[1], devices=CPU2)
        out[mesh] = _read(tmp_path / f"{mesh}.y4m")
        assert 0 < prog.frames_done == out[mesh].shape[0] < T
    assert np.array_equal(out["auto"], out["off"])


def test_cancelled_dp_render_keeps_a_gapless_start(tmp_path):
    """Cancelled after one round (a chunk of 4 in each 6-frame segment), a
    dp=2 render keeps segment 0's 4 frames and drops segment 1's, so the
    output is the start of the one-device render."""
    _write_clip(tmp_path / "clip.y4m")
    _write_depth(tmp_path / "depth.y4m")
    polls = iter([False])
    prog = render_stereo_video(tmp_path / "clip.y4m", tmp_path / "depth.y4m",
                               tmp_path / "dp.y4m", None, _cfg(mesh="dp=2"),
                               cancel_check=lambda: next(polls, True), devices=CPU2)
    render_stereo_video(tmp_path / "clip.y4m", tmp_path / "depth.y4m", tmp_path / "one.y4m",
                        None, _cfg(mesh="off"))
    got = _read(tmp_path / "dp.y4m")
    assert prog.frames_done == got.shape[0] == 4
    assert np.array_equal(got, _read(tmp_path / "one.y4m")[:4])
    assert not list(tmp_path.glob("*.seg*"))


# ------------------------------------------------------------------ depth, tools

def test_dp_depth_route_matches_sub_batch_and_jax(tmp_path, weights):
    from visiondepth3d_tpu.pipeline.depth_pipeline import DepthConfig as JConfig
    from visiondepth3d_tpu.pipeline.depth_pipeline import render_depth_video_file as jroute

    params, pred = weights
    _write_clip(tmp_path / "clip.y4m", t=10)
    kw = dict(inference_size=SIZE)
    assert render_depth_video_file(tmp_path / "clip.y4m", tmp_path / "dp.y4m",
                                   DepthConfig(device="cpu", batch_size=4, mesh="dp=2", **kw),
                                   predictor=pred, devices=CPU2) == 10
    assert render_depth_video_file(tmp_path / "clip.y4m", tmp_path / "one.y4m",
                                   DepthConfig(device="cpu", batch_size=2, mesh="off", **kw),
                                   predictor=pred) == 10
    assert (tmp_path / "dp.y4m").read_bytes() == (tmp_path / "one.y4m").read_bytes()
    assert bounded(jroute, tmp_path / "clip.y4m", tmp_path / "jax.y4m",
                   JConfig(batch_size=4, mesh="dp=2", **kw),
                   predictor=_jax_predictor(params)) == 10
    _within_bound(_luma(tmp_path / "dp.y4m"), _luma(tmp_path / "jax.y4m"))


def _seeded_jax_params(model, seed, *inputs, jitter=0.0):
    """A flax model's params drawn from a numpy seed on the shapes of its
    init (``jax.eval_shape``: nothing is compiled): kernels N(0, 1/fan_in),
    the other leaves their init's value (PReLU 0.25, residual beta 1, bias
    0) plus ``jitter`` x N(0, 1)."""
    import jax

    rng = np.random.default_rng(seed)
    base = {"alpha": 0.25, "beta": 1.0}

    def draw(path, shape):
        name = path[-1].key
        if name == "kernel":
            return rng.standard_normal(shape.shape).astype(np.float32) * np.prod(
                shape.shape[:-1]) ** -0.5
        return (base.get(name, 0.0) + jitter * rng.standard_normal(shape.shape)).astype(
            np.float32)

    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(seed), *inputs)["params"]
    return jax.tree_util.tree_map_with_path(draw, shapes)


def test_dp_tools_match_one_device_and_jax(tmp_path):
    """ESRGAN x4 + RIFE x2 over 6 frames in chunks of 3: each chunk's 4
    frames split into runs of 2 and 3 frames sharing one."""
    from test_torch_enhance import _np, _planes, _write_clip as write_tools_clip
    from visiondepth3d_tpu.enhance import esrgan as jesr
    from visiondepth3d_tpu.enhance import rife as jrife
    from visiondepth3d_tpu.enhance.pipeline import EnhanceConfig as JConfig
    from visiondepth3d_tpu.enhance.pipeline import run_merged_pipeline as jrun
    from visiondepth3d_tpu_torch.enhance import rife as trife
    from visiondepth3d_tpu_torch.enhance.convert import (ifnet_from_jax_params,
                                                         rrdbnet_from_jax_params)
    from visiondepth3d_tpu_torch.enhance.pipeline import EnhanceConfig, run_merged_pipeline

    src = tmp_path / "in.y4m"
    write_tools_clip(src, 32, 24, 6)
    kw = dict(esrgan_nf=8, esrgan_nb=1, esrgan_gc=8, esrgan_scale=4, use_rife=True,
              fps_multiplier=2, chunk_size=3)
    x = np.zeros((1, 16, 16, 3), np.float32)
    jep = _seeded_jax_params(jesr.RRDBNet(nf=8, nb=1, gc=8, scale=4), 0, x, jitter=0.02)
    rcfg = jrife.IFNetConfig(cs=(16, 8), scales=(2, 1), n_res=2)
    jrp = _seeded_jax_params(rcfg.build(), 1, x, x, jitter=0.05)
    tcfg = trife.IFNetConfig(**dataclasses.asdict(rcfg))
    weights = dict(esrgan_params=rrdbnet_from_jax_params(_np(jep)),
                   rife_params=(ifnet_from_jax_params(_np(jrp), tcfg), tcfg))
    outs = {}
    for name, axes in (("one", None), ("dp", {"dp": 2})):
        outs[name] = run_merged_pipeline(src, tmp_path / f"{name}.y4m", EnhanceConfig(**kw),
                                         mesh_axes=axes, device="cpu", **weights)
    assert outs["one"] == outs["dp"] == 11
    assert (tmp_path / "dp.y4m").read_bytes() == (tmp_path / "one.y4m").read_bytes()
    assert jrun(src, tmp_path / "jax.y4m", JConfig(**kw), esrgan_params=jep,
                rife_params=(jrp, rcfg), mesh_axes={"dp": 2}) == 11
    got, _ = _planes(tmp_path / "dp.y4m")
    want, _ = _planes(tmp_path / "jax.y4m")
    for i in range(3):
        _within_bound(np.stack([f[i] for f in got]), np.stack([f[i] for f in want]))


# ------------------------------------------------------------------ DepthCrafter

@pytest.fixture(scope="module")
def crafter():
    """(the port's tiny DepthCrafter pipeline, the JAX one) on one set of
    seeded weights, as ``tests/test_torch_depthcrafter.py`` builds them."""
    import test_torch_depthcrafter as tdc
    from test_torch_diffusion import _quant_convs, _redraw
    from visiondepth3d_tpu.depth.diffusion import convert_diffusers as jconv
    from visiondepth3d_tpu.depth.diffusion import depthcrafter as jdc
    from visiondepth3d_tpu.depth.diffusion.unet_st import UNET_ST_TINY as JUNET_TINY
    from visiondepth3d_tpu.depth.diffusion.vae import VAE_TINY as JVAE_TINY
    from visiondepth3d_tpu_torch.depth.diffusion import (UNET_ST_TINY, VAE_TINY, AutoencoderKL,
                                                         CLIPVisionEncoder, UNetSpatioTemporal)

    unet = _redraw(UNetSpatioTemporal(UNET_ST_TINY), seed=1)
    rng = np.random.default_rng(2)
    for k in unet:
        if k.endswith("mix_factor"):
            unet[k] = rng.standard_normal(1).astype(np.float32)
    vae = _quant_convs(_redraw(AutoencoderKL(VAE_TINY), seed=3), seed=4)
    vae["post_quant_conv.bias"] = np.zeros(4, np.float32)
    states = (unet, vae, _redraw(CLIPVisionEncoder(tdc.CLIP), seed=5))
    jpipe = jdc.DepthCrafterPipeline(
        JUNET_TINY, JVAE_TINY, tdc.JCLIP_CFG, jconv.convert_unet_st(unet, JUNET_TINY),
        jconv.convert_vae(vae, JVAE_TINY.layers_per_block, len(JVAE_TINY.block_out_channels)),
        jconv.convert_clip_vision(states[2], tdc.JCLIP_CFG), num_steps=2,
        window_size=tdc.WINDOW, overlap=tdc.OVERLAP)
    return tdc._port_pipe(states), jpipe


def test_depthcrafter_run_raw_parallel_matches_jax(crafter):
    """9 frames: windows at 0, 2, 4 and 5, on dp=2 (windows 0 and 2 on the
    first device, 1 and 3 on the second); JAX's key chain (one split into
    the augmentation key and the window-noise key) replayed through
    ``_draw``. The same on one device; the normalized output too."""
    import jax

    pipe, jpipe = crafter
    frames = np.random.default_rng(20).random((9, 48, 64, 3)).astype(np.float32)
    want = np.asarray(jpipe.run_raw_parallel(frames, seed=0, mesh=None))
    _, k1, k2 = jax.random.split(jax.random.PRNGKey(0), 3)
    keys = []

    def draw(shape, gen):
        if len(keys) % 2 == 0:
            return torch.from_numpy(np.array(jax.random.normal(k1, shape)))
        return torch.from_numpy(np.array(jax.random.normal(k2, shape)))

    def counted(shape, gen):
        out = draw(shape, gen)
        keys.append(shape)
        return out

    pipe._draw = counted
    try:
        got = pipe.run_raw_parallel(frames, mesh=make_mesh(dp=2, devices=CPU2))
        one = pipe.run_raw_parallel(frames)
        norm = pipe.run_parallel(frames, mesh=make_mesh(dp=2, devices=CPU2))
    finally:
        del pipe._draw
    assert keys[:2] == [(9, 48, 64, 3), (9, 24, 32, 4)]
    span = float(want.max() - want.min())
    assert got.shape == want.shape == (9, 48, 64) and span > 0.05
    assert np.abs(got.numpy() - want).max() <= 1e-4 * span
    assert torch.equal(got, one)
    np.testing.assert_allclose(norm.numpy(), ((got - got.min()) / (got.max() - got.min()))
                               .numpy(), atol=1e-6)


def test_depthcrafter_mesh_route(tmp_path):
    """The route with mesh="dp=2": each segment's windows in parallel; every
    frame written, finite (the JAX package's own check)."""
    from visiondepth3d_tpu_torch.io.depth_io import open_depth_reader

    _write_clip(tmp_path / "clip.y4m", t=14)
    cfg = DepthConfig(model="depthcrafter", steps=1, window_size=4, overlap=2,
                      max_segment_frames=8, target_fps=24.0, allow_random=True, bits=16,
                      mesh="dp=2", device="cpu")
    assert render_depth_video_file(tmp_path / "clip.y4m", tmp_path / "d.vd16", cfg) == 14
    rd = open_depth_reader(str(tmp_path / "d.vd16"))
    frames = list(iter(rd))
    rd.close()
    assert len(frames) == 14 and all(np.isfinite(f).all() for f in frames)


# ------------------------------------------------------------------ refusals

REFUSED = {
    "render_sp": ("render", dict(mesh="dp=2,sp=2"), ValueError),  # 4 devices, 2 given
    "render_tp": ("render", dict(mesh="tp=3"), ValueError),
    "render_pp_dp": ("render", dict(mesh="dp=2,pp=2"), ValueError),
    "depth_sp": ("depth", dict(mesh="sp=3"), ValueError),  # 3 devices, 2 given
    "depth_pp": ("depth", dict(mesh="pp=2"), ValueError),
    "render_window": ("render", dict(mesh="dp=2", start_s=0.1), ValueError),
    "render_too_few_devices": ("render", dict(mesh="dp=3"), ValueError),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_still_refused(tmp_path, weights, case):
    what, kw, err = REFUSED[case]
    _write_clip(tmp_path / "clip.y4m", t=6)
    with pytest.raises(err):
        if what == "render":
            render_stereo_video(tmp_path / "clip.y4m", None, tmp_path / "o.y4m", None,
                                _cfg(**kw), predictor=weights[1], devices=CPU2)
        else:
            render_depth_video_file(tmp_path / "clip.y4m", tmp_path / "o.y4m",
                                    DepthConfig(device="cpu", inference_size=SIZE, **kw),
                                    predictor=weights[1], devices=CPU2)


def test_mesh_resume_rejected(tmp_path):
    _write_clip(tmp_path / "c.y4m")
    _write_depth(tmp_path / "d.y4m")
    with pytest.raises(ValueError, match="resume"):
        mesh_render.render_stereo_video_mesh(tmp_path / "c.y4m", tmp_path / "d.y4m",
                                             tmp_path / "o.y4m", None, _cfg(resume=True),
                                             mesh_axes={"dp": 2}, devices=CPU2)
    with pytest.raises(ValueError, match="fused route"):
        render_stereo_video(tmp_path / "c.y4m", tmp_path / "d.y4m", tmp_path / "o.y4m", None,
                            _cfg(mesh="pp=2"), devices=CPU2)


def test_reader_close_never_hangs(tmp_path):
    """Open, read one frame, seek, close, many times over: the prefetch
    thread is stopped under its mutex, so a close that lands while the
    thread is about to sleep still wakes it (the JAX package's reader,
    which sets the flag outside the mutex, hung within 20,000 such cycles
    on an 8-core CPU). In a subprocess, so a hang fails the case."""
    import subprocess
    import sys

    code = f"""
import numpy as np
from visiondepth3d_tpu_torch.io import Y4MPlaneReader, Y4MReader, Y4MWriter
p = {str(tmp_path / "c.y4m")!r}
with Y4MWriter(p, 64, 48, 24.0) as w:
    for i in range(12):
        w.write(np.full((48, 64, 3), i * 10, np.uint8))
for i in range(20000):
    r = (Y4MReader if i % 2 else Y4MPlaneReader)(p)
    r.read()
    if i % 3 == 0:
        r.seek(5)
        r.read()
    r.close()
print("ok")
"""
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=REPO)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr[-2000:]


# ------------------------------------------------------------------ kernels

WRAPPERS = (warp, postfx, stats, conv, dof, attention)


def _kernel_calls(dev, dtype=torch.float32):
    """One call of each kernel wrapper's CUDA entry on small inputs on
    ``dev``: {kernel name: (cuda call, plain call)}."""
    g = torch.Generator().manual_seed(0)

    def r(*shape):
        return torch.rand(*shape, generator=g).to(dev, dtype)

    frame, depth = r(24, 40, 3), r(24, 40)
    shift = (0.05 * (torch.rand(24, 40, generator=g) - 0.5)).to(dev)
    left, right = r(24, 40, 3), r(24, 40, 3)
    x, w, b = r(1, 10, 12, 16), r(3, 3, 16, 8) * 0.1, r(8)
    q = r(2, 520, 2, 32)
    fd = depth.float()

    def qhist(d):
        return torch.zeros(stats.QHIST_BINS, dtype=torch.int32, device=d)

    def sbuf(d):
        return torch.zeros(stats.SUBJECT_BAND, dtype=torch.int32, device=d)

    # the counts of the finish calls: the whole map's, and the crop's
    hist = stats.quantile_hist_band_torch(fd.cpu(), qhist("cpu")).to(dev)
    subj = stats.subject_hist_band_torch(fd[4:20, 6:34].cpu(), sbuf("cpu")).to(dev)
    return {
        "stereo_warp": (lambda: warp.stereo_warp_cuda(frame, depth, shift),
                        lambda: warp.stereo_warp_torch(frame, depth, shift)),
        "feather_heal": (lambda: postfx.feather_heal_cuda(left, right, frame, depth, depth),
                         lambda: postfx.feather_heal_torch(left, right, frame, depth, depth)),
        "quantile_pair": (lambda: stats.quantile_pair_cuda(fd, 0.02, 0.98),
                          lambda: stats.quantile_pair_torch(fd, 0.02, 0.98)),
        "subject_stats": (lambda: stats.subject_stats_cuda(fd[4:20, 6:34]),
                          lambda: stats.subject_stats_torch(fd[4:20, 6:34])),
        "conv3x3": (lambda: conv.conv3x3_cuda(x, w, b, "lrelu"),
                    lambda: conv.conv3x3_torch(x, w, b, "lrelu")),
        "dof_grade": (lambda: dof.dof_grade_cuda(left, right, fd, 0.5, 2.0),
                      lambda: dof.dof_grade_torch(left, right, fd, torch.tensor(0.5, device=dev),
                                                  2.0)),
        "vmem_attention": (lambda: attention.vmem_attention_cuda(q, q, q),
                           lambda: attention.vmem_attention_torch(q, q, q)),
        "quantile_hist_band": (lambda: stats.quantile_hist_band_cuda(fd[3:17], qhist(dev)),
                               lambda: stats.quantile_hist_band_torch(fd[3:17], qhist(dev))),
        "quantile_pair_finish": (lambda: stats.quantile_pair_finish_cuda(hist, 960, 0.02, 0.98),
                                 lambda: stats.quantile_pair_finish_torch(hist, 960, 0.02,
                                                                          0.98)),
        "subject_hist_band": (lambda: stats.subject_hist_band_cuda(fd[4:12, 6:34], sbuf(dev)),
                              lambda: stats.subject_hist_band_torch(fd[4:12, 6:34], sbuf(dev))),
        "subject_stats_finish": (lambda: stats.subject_stats_finish_cuda(subj),
                                 lambda: stats.subject_stats_finish_torch(subj)),
    }


def test_kernel_wrappers_launch_through_the_device_helper(monkeypatch):
    """No wrapper names a stream, counts a launch or calls a launcher itself
    (the cluster-size query enters its device): each launch goes through
    ``_lib.launch``, which enters the input's device, hands the launcher that
    device's stream last and counts once. On the CPU the library and the
    device entry are stand-ins that record what they were given."""
    for mod in WRAPPERS:
        src = inspect.getsource(mod)
        assert not re.search(r"launch_counts|stream_of|current_stream", src), mod.__name__
        assert set(re.findall(r"lib\(\)\.(\w+)", src)) <= {"vd3d_subject_cluster"}, mod.__name__
    entered, calls = [], []

    class Entered:
        def __init__(self, device):
            entered.append(torch.device(device))

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    class FakeLib:
        def __getattr__(self, name):
            return lambda *args: calls.append((name, args[-1])) or 0

    monkeypatch.setattr(torch.cuda, "device", Entered)
    monkeypatch.setattr(_lib, "lib", FakeLib)
    monkeypatch.setattr(_lib, "stream_of", lambda t: ("stream of", str(t.device)))
    for mod in WRAPPERS:
        monkeypatch.setattr(mod, "require_cuda", lambda *a: None)
    _lib.reset_launch_counts()
    for name, (cuda_call, _) in _kernel_calls(torch.device("cpu")).items():
        n = len(calls)
        cuda_call()
        assert len(calls) == n + 1 and calls[-1][1] == ("stream of", "cpu"), name
        assert _lib.launch_counts[name] == 1, name
    assert entered == [torch.device("cpu")] * len(_lib.KERNELS)
    _lib.reset_launch_counts()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_cuda_kernels_launch_inside_the_entered_device_from_a_fresh_thread(cuda):
    """Each kernel, called from a thread whose current device was never
    set, inside torch.cuda.device(0): it runs and agrees with its plain
    version (K3, K4 bit for bit; K2's heal mask may flip at its threshold)."""
    errs, failure = {}, []

    def run():
        try:
            with torch.cuda.device(0):
                for name, (cuda_call, plain_call) in _kernel_calls(cuda).items():
                    got, want = cuda_call(), plain_call()
                    got = got if isinstance(got, tuple) else (got,)
                    want = want if isinstance(want, tuple) else (want,)
                    errs[name] = max(float((a.float() - b.float()).abs().max())
                                     for a, b in zip(got, want))
                    if name == "feather_heal":
                        errs[name] = max(float(((a.float() - b.float()).abs() > 1e-4)
                                               .float().mean()) for a, b in zip(got, want))
                torch.cuda.synchronize()
        except Exception as e:  # re-raised on the test's thread
            failure.append(e)

    th = threading.Thread(target=run, daemon=True)
    th.start()
    th.join(timeout=600)
    assert not th.is_alive(), "the kernels' card thread still ran after 600 s"
    if failure:
        raise failure[0]
    assert errs["quantile_pair"] == 0 and errs["subject_stats"] == 0, errs
    assert all(errs[k] == 0 for k in ("quantile_hist_band", "quantile_pair_finish",
                                      "subject_hist_band", "subject_stats_finish")), errs
    assert errs["feather_heal"] <= 1e-3, errs
    assert all(errs[k] <= 1e-4 for k in ("stereo_warp", "conv3x3", "dof_grade",
                                         "vmem_attention")), errs


@pytest.mark.cuda
@pytest.mark.parametrize("spec", ["dp=2", "pp=2", "sp=2", "pp=2,dp=2"])
def test_cuda_mesh_render_on_one_card_twice(tmp_path, cuda, spec):
    """dp=2 and pp=2 over [cuda:0, cuda:0]: dp equals the per-segment
    renders concatenated, pp the single-device fused render, byte for byte;
    sp=2 and pp=2,dp=2 (over the card 2 and 4 times) equal one device at
    chunks of 2 (the model's batch per device)."""
    model = DepthAnything(tconfigs.DA_TINY)
    from visiondepth3d_tpu_torch.depth.model import init_random_

    init_random_(model, torch.Generator().manual_seed(0))
    pred = DepthPredictor(model, SIZE, device=cuda)
    cfg = dataclasses.replace(_cfg(), device="cuda")
    _write_clip(tmp_path / "clip.y4m")
    render_stereo_video(tmp_path / "clip.y4m", None, tmp_path / "mesh.y4m", None,
                        dataclasses.replace(cfg, mesh=spec), predictor=pred,
                        devices=[cuda] * (4 if spec == "pp=2,dp=2" else 2))
    if spec in ("sp=2", "pp=2,dp=2"):
        render_stereo_video(tmp_path / "clip.y4m", None, tmp_path / "one.y4m", None,
                            dataclasses.replace(cfg, mesh="off", chunk_size=2), predictor=pred)
        assert (tmp_path / "mesh.y4m").read_bytes() == (tmp_path / "one.y4m").read_bytes()
        return
    if spec == "pp=2":
        render_stereo_video(tmp_path / "clip.y4m", None, tmp_path / "one.y4m", None,
                            dataclasses.replace(cfg, mesh="off"), predictor=pred)
        assert (tmp_path / "mesh.y4m").read_bytes() == (tmp_path / "one.y4m").read_bytes()
        return
    twin = []
    for s, e in segment_bounds(T, 2):
        _write_clip(tmp_path / f"c{s}.y4m", e - s, s)
        render_stereo_video(tmp_path / f"c{s}.y4m", None, tmp_path / f"o{s}.y4m", None,
                            dataclasses.replace(cfg, mesh="off"), predictor=pred)
        twin.append(_read(tmp_path / f"o{s}.y4m"))
    assert np.array_equal(_read(tmp_path / "mesh.y4m"), np.concatenate(twin))


@pytest.mark.cuda
def test_cuda_replica_of_a_cpu_predictor(cuda):
    """``replicate``'s copy path on the card: the CPU predictor copied to
    cuda:0 predicts what the CPU original does (float32, TF32 off, within
    1e-4 of the depth's range); every tensor of the copy is on the card and
    its ``device`` names it; the original stays on the CPU."""
    from visiondepth3d_tpu_torch.parallel import mesh as pmesh

    from visiondepth3d_tpu_torch.depth.model import init_random_

    model = init_random_(DepthAnything(tconfigs.DA_TINY), torch.Generator().manual_seed(0))
    pred = DepthPredictor(model, SIZE, device="cpu")
    rep = replicate(pred, cuda)
    tensors = []
    pmesh._collect(rep, set(), tensors)
    assert rep is not pred and rep.device == cuda and tensors
    assert all(t.device == cuda for t in tensors)
    assert all(p.device.type == "cpu" for p in pred.model.parameters())
    frames = torch.from_numpy(np.random.default_rng(5).random((2, H, W, 3), dtype=np.float32))
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        got = rep(frames.to(cuda)).cpu()
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    want = pred(frames)
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= 1e-4 * float(want.max() - want.min())
