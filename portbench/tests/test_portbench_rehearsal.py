"""The fused render route rehearsed on the CPU at a tiny size, the port on
``device="cpu"`` (its plain versions): the wrapping reader, the sink, the
spans and the check. The check's control and planted faults come out not
correct. A run never falls back to the CPU: ``run.py`` without a card
exits non-zero and prints no result."""

import subprocess
import sys
from pathlib import Path

import pytest
import torch

from portbench import control
from portbench.core import check, runner
from portbench.reference import depth_anything as ref_da
from portbench.reference import render as ref_render
from portbench.reference import stereo as ref_stereo
from portbench.reference.precision import Mat

ROOT = Path(__file__).resolve().parents[2]
CELL = "da2-small.sbs2160"


def _run(bench, conf, mix, trace=False, seconds=1.0, device="cpu", seed=12345678901):
    return runner.run_cell(bench, CELL, seed, seconds, trace, device=device, config=conf,
                           traffic=mix)


@pytest.mark.parametrize("name", ["da2-small", "da2-large"])
def test_reference_weights_are_the_port_models(bench, name):
    """The reference's weight list is the port model's state dict, name for
    name and shape for shape, at the published widths."""
    from visiondepth3d_tpu_torch.depth.dpt import DepthAnything
    from portbench.routes.render_fused import port_model_config

    conf = bench.config(name)
    with torch.device("meta"):
        model = DepthAnything(port_model_config(conf))
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    got = {n: s for n, s, _, _ in ref_da.param_specs(ref_da.model_cfg(conf))}
    assert got == want


def test_reference_chunk_matches_the_port(tiny_config):
    """The reference against the port's chunk function on the CPU, three
    chunks with the trackers carried: depth and trackers within float32
    rounding, the output within one u8 step."""
    from visiondepth3d_tpu_torch.depth.registry import load_predictor
    from visiondepth3d_tpu_torch.ops.convert import rgb_u8_to_yuv420
    from visiondepth3d_tpu_torch.pipeline.geometry import resolve_geometry
    from visiondepth3d_tpu_torch.pipeline.stereo_pipeline import RenderConfig, make_chunk_fn
    from visiondepth3d_tpu_torch.state import init_trackers
    from visiondepth3d_tpu_torch.stereo import StereoParams
    from portbench.core import clip, weights
    from portbench.routes.render_fused import port_model_config

    cfg = ref_da.model_cfg(tiny_config)
    sd, _ = weights.state_dict(ref_da.param_specs(cfg), 3, "cpu")
    pred = load_predictor("depth-anything-v2-small", checkpoint=sd, inference_size=70,
                          config=port_model_config(tiny_config), device="cpu")
    w, h, t = 160, 96, 4
    geom = resolve_geometry(w, h, "Full-SBS", h, preserve_original_aspect=True)
    rgeom = ref_render.full_sbs_geometry(w, h, h, True)
    assert {f: getattr(geom, f) for f in ref_render.Geometry.__dataclass_fields__} == \
        rgeom.__dict__
    rcfg = RenderConfig(device="cpu", chunk_size=t, preserve_original_aspect=True)
    fn = make_chunk_fn(StereoParams(), geom, rcfg, predictor=pred, yuv_in=True)
    tr = init_trackers(geom.eye_h, geom.eye_w, device="cpu")
    rt = ref_stereo.init_trackers(geom.eye_h, geom.eye_w, "cpu")
    for k in range(3):
        planes = rgb_u8_to_yuv420(clip.frames_rgb(9, w, h, k * t, t, "cpu"))
        tr, out = fn(tr, planes)
        rt, depth, ref_out = ref_render.chunk(Mat(), ref_stereo.Params(), sd, cfg, 70, rgeom,
                                              rt, *planes)
        prog = tuple(p.numpy() for p in rgb_u8_to_yuv420(out))
        assert check.frame_gaps(prog, ref_out).max() < 0.01
        assert max(abs(a.astype(int) - b.numpy().astype(int)).max()
                   for a, b in zip(prog, ref_out)) <= 1
        fields = check.state_gaps({f: getattr(tr, f) for f in ref_stereo.TRACKER_FIELDS}, rt)
        assert max(fields.values()) < 1e-5


def test_rehearsal_is_correct(bench, tiny_config, tiny_mix):
    res = _run(bench, tiny_config, tiny_mix)
    assert res["correct"], res["check"]
    notes = res["_notes"]
    assert res["attempted"] == notes["launches"] * 4 and res["failed"] == 0
    assert notes["launches"] * 4 > tiny_mix["frames"]  # the reader wrapped around
    assert set(notes["compared_chunks"]) >= {0, 1}
    assert set(res["metrics"]) == {"fps", "peak_gib", "setup_s"}
    assert list(res["check"]) == list(check.NUMBERS)
    assert res["device"]["platform"] == "cpu"  # never reported as a card


def test_rehearsal_traced(bench, tiny_config, tiny_mix):
    res = _run(bench, tiny_config, tiny_mix, trace=True, seconds=0.5)
    assert res["correct"], res["check"]
    assert "breakdown" in res and res["device"]["window_s"] > 0
    # the host has no device operations: no device metric reads anything
    assert "depth.device_ms" not in res["metrics"]
    assert "kernels.roofline_pct" not in res["metrics"]


def _faulty(monkeypatch, fault):
    from visiondepth3d_tpu_torch.pipeline import stereo_pipeline as sp

    render_chunk, to_yuv = sp.render_chunk, sp.rgb_u8_to_yuv420
    if fault == "state_unchanged":
        monkeypatch.setattr(sp, "render_chunk", lambda p, t, f, d, b=None:
                            (t, render_chunk(p, t, f, d, b)[1]))
    elif fault == "half_batch":
        def half(p, t, f, d, b=None):
            n = f.shape[0] // 2
            t, outs = render_chunk(p, t, f[:n], d[:n], None if b is None else b[:n])
            return t, type(outs)(*(torch.cat([x, x]) for x in outs))
        monkeypatch.setattr(sp, "render_chunk", half)
    elif fault == "frame_altered":
        def altered(rgb):
            y, u, v = to_yuv(rgb)
            y = y.clone()
            y[1] = (y[1].to(torch.int32) + 8).clamp(0, 255).to(torch.uint8)
            return y, u, v
        monkeypatch.setattr(sp, "rgb_u8_to_yuv420", altered)


@pytest.mark.parametrize("fault, number", [("state_unchanged", "state_gap"),
                                           ("half_batch", "frame_off_share"),
                                           ("frame_altered", "frame_off_share")])
def test_a_broken_timed_path_is_not_correct(bench, tiny_config, tiny_mix, monkeypatch,
                                            fault, number):
    _faulty(monkeypatch, fault)
    res = _run(bench, tiny_config, tiny_mix)
    assert not res["correct"]
    assert res["check"][number]["value"] > res["check"][number]["limit"]


def test_the_control_is_not_correct(bench, tiny_config, tiny_mix):
    """The reference in TF32 (emulated on the CPU) put in the program's
    place fails the limits; the float32 reference passes them."""
    readings = control.read_seed(bench, tiny_config, tiny_mix, 4, "cpu")
    limits = bench.limits(CELL, "render_fused")
    assert not check.combine(readings["control"], limits)[0]
    assert check.combine(readings["float32"], limits)[0]
    for fault in ("state_unchanged", "half_batch", "frame_altered"):
        assert not check.combine(readings[fault], limits)[0], fault


def test_the_program_in_bf16_is_not_correct(bench, tiny_config, tiny_mix):
    """The program with its stereo stage's image plane in bfloat16 (the
    control of ``frame_off_share``) fails it; the depth and the state, which
    stay float32, pass."""
    res = runner.run_cell(bench, CELL, 4, 1.0, False, device="cpu", config=tiny_config,
                          traffic=tiny_mix, program_stereo=control.PROGRAM_MODES[
                              "program-bf16-image"])
    assert not res["correct"]
    c = res["check"]
    assert c["frame_off_share"]["value"] > c["frame_off_share"]["limit"]
    assert c["depth_gap"]["value"] <= c["depth_gap"]["limit"]
    assert c["state_gap"]["value"] <= c["state_gap"]["limit"]


def test_window_sample_is_drawn_from_the_seed():
    from portbench.routes.render_fused import window_sample

    a = window_sample(2**31 + 5, 3, 8, 40)
    assert a == window_sample(2**31 + 5, 3, 8, 40)
    assert all(8 <= k < 40 for k in a)
    assert a != window_sample(2**31 + 6, 3, 8, 40)


def test_run_without_a_card_prints_no_result(tmp_path):
    out = subprocess.run([sys.executable, str(ROOT / "portbench" / "run.py"), "--workload",
                          CELL, "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=ROOT,
                         env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": "",
                              "TMPDIR": str(tmp_path), "HOME": str(tmp_path)})
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    assert out.returncode == 3, out.stderr
    assert out.stdout.strip() == ""


@pytest.mark.cuda
def test_rehearsal_on_the_card(bench, tiny_config, tiny_mix, cuda_device):
    res = _run(bench, tiny_config, tiny_mix, device=cuda_device)
    assert res["correct"], res["check"]
    assert res["device"]["memory_peak_bytes"] > 0


@pytest.mark.cuda
def test_the_control_on_the_card(bench, tiny_config, tiny_mix, cuda_device):
    readings = control.read_seed(bench, tiny_config, tiny_mix, 4, cuda_device)
    assert not check.combine(readings["control"], bench.limits(CELL, "render_fused"))[0]
