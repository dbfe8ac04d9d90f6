"""The port's web control surface (`vd3d-torch serve`) against the JAX
package's: the form schema and its coercion, the job manager, and the HTTP
API driving real jobs.

- Schema: equal to the JAX package's, ``device`` skipped, except the
  differences named in ``_JAX_ONLY``, ``_PORT_ONLY`` and ``_DEFAULTS``.
- Coercion: ``coerce_params`` gives the JAX package's outputs on a table of
  form bodies (``inference_size`` specs and timecodes too); a form body
  shaped for the JAX package keeps only the port's fields.
- Jobs: FIFO order, errors, pause, resume and cancel, as
  ``tests/test_serve.py`` drives the JAX package's manager; a job cut by
  ``shutdown`` or by the process ending leaves a ``.partial`` file and no
  output under the finished name.
- HTTP: a served depth-video render equals the same direct render byte for
  byte and the JAX package's served render within mean |d| <= 0.1 and max
  |d| <= 3 u8 (the surface tests' bound); a served fused render of a
  ``local:`` folder needs no checkpoint and equals ``vd3d-torch render``
  byte for byte; validation, control and languages; the scenes, audio and
  cancel paths.
- The server defaults to the card and raises without one. On the card
  (``cuda``-marked, skips here): a served fused render equals the CLI's
  byte for byte with K1-K4 launched 1/1/2/3 times a frame.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch
torch.set_num_threads(1)

from visiondepth3d_tpu_torch.cli.main import main as cli_main
from visiondepth3d_tpu_torch.config.i18n import set_language, t
from visiondepth3d_tpu_torch.depth import configs as tconfigs
from visiondepth3d_tpu_torch.depth import registry as tregistry
from visiondepth3d_tpu_torch.enhance import EnhanceConfig as TEnhance
from visiondepth3d_tpu_torch.io import Y4MReader, Y4MWriter
from visiondepth3d_tpu_torch.pipeline.depth_pipeline import DepthConfig as TDepth
from visiondepth3d_tpu_torch.pipeline.stereo_pipeline import RenderConfig as TRender
from visiondepth3d_tpu_torch.pipeline.stereo_pipeline import render_stereo_video
from visiondepth3d_tpu_torch.serve import JobManager
from visiondepth3d_tpu_torch.serve import app as tapp
from visiondepth3d_tpu_torch.serve.jobs import publish, staging_path
from visiondepth3d_tpu_torch.stereo import StereoParams as TParams

REPO = Path(__file__).resolve().parents[1]
CLASSES = ("DepthConfig", "EnhanceConfig", "RenderConfig", "StereoParams")


def _jax_app():
    """The JAX package's serve app, imported where a case compares against
    it (the card's test runner mocks jax and flax, under which the JAX
    package's presets module cannot import)."""
    from visiondepth3d_tpu.serve import app

    return app


def _classes(name):
    """(the JAX package's class, the port's) of a schema class."""
    from visiondepth3d_tpu.enhance import EnhanceConfig
    from visiondepth3d_tpu.pipeline.depth_pipeline import DepthConfig
    from visiondepth3d_tpu.pipeline.stereo_pipeline import RenderConfig
    from visiondepth3d_tpu.stereo import StereoParams

    return {"RenderConfig": (RenderConfig, TRender), "DepthConfig": (DepthConfig, TDepth),
            "EnhanceConfig": (EnhanceConfig, TEnhance),
            "StereoParams": (StereoParams, TParams)}[name]


# fields only the JAX package has (its device YUV legs and mesh scene snap),
# fields only the port has, and the one default that differs
_JAX_ONLY = {"RenderConfig": {"device_yuv", "device_yuv_in", "mesh_snap_scenes"}}
_PORT_ONLY = {"StereoParams": {"dof_backend"}}
_DEFAULTS = {("RenderConfig", "mesh"): ({"kind": "str", "default": "auto"},
                                        {"kind": "str?", "default": None})}


def _mk_clip(path, t=6, h=48, w=64, depth=False):
    with Y4MWriter(str(path), w, h, 24.0) as wr:
        for i in range(t):
            yy, xx = np.mgrid[0:h, 0:w]
            if depth:
                d = (xx / w * 200 + 20).astype(np.uint8)
                d[10:30, 10 + 3 * i: 25 + 3 * i] = 230
                f = np.repeat(d[..., None], 3, -1)
            else:
                f = np.stack([(xx * 4 + 4 * i) % 256, (yy * 5) % 256,
                              np.full((h, w), 90)], -1).astype(np.uint8)
                f[10:30, 10 + 3 * i: 25 + 3 * i] = (240, 50, 50)
            wr.write(f)


def _read(path):
    with Y4MReader(str(path)) as rd:
        return np.stack(list(rd))


def _req(url, data=None):
    if data is not None:
        req = urllib.request.Request(url, json.dumps(data).encode(),
                                     {"Content-Type": "application/json"}, method="POST")
    else:
        req = urllib.request.Request(url)
    with urllib.request.urlopen(req, timeout=30) as r:
        return r.status, json.loads(r.read() or b"{}")


def _wait(job, timeout=120):
    t0 = time.time()
    while job.status not in ("done", "error", "cancelled"):
        assert time.time() - t0 < timeout, (job.status, job.error)
        time.sleep(0.05)
    return job


def _http_job(base, kind, params, timeout=300):
    """Submit a job over HTTP and poll /api/jobs until it is final."""
    st, job = _req(f"{base}/api/jobs", {"kind": kind, "params": params})
    assert st == 201
    t0 = time.time()
    while True:
        _, jobs = _req(f"{base}/api/jobs")
        j = next(x for x in jobs if x["id"] == job["id"])
        if j["status"] in ("done", "error", "cancelled"):
            return j
        assert time.time() - t0 < timeout, j
        time.sleep(0.1)


@pytest.fixture
def server():
    httpd, mgr, port = tapp.run_in_thread(device="cpu")
    yield f"http://127.0.0.1:{port}", mgr
    mgr.shutdown()
    httpd.shutdown()
    httpd.server_close()


# ------------------------------------------------------------- schema


@pytest.mark.parametrize("name", CLASSES)
def test_schema_matches_jax_but_named_differences(name):
    japp, (jcls, tcls) = _jax_app(), _classes(name)
    js = {s["name"]: s for s in japp.schema_of(jcls) if s["name"] != "device"}
    ts = {s["name"]: s for s in tapp.schema_of(tcls)}
    assert "device" not in ts
    assert set(js) - set(ts) == _JAX_ONLY.get(name, set())
    assert set(ts) - set(js) == _PORT_ONLY.get(name, set())
    for k in set(js) & set(ts):
        want = js[k]
        if (name, k) in _DEFAULTS:
            jdef, tdef = _DEFAULTS[(name, k)]
            assert {kk: want[kk] for kk in jdef} == jdef
            want = dict(want, **tdef)
        assert ts[k] == want, k


_BODIES = [
    ("RenderConfig", {"chunk_size": "4", "skip_blank_frames": "true",
                      "output_format": "Half-SBS", "crf": 20, "nonsense": "x", "fps": "",
                      "mesh": "off"}),
    ("RenderConfig", {"start_s": "00:01:02.5", "end_s": "30", "fps": "23.976",
                      "aspect": "2.39:1", "preserve_original_aspect": "on",
                      "output_height": "720", "anaglyph_bgr_convention": "0"}),
    ("RenderConfig", {"start_s": "1:30", "end_s": 12.5, "resume": True}),
    ("DepthConfig", {"inference_size": "518"}),
    ("DepthConfig", {"inference_size": "1024x576"}),
    ("DepthConfig", {"inference_size": "dc-max-quality"}),
    ("DepthConfig", {"model": "depth-anything-v2-base", "batch_size": "4",
                     "dtype": "bfloat16", "bits": "16", "invert": "1", "tiled": "no",
                     "checkpoint": "m.safetensors", "tile_overlap": "32",
                     "percentile_hi": "98.5"}),
    ("EnhanceConfig", {"fps_multiplier": "4", "use_esrgan": "false", "blend_mode": "HIGH",
                       "pre_downscale": "0.5", "rife_scales": "x", "chunk_size": "2"}),
    ("StereoParams", {"fg_shift": "12", "enable_healing": "yes", "image_dtype": "bfloat16",
                      "blur_ksize": "7", "warp_hw": "x", "max_pixel_shift_percent": "0.03",
                      "quantile_mode": "exact", "dof_strength": "2"}),
]


@pytest.mark.parametrize("name,body", _BODIES, ids=[f"{n}-{i}" for i, (n, _) in
                                                    enumerate(_BODIES)])
def test_coerce_params_matches_jax(name, body):
    japp, (jcls, tcls) = _jax_app(), _classes(name)
    assert tapp.coerce_params(tcls, body) == japp.coerce_params(jcls, body)


def test_coerce_drops_jax_only_fields_and_rejects_bad_timecodes():
    japp, (JRender, _) = _jax_app(), _classes("RenderConfig")
    body = {"mesh": "off", "device_yuv": "true", "device_yuv_in": "false",
            "mesh_snap_scenes": "1", "chunk_size": "8", "device": "cpu"}
    want = japp.coerce_params(JRender, body)
    assert tapp.coerce_params(TRender, body) == {
        k: v for k, v in want.items() if k not in _JAX_ONLY["RenderConfig"] | {"device"}}
    # the JAX package renders the whole clip on an unparseable start (F3);
    # the port refuses it, as its CLI does
    assert japp.coerce_params(JRender, {"start_s": "soon"}) == {"start_s": None}
    with pytest.raises(ValueError, match="start_s"):
        tapp.coerce_params(TRender, {"start_s": "soon"})


# --------------------------------------------------------------- jobs


def test_job_manager_order_and_error():
    seen = []

    def ok(job):
        seen.append(job.id)
        return "out"

    def boom(job):
        raise RuntimeError("nope")

    mgr = JobManager({"ok": ok, "boom": boom})
    j1, j2, j3 = mgr.submit("ok", {}), mgr.submit("boom", {}), mgr.submit("ok", {})
    _wait(j3)
    assert seen == [j1.id, j3.id]
    assert (j1.status, j1.output) == ("done", "out")
    assert j2.status == "error" and "nope" in j2.error
    with pytest.raises(ValueError):
        mgr.submit("unknown", {})
    assert mgr.shutdown()
    with pytest.raises(RuntimeError, match="shut down"):
        mgr.submit("ok", {})


def test_job_pause_resume_cancel():
    ticks = []

    def stepper(job):
        check = job.cancel_check(poll_s=0.02)
        for i in range(2000):
            if check():
                return None
            ticks.append(i)
            time.sleep(0.005)
        return None

    mgr = JobManager({"step": stepper})
    job = mgr.submit("step", {})
    while not ticks:
        time.sleep(0.01)
    mgr.control(job.id, "pause")
    time.sleep(0.2)  # the poll loop observes the pause
    assert job.status == "paused"
    n = len(ticks)
    time.sleep(0.2)
    assert len(ticks) <= n + 1  # suspended: no forward progress
    mgr.control(job.id, "resume")
    time.sleep(0.2)
    assert job.status == "running" and len(ticks) > n + 1
    mgr.control(job.id, "cancel")
    _wait(job)
    assert job.status == "cancelled"
    # a paused job is unblocked by a cancel
    j2 = mgr.submit("step", {})
    while j2.status == "queued":
        time.sleep(0.01)
    mgr.control(j2.id, "pause")
    time.sleep(0.1)
    mgr.control(j2.id, "cancel")
    assert _wait(j2, timeout=10).status == "cancelled"
    # a queued job is cancelled without running
    blocker, queued = mgr.submit("step", {}), mgr.submit("step", {})
    mgr.control(queued.id, "cancel")
    assert queued.status == "cancelled" and queued.started is None
    mgr.control(blocker.id, "cancel")
    _wait(blocker)
    with pytest.raises(ValueError):
        mgr.control(blocker.id, "explode")
    assert mgr.shutdown()


def _staged_writer(final, lines=100000, delay=0.002):
    """A runner that writes numbered lines under its staging name until it
    is cancelled."""
    def run(job):
        check = job.cancel_check(poll_s=0.01)
        with open(job.stage(final), "w") as f:
            for i in range(lines):
                if check():
                    break
                f.write(f"line {i}\n")
                f.flush()
                job.progress["lines"] = i + 1
                time.sleep(delay)
        return final
    return run


def test_staged_output_is_published_only_when_done(tmp_path):
    final = tmp_path / "out.txt"
    mgr = JobManager({"w": _staged_writer(str(final), lines=5, delay=0.0)})
    job = _wait(mgr.submit("w", {}))
    assert (job.status, job.output) == ("done", str(final))
    assert final.read_text().count("\n") == 5
    assert not Path(staging_path(final)).exists()
    # a shutdown mid-job cancels it: a .partial file of whole lines, no
    # output under the finished name
    final2 = tmp_path / "cut.txt"
    mgr2 = JobManager({"w": _staged_writer(str(final2))})
    job = mgr2.submit("w", {})
    while job.progress.get("lines", 0) < 5:
        time.sleep(0.01)
    assert mgr2.shutdown(timeout=30)
    assert job.status == "cancelled" and job.output == staging_path(final2)
    assert not final2.exists()
    text = Path(job.output).read_text()
    assert text.endswith("\n") and text.count("\n") == job.progress["lines"]
    assert mgr.shutdown()


def test_publish_moves_directories_and_y4m_fallbacks(tmp_path):
    staged = tmp_path / "clips.partial"
    staged.mkdir()
    (staged / "a.y4m").write_text("a")
    (tmp_path / "clips").mkdir()
    (tmp_path / "clips" / "old.y4m").write_text("old")
    assert publish(str(staged), str(tmp_path / "clips")) == str(tmp_path / "clips")
    assert sorted(os.listdir(tmp_path / "clips")) == ["a.y4m", "old.y4m"]
    assert not staged.exists()
    # without ffmpeg a writer asked for .mp4 writes .y4m under the same stem
    (tmp_path / "x.partial.y4m").write_text("v")
    assert publish(str(tmp_path / "x.partial.mp4"), str(tmp_path / "x.mp4")) == str(
        tmp_path / "x.y4m")
    assert (tmp_path / "x.y4m").read_text() == "v"


_EXIT_SCRIPT = """
import os, sys, time
from visiondepth3d_tpu_torch.serve.jobs import JobManager

def run(job):
    check = job.cancel_check(poll_s=0.01)
    with open(job.stage(sys.argv[1]), "w") as f:
        for i in range(100000):
            if check():
                break
            f.write(f"line {i}\\n")
            f.flush()
            job.progress["lines"] = i + 1
            time.sleep(0.002)
    return sys.argv[1]

mgr = JobManager({"w": run})
job = mgr.submit("w", {})
while job.progress.get("lines", 0) < 5:
    time.sleep(0.01)
if sys.argv[2] == "hard":
    os._exit(0)  # no clean-up at all
# else the main thread ends here: the interpreter shuts down mid-job
"""


@pytest.mark.parametrize("how", ["exit", "hard"])
def test_process_ending_mid_job_leaves_no_finished_output(tmp_path, how):
    final = tmp_path / "out.txt"
    res = subprocess.run([sys.executable, "-c", _EXIT_SCRIPT, str(final), how],
                         capture_output=True, text=True, cwd=REPO, timeout=120,
                         env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert res.returncode == 0, res.stderr[-2000:]
    assert not final.exists()
    text = Path(staging_path(final)).read_text()
    assert text.startswith("line 0\n")
    if how == "exit":  # the exit hook cancelled the job: whole lines only
        assert text.endswith("\n")


# --------------------------------------------------------------- HTTP


_FORM = {"output_format": "Full-SBS", "preserve_original_aspect": "true", "chunk_size": "3",
         "mesh": "off", "fg_shift": "10.0", "enable_healing": "true"}


def test_http_render_job_matches_direct_and_jax(tmp_path, server):
    base, _ = server
    clip, depth = tmp_path / "in.y4m", tmp_path / "d.y4m"
    _mk_clip(clip)
    _mk_clip(depth, depth=True)
    st, meta = _req(f"{base}/api/meta")
    assert st == 200
    names = {s["name"] for s in meta["render"]["config"]}
    assert {"output_format", "chunk_size", "mesh"} <= names and "device" not in names
    assert any(m["name"] == "depth-anything-v2-small" for m in meta["depth"]["models"])
    assert meta["render"]["presets"]
    page = urllib.request.urlopen(f"{base}/", timeout=10).read()
    assert b"tabs" in page and b"ui.btn.render" in page

    # a form body shaped for the JAX package: device_yuv is dropped
    served = tmp_path / "served.y4m"
    j = _http_job(base, "render", dict(_FORM, input=str(clip), depth=str(depth),
                                       output=str(served), device_yuv="true"))
    assert j["status"] == "done", j.get("error")
    assert j["output"] == str(served) and j["progress"]["frames"] == 6
    assert not Path(staging_path(served)).exists()

    direct = tmp_path / "direct.y4m"
    render_stereo_video(clip, depth, direct, TParams(fg_shift=10.0, enable_healing=True),
                        TRender(output_format="Full-SBS", preserve_original_aspect=True,
                                chunk_size=3, mesh="off", device="cpu"))
    assert served.read_bytes() == direct.read_bytes()

    httpd, mgr, port = _jax_app().run_in_thread()
    try:
        jout = tmp_path / "jax.y4m"
        j = _http_job(f"http://127.0.0.1:{port}", "render",
                      dict(_FORM, input=str(clip), depth=str(depth), output=str(jout)))
        assert j["status"] == "done", j.get("error")
    finally:
        mgr.shutdown()
        httpd.shutdown()
    got, want = _read(served), _read(jout)
    assert got.shape == want.shape == (6, 48, 128, 3)
    d = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert d.mean() <= 0.1 and d.max() <= 3, (d.mean(), d.max())


def _tiny_local_folder(tmp_path, monkeypatch):
    """A native local: folder of DA-V2-Small's architecture at the tiny test
    widths (the catalog entry's config swapped for DA_TINY)."""
    from visiondepth3d_tpu_torch.depth.convert import to_jax_params

    name = "depth-anything-v2-small"
    monkeypatch.setitem(tregistry.CATALOG, name, dataclasses.replace(
        tregistry.CATALOG[name], config=tconfigs.DA_TINY))
    pred = tregistry.load_predictor(name, None, inference_size=56, seed=3, device="cpu")
    folder = tmp_path / "da_local"
    tregistry.save_local_params(str(folder), name, to_jax_params(
        "dpt_dinov2", pred.model.state_dict(), pred.cfg))
    return folder


def test_served_local_render_needs_no_checkpoint_and_equals_cli(tmp_path, monkeypatch,
                                                                  server):
    """A ``local:`` folder holds its weights: the served fused render runs
    without a checkpoint or allow_random (F21) and equals `vd3d-torch render`
    with the same flags byte for byte. A catalog model without either is
    refused with the JAX package's message."""
    base, _ = server
    folder = _tiny_local_folder(tmp_path, monkeypatch)
    clip = tmp_path / "in.y4m"
    _mk_clip(clip, t=5)
    served, cli = tmp_path / "served.y4m", tmp_path / "cli.y4m"
    j = _http_job(base, "render", {"input": str(clip), "output": str(served),
                                   "model": f"local:{folder}", "inference_size": "56",
                                   "preserve_original_aspect": "true", "chunk_size": "2"})
    assert j["status"] == "done", j.get("error")
    assert cli_main(["render", "--input", str(clip), "--model", f"local:{folder}",
                     "--inference-size", "56", "--preserve-aspect", "--chunk-size", "2",
                     "--output", str(cli), "--device", "cpu"]) == 0
    assert served.read_bytes() == cli.read_bytes()
    assert _read(served).shape == (5, 48, 128, 3)

    set_language("en")
    j = _http_job(base, "render", {"input": str(clip), "output": str(tmp_path / "x.y4m")})
    assert j["status"] == "error" and t("error.fused_needs_checkpoint") in j["error"]
    assert not (tmp_path / "x.y4m").exists()


def test_http_validation_and_control(server):
    base, _ = server
    set_language("en")  # the meta's default language is the process's
    for body, code in (({"kind": "nope", "params": {"input": "x"}}, 400),
                       ({"kind": "render", "params": {}}, 400)):
        with pytest.raises(urllib.error.HTTPError) as ei:
            _req(f"{base}/api/jobs", body)
        assert ei.value.code == code
    with pytest.raises(urllib.error.HTTPError) as ei:
        _req(f"{base}/api/jobs/999/control", {"action": "cancel"})
    assert ei.value.code == 404
    en = json.loads(urllib.request.urlopen(f"{base}/api/meta", timeout=10).read())
    fr = json.loads(urllib.request.urlopen(f"{base}/api/meta?lang=fr", timeout=10).read())
    assert en["lang"] == "en" and fr["lang"] == "fr"
    assert en["i18n"]["ui.btn.render"] == "Start render"
    assert en["i18n"]["ui.tab.render"] != fr["i18n"]["ui.tab.render"]
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(f"{base}/api/meta?lang=zz", timeout=10)
    assert ei.value.code == 400


def test_scenes_job(tmp_path, server):
    base, mgr = server
    clip = tmp_path / "scenes.y4m"
    with Y4MWriter(str(clip), 64, 48, 24.0) as wr:
        for i in range(40):
            wr.write(np.full((48, 64, 3), 30 if i < 20 else 220, np.uint8))  # cut at 20
    j = _http_job(base, "scenes", {"input": str(clip), "split": "true",
                                   "output": str(tmp_path / "clips")})
    assert j["status"] == "done", j["error"]
    assert j["progress"]["scenes"] == 2 and j["progress"]["clips"] == 2
    clips = sorted((tmp_path / "clips").glob("*.y4m"))
    assert [c.name for c in clips] == ["scenes-Scene-001.y4m", "scenes-Scene-002.y4m"]
    assert [len(_read(c)) for c in clips] == [20, 20]
    assert not (tmp_path / "clips.partial").exists()
    j = _http_job(base, "scenes", {"input": str(clip)})  # detection only
    assert j["status"] == "done" and j["progress"]["scenes"] == 2


def test_audio_job_names_ffmpeg_without_it(tmp_path, server):
    from visiondepth3d_tpu_torch.io.ffmpeg import have_ffmpeg

    base, _ = server
    clip = tmp_path / "in.y4m"
    _mk_clip(clip, t=2)
    j = _http_job(base, "audio", {"input": str(clip), "output": str(tmp_path / "a.m4a")})
    if have_ffmpeg():  # a y4m has no audio stream to rip
        assert j["status"] == "error" and j["error"]
    else:
        assert j["status"] == "error" and "ffmpeg" in j["error"]
    assert not (tmp_path / "a.m4a").exists()


@pytest.mark.parametrize("codec,reencode", [("copy", False), ("aac", True)])
def test_audio_attach_job_passes_reencode(tmp_path, monkeypatch, codec, reencode):
    """An attach job calls attach_audio with ``reencode`` (the JAX runner
    passes a ``codec`` keyword it does not take, F22) and publishes the
    staged output."""
    from visiondepth3d_tpu_torch.io import audio

    calls = []

    def fake_attach(video, track, dst, offset_s=0.0, reencode=False, progress_cb=None):
        calls.append((video, track, offset_s, reencode))
        Path(dst).write_bytes(b"mp4")
        progress_cb(100.0)

    monkeypatch.setattr(audio, "attach_audio", fake_attach)
    out = tmp_path / "with_audio.mp4"
    mgr = JobManager({"audio": lambda job: tapp._run_audio(job, torch.device("cpu"))})
    job = _wait(mgr.submit("audio", {"mode": "attach", "input": "v.mp4", "audio": "a.aac",
                                     "output": str(out), "offset": "1.5", "codec": codec}))
    assert mgr.shutdown()
    assert (job.status, job.output, job.progress) == ("done", str(out), {"percent": 100.0})
    assert calls == [("v.mp4", "a.aac", 1.5, reencode)] and out.read_bytes() == b"mp4"


def test_pipeline_cancel_checks(tmp_path):
    """The cancel_check contract on the depth and tools pipelines (the
    reference's cancel_requested Event, render_depth.py:37-39): cancelling
    after the second poll stops cleanly with the frames so far intact."""
    from visiondepth3d_tpu_torch.enhance import run_merged_pipeline
    from visiondepth3d_tpu_torch.pipeline.depth_pipeline import render_depth_video_file

    src = tmp_path / "in.y4m"
    _mk_clip(src, t=10)
    calls = {"n": 0}

    def cancel_after_two():
        calls["n"] += 1
        return calls["n"] > 2

    out = tmp_path / "enh.y4m"
    cfg = TEnhance(use_esrgan=False, use_rife=True, fps_multiplier=2, chunk_size=3,
                   rife_scales=(2, 1), allow_random_weights=True)
    n = run_merged_pipeline(src, out, cfg, cancel_check=cancel_after_two, device="cpu")
    assert 0 < n < 19 and len(_read(out)) == n

    calls["n"] = 0
    dout = tmp_path / "d.y4m"
    pred = tregistry.load_predictor("depth-anything-v2-small", None, inference_size=56,
                                    config=tconfigs.DA_TINY, device="cpu")
    nd = render_depth_video_file(src, dout, TDepth(batch_size=3, inference_size=56,
                                                   mesh="off", device="cpu"),
                                 predictor=pred, cancel_check=cancel_after_two)
    assert 0 < nd < 10 and len(_read(dout)) == nd


def test_server_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    for fn in (tapp.make_server, tapp.run_in_thread):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn(0)


@pytest.mark.cuda
def test_cuda_served_render_equals_cli(tmp_path, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    from visiondepth3d_tpu_torch.kernels import launch_counts, reset_launch_counts

    folder = _tiny_local_folder(tmp_path, monkeypatch)
    clip = tmp_path / "in.y4m"
    _mk_clip(clip, t=6)
    served, cli = tmp_path / "served.y4m", tmp_path / "cli.y4m"
    httpd, mgr, port = tapp.run_in_thread(device="cuda")
    try:
        reset_launch_counts()
        j = _http_job(f"http://127.0.0.1:{port}", "render", {
            "input": str(clip), "output": str(served), "model": f"local:{folder}",
            "inference_size": "56", "preserve_original_aspect": "true", "chunk_size": "3"})
        counts = dict(launch_counts)
    finally:
        mgr.shutdown()
        httpd.shutdown()
    assert j["status"] == "done", j.get("error")
    assert [counts[k] for k in ("stereo_warp", "feather_heal", "quantile_pair",
                                "subject_stats")] == [6, 6, 12, 18], counts
    assert cli_main(["render", "--input", str(clip), "--model", f"local:{folder}",
                     "--inference-size", "56", "--preserve-aspect", "--chunk-size", "3",
                     "--output", str(cli)]) == 0
    assert served.read_bytes() == cli.read_bytes()
