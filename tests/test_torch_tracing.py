"""The port's span recorder (``utils/observability.py``) and the spans of its
render loop and model loader.

While no ``torch.profiler`` traces the thread, a span is one shared no-op
context and records nothing. While one does, a span opens a ``vd3d.<name>``
range and keeps its name, host times, parent and chunk, and counts are kept
per chunk; a thread the profiler does not trace records nothing. Through
``ChunkStream`` at a tiny size on the CPU, under the profiler, every
top-level ``aten::`` op of a chunk lies in a leaf span that names its
stage; the stream's staging thread, which reads ahead, opens no span and
calls nothing of torch; a dp mesh numbers its chunks by round; the pp
render's spans belong to no chunk. ``vd3d-torch render --trace DIR``
writes a trace that holds the spans, and their records beside it.
"""

from __future__ import annotations

import glob
import json
import os
import threading
from pathlib import Path

import numpy as np
import pytest
import torch
torch.set_num_threads(1)

from visiondepth3d_tpu_torch.cli.main import main as cli_main
from visiondepth3d_tpu_torch.depth.configs import DA_TINY
from visiondepth3d_tpu_torch.depth.registry import load_predictor
from visiondepth3d_tpu_torch.io import Y4MPlaneReader, Y4MWriter, open_depth_reader
from visiondepth3d_tpu_torch.pipeline.geometry import resolve_geometry
from visiondepth3d_tpu_torch.pipeline.stereo_pipeline import (ChunkStream, RenderConfig,
                                                              make_chunk_fn, render_stereo_video)
from visiondepth3d_tpu_torch.state import init_trackers
from visiondepth3d_tpu_torch.stereo import StereoParams
from visiondepth3d_tpu_torch.utils import observability as obs

SIZE = 56
CPU2 = [torch.device("cpu")] * 2
# the spans that name one stage each (the others only hold spans)
LEAVES = {"read.wait", "read.upload", "decode", "depth", "step", "pack", "emit",
          "flush.wait", "flush.write"}
HOLDERS = {"chunk", "read", "dispatch", "flush"}


@pytest.fixture(autouse=True)
def _fresh_records():
    obs.reset_records()
    yield
    obs.reset_records()


def _profile():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


def _trace_events(prof, path) -> list[dict]:
    prof.export_chrome_trace(str(path))
    data = json.loads(Path(path).read_text())
    return data["traceEvents"] if isinstance(data, dict) else data


def _ranges(events) -> list[tuple[str, float, float]]:
    return [(e["name"][len(obs.SPAN_PREFIX):], e["ts"], e["ts"] + e.get("dur", 0))
            for e in events if e.get("cat") == "user_annotation"
            and e.get("name", "").startswith(obs.SPAN_PREFIX)]


def test_off_by_default_records_nothing():
    """Off by default: no profiler traces the thread."""
    first, second = obs.span("read"), obs.span("chunk", chunk=3)
    assert first is second  # one shared no-op context
    with first:
        with second:
            obs.count("frames", 4)
    assert obs.records() == obs.Records([], {})


def test_nesting_parents_chunks_counts_and_reset():
    with _profile():
        with obs.span("load"):
            pass
        for k in (0, 1):
            with obs.span("chunk", chunk=k):
                with obs.span("read"):
                    with obs.span("read.wait"):
                        pass
                obs.count("frames", 4 - k)
                obs.count("frames", 1)
                with obs.span("emit"):
                    with obs.span("flush"):
                        pass
        with obs.span("flush"):
            obs.count("frames", 7)
    spans, counts = obs.records()
    got = [(s.name, s.parent, s.chunk) for s in spans]
    assert got == [("load", None, None),
                   ("read.wait", "read", 0), ("read", "chunk", 0), ("flush", "emit", 0),
                   ("emit", "chunk", 0), ("chunk", None, 0),
                   ("read.wait", "read", 1), ("read", "chunk", 1), ("flush", "emit", 1),
                   ("emit", "chunk", 1), ("chunk", None, 1),
                   ("flush", None, None)]
    assert all(s.start <= s.end for s in spans)
    by = {(s.name, s.chunk): s for s in spans}
    assert by["chunk", 0].start <= by["read", 0].start <= by["read.wait", 0].start
    assert by["read.wait", 0].end <= by["read", 0].end <= by["chunk", 0].end
    assert counts == {("frames", 0): 5, ("frames", 1): 4, ("frames", None): 7}
    with obs.span("step"):  # the profiler has stopped
        obs.count("frames", 1)
    assert obs.records() == (spans, counts)  # kept until reset
    obs.reset_records()
    assert obs.records() == obs.Records([], {})


def test_spans_open_when_the_profiler_starts_or_stops():
    """A span opened before the profiler starts stays a no-op, so the spans
    inside it are roots of no chunk; a span opened under the profiler is
    kept when it closes after the profiler has stopped."""
    with obs.span("chunk", chunk=4):
        with _profile():
            with obs.span("read"):
                obs.count("frames", 2)
            late = obs.span("emit")
            late.__enter__()
    late.__exit__(None, None, None)
    spans, counts = obs.records()
    assert [(s.name, s.parent, s.chunk) for s in spans] == [("read", None, None),
                                                            ("emit", None, None)]
    assert counts == {("frames", None): 2}


def test_each_thread_keeps_its_own_stack_and_chunk():
    """Another thread opens spans and counts while the traced thread holds
    a chunk open: it gets the no-op context, and the traced thread's spans
    keep their parents and chunk."""
    opened, done = threading.Barrier(2, timeout=30), threading.Barrier(2, timeout=30)
    other = []

    def render():
        with obs.span("chunk", chunk=9) as ctx:
            other.append(ctx)
            opened.wait()  # the traced thread's chunk is open here
            obs.count("frames", 9)
            done.wait()

    thread = threading.Thread(target=render)
    with _profile():
        with obs.span("chunk", chunk=5):
            thread.start()
            opened.wait()
            with obs.span("read"):
                obs.count("frames", 5)
            done.wait()
    thread.join(timeout=60)
    assert not thread.is_alive() and other == [None]  # nullcontext enters as None
    spans, counts = obs.records()
    assert [(s.name, s.parent, s.chunk) for s in spans] == [("read", "chunk", 5),
                                                            ("chunk", None, 5)]
    assert counts == {("frames", 5): 5}


def test_recorded_span_is_a_profiler_range(tmp_path):
    with _profile() as prof:
        with obs.span("chunk", chunk=0):
            with obs.span("step"):
                torch.ones(8).cumsum(0)
    ranges = _ranges(_trace_events(prof, tmp_path / "t.json"))
    assert sorted(r[0] for r in ranges) == ["chunk", "step"]
    (_, c0, c1), (_, s0, s1) = sorted(ranges)
    assert c0 <= s0 <= s1 <= c1
    assert [s.name for s in obs.records().spans] == ["step", "chunk"]


class Sink:
    def __init__(self):
        self.frames = 0

    def write_yuv420(self, y, u, v):
        self.frames += 1


def _clip(path, n, w=64, h=48):
    yy, xx = np.mgrid[0:h, 0:w]
    with Y4MWriter(str(path), w, h, 24.0) as wr:
        for i in range(n):
            f = np.zeros((h, w, 3), np.uint8)
            f[..., 0] = (xx * 4 + i * 4) % 256
            f[..., 1] = (yy * 5) % 256
            f[..., 2] = 100
            f[10:30, 10 + 4 * i: 25 + 4 * i] = (240, 50, 50)
            wr.write(f)
    return path


def test_every_op_of_a_chunk_lies_in_one_stage_span(tmp_path):
    """The model load and three chunks (4, 4 and 2 frames: the last padded)
    of the fused route, checkpointing every second chunk, under the CPU
    profiler: each top-level aten op inside a ``vd3d.chunk`` range has a
    leaf span as its innermost range; every leaf and holder of the table is
    there; the chunks are numbered from 0 and count the frames they hold."""
    clip = _clip(tmp_path / "clip.y4m", 10)
    cfg = RenderConfig(chunk_size=4, device="cpu", preserve_original_aspect=True,
                       checkpoint_every_chunks=2)
    geom = resolve_geometry(64, 48, cfg.output_format, 48, preserve_original_aspect=True)
    rd, sink = Y4MPlaneReader(str(clip)), Sink()
    try:
        with _profile() as prof:
            pred = load_predictor("depth-anything-v2-small", inference_size=SIZE,
                                  config=DA_TINY, device="cpu")
            fn = make_chunk_fn(StereoParams(), geom, cfg, predictor=pred, yuv_in=True)
            stream = ChunkStream(rd, None, sink, fn,
                                 init_trackers(geom.eye_h, geom.eye_w, device="cpu"),
                                 torch.device("cpu"), geom, cfg, True, set(),
                                 output_path=tmp_path / "out.y4m")
            while stream.launch():
                pass
            stream.flush()
    finally:
        rd.close()
    assert sink.frames == 10 and (tmp_path / "out.y4m.resume.npz").exists()
    events = _trace_events(prof, tmp_path / "trace.json")
    ranges = _ranges(events)
    assert {r[0] for r in ranges} == LEAVES | HOLDERS | {"load"}
    chunks = [(s, e) for name, s, e in ranges if name == "chunk"]
    assert len(chunks) == 4  # the fourth finds the clip's end
    ops = sorted((e["ts"], e["ts"] + e.get("dur", 0), e["name"]) for e in events
                 if e.get("cat") == "cpu_op" and e["name"].startswith("aten::"))
    top, end = [], -1.0
    for s, e, name in ops:  # outermost ops: not inside the previous outermost one
        if s >= end:
            top.append((s, e, name))
            end = e
    inside = [op for op in top if any(c0 <= op[0] and op[1] <= c1 for c0, c1 in chunks)]
    assert len(inside) > 50
    for s, e, name in inside:
        holding = [(r1 - r0, n) for n, r0, r1 in ranges if r0 <= s and e <= r1]
        innermost = min(holding)[1]
        assert innermost in LEAVES, (name, sorted(holding))
    spans, counts = obs.records()
    assert [s.chunk for s in spans if s.name == "chunk"] == [0, 1, 2, 3]
    ready = {k: v for (name, k), v in counts.items() if name == "read.ready"}
    assert counts == {("frames", 0): 4, ("frames", 1): 4, ("frames", 2): 2,
                      **{("read.ready", k): v for k, v in ready.items()}}
    # the first chunk is staged when it is asked for; the fourth read finds
    # the end the third one handed over, and waits for nothing
    assert set(ready) == {0, 1, 2} and ready[0] == 0 and set(ready.values()) <= {0, 1}
    assert [s.parent for s in spans if s.name in ("read.wait", "read.upload")] == \
        ["read", "read"] * 3
    assert [s.chunk for s in spans if s.name == "flush"] == [1, 2, None]
    assert [(s.parent, s.chunk) for s in spans if s.name == "load"] == [(None, None)]
    assert {s.parent for s in spans if s.name in ("decode", "depth", "step", "pack")} == \
        {"dispatch"}


def _depth_clip(path, n, w=64, h=48):
    yy, xx = np.mgrid[0:h, 0:w]
    with Y4MWriter(str(path), w, h, 24.0) as wr:
        for i in range(n):
            d = (xx / w * 180 + 30).astype(np.uint8)
            d[10:30, 10 + 4 * i: 25 + 4 * i] = 40
            wr.write(np.repeat(d[..., None], 3, -1))
    return path


TORCH_DIR = os.path.dirname(torch.__file__) + os.sep


def _torch_call(frame, event, arg) -> str | None:
    """The name of what a profile hook event calls, when it is torch's."""
    if event == "call" and frame.f_code.co_filename.startswith(TORCH_DIR):
        return frame.f_code.co_name
    if event == "c_call":
        owner = getattr(arg, "__self__", None)
        module = getattr(arg, "__module__", None) or type(owner).__module__
        if module.split(".")[0] == "torch" or isinstance(owner, torch.Tensor):
            return arg.__qualname__
    return None


def test_the_staging_thread_opens_no_span_and_calls_no_torch(tmp_path):
    """The depth route's stream under the profiler (10 frames, chunks of 4):
    a profile hook on the staging thread sees it read every frame and call
    nothing of torch (so no ``aten::`` op) and no span; the trace's ops and
    ranges are all the render thread's, and the spans are those of the
    render thread's table."""
    clip, depth = _clip(tmp_path / "clip.y4m", 10), _depth_clip(tmp_path / "depth.y4m", 10)
    cfg = RenderConfig(chunk_size=4, device="cpu", preserve_original_aspect=True)
    geom = resolve_geometry(64, 48, cfg.output_format, 48, preserve_original_aspect=True)
    seen: dict[str, list] = {"reads": [], "torch": [], "spans": []}

    def hook(frame, event, arg):
        if not threading.current_thread().name.startswith("vd3d-staging"):
            return
        if event == "call" and frame.f_code.co_name == "read":
            seen["reads"].append(frame.f_code.co_filename)
        if event == "call" and frame.f_code.co_filename == obs.__file__:
            seen["spans"].append(frame.f_code.co_name)
        name = _torch_call(frame, event, arg)
        if name is not None:
            seen["torch"].append(name)

    rd, dd, sink = Y4MPlaneReader(str(clip)), open_depth_reader(str(depth)), Sink()
    stream = ChunkStream(rd, dd, sink, make_chunk_fn(StereoParams(), geom, cfg, yuv_in=True),
                         init_trackers(geom.eye_h, geom.eye_w, device="cpu"),
                         torch.device("cpu"), geom, cfg, True, set())
    threading.setprofile(hook)
    try:
        with _profile() as prof:
            while stream.launch():
                pass
            stream.flush()
    finally:
        stream.close()
        threading.setprofile(None)
        rd.close()
        dd.close()
    assert sink.frames == 10
    assert len(seen["reads"]) >= 20  # the frames and the depth frames, read there
    assert seen["torch"] == [] and seen["spans"] == []
    events = _trace_events(prof, tmp_path / "trace.json")
    threads = {e["tid"] for e in events if e.get("cat") in ("cpu_op", "user_annotation")}
    assert len(threads) == 1
    assert {s.name for s in obs.records().spans} == (LEAVES | HOLDERS) - {"depth"}


def test_a_dp_mesh_numbers_its_chunks_by_round(tmp_path):
    """12 frames on dp=2 from a depth clip: two 6-frame segments, each a
    chunk of 4 and a chunk of 2 (which reaches the segment's end). Chunk k
    is round k: both segments' spans carry k, and ``frames`` and
    ``read.ready`` sum the round."""
    clip, depth = _clip(tmp_path / "clip.y4m", 12), _depth_clip(tmp_path / "depth.y4m", 12)
    cfg = RenderConfig(chunk_size=4, device="cpu", preserve_original_aspect=True, mesh="dp=2")
    with _profile():
        prog = render_stereo_video(clip, depth, tmp_path / "dp.y4m", None, cfg, devices=CPU2)
    assert prog.frames_done == 12
    spans, counts = obs.records()
    assert [s.chunk for s in spans if s.name == "chunk"] == [0, 0, 1, 1]
    ready = {k: v for (name, k), v in counts.items() if name == "read.ready"}
    assert counts == {("frames", 0): 8, ("frames", 1): 4,
                      **{("read.ready", k): v for k, v in ready.items()}}
    assert ready[0] == 0 and ready[1] in (0, 1, 2)  # summed over the round's segments
    assert sorted(s.chunk for s in spans if s.name == "step") == [0, 0, 1, 1]
    assert {s.parent for s in spans if s.name == "decode"} == {"dispatch"}


def test_the_pp_render_spans_belong_to_no_chunk(tmp_path):
    """pp=2 drives ``ChunkStream.read`` and ``emit`` from its own loop:
    every stage span is there, none in a chunk, and no frame is counted
    (``read.ready`` too belongs to no chunk)."""
    clip = _clip(tmp_path / "clip.y4m", 6)
    pred = load_predictor("depth-anything-v2-small", inference_size=SIZE, config=DA_TINY,
                          device="cpu")
    cfg = RenderConfig(chunk_size=4, device="cpu", preserve_original_aspect=True, mesh="pp=2")
    with _profile():
        prog = render_stereo_video(clip, None, tmp_path / "pp.y4m", None, cfg, predictor=pred,
                                   devices=CPU2)
    assert prog.frames_done == 6
    spans, counts = obs.records()
    assert {s.name for s in spans} == LEAVES | {"read", "flush"}
    assert {s.chunk for s in spans} == {None} and set(counts) <= {("read.ready", None)}
    assert {s.parent for s in spans if s.name in ("decode", "depth", "step", "pack")} == {None}


def test_cli_render_trace_holds_the_spans(tmp_path):
    """``--trace DIR``: the TensorBoard trace holds every span as a range,
    and ``vd3d_spans.json`` their records and each chunk's frames."""
    clip = _clip(tmp_path / "clip.y4m", 6)
    trace_dir = tmp_path / "trace"
    rc = cli_main(["render", "--input", str(clip), "--allow-random", "--device", "cpu",
                   "--output", str(tmp_path / "out.y4m"), "--preserve-aspect",
                   "--chunk-size", "4", "--inference-size", str(SIZE), "--trace", str(trace_dir)])
    assert rc == 0
    files = glob.glob(str(trace_dir / "*.pt.trace.json*"))
    assert len(files) == 1
    names = {r[0] for r in _ranges(json.loads(Path(files[0]).read_text())["traceEvents"])}
    assert names == LEAVES | HOLDERS | {"load"}
    kept = json.loads((trace_dir / "vd3d_spans.json").read_text())
    assert {s["name"] for s in kept["spans"]} == names
    assert [s["chunk"] for s in kept["spans"] if s["name"] == "chunk"] == [0, 1]
    assert all(s["start"] <= s["end"] for s in kept["spans"])
    assert [c for c in kept["counts"] if c["name"] == "frames"] == [
        {"name": "frames", "chunk": 0, "n": 4}, {"name": "frames", "chunk": 1, "n": 2}]
    assert [c["chunk"] for c in kept["counts"] if c["name"] == "read.ready"] == [0, 1]
    assert obs.records() == obs.Records([], {})  # forgotten once written
