"""The render loop's read-ahead (``ChunkStream``): a staging thread reads
chunk k + 1 into reused host buffers while the render thread runs chunk k.

The stream is held to a serial expectation that each test builds itself:
the chunk function called on frames read by a fresh reader, chunk by chunk,
padded and flagged as the render does. Plane and RGB input, a clip that is
not a multiple of the chunk, ``limit``, blank frames and a depth reader all
give the same bytes, each frame written once. The plane reader hands out
planes that later reads leave alone, equal to the JAX package's reader's.
The render thread keeps the stream's state: a cancelled render's
checkpoint counts the chunks written, not the one staged ahead, and its
resume gives the uninterrupted bytes; an error of the staging thread is
raised on the render thread; a closed stream, or one dropped after its
last staging, reads nothing more. The dp and pp meshes give the serial
bytes too.
"""

from __future__ import annotations

import dataclasses
import gc
import threading
import time

import numpy as np
import pytest
import torch
torch.set_num_threads(1)

from visiondepth3d_tpu_torch.depth.configs import DA_TINY
from visiondepth3d_tpu_torch.depth.registry import load_predictor
from visiondepth3d_tpu_torch.io import Y4MPlaneReader, Y4MWriter, open_depth_reader, open_video
from visiondepth3d_tpu_torch.ops.convert import rgb_u8_to_yuv420
from visiondepth3d_tpu_torch.pipeline import resume
from visiondepth3d_tpu_torch.pipeline.geometry import resolve_geometry
from visiondepth3d_tpu_torch.pipeline.mesh_render import segment_bounds
from visiondepth3d_tpu_torch.pipeline.stereo_pipeline import (ChunkStream, RenderConfig,
                                                              make_chunk_fn, render_stereo_video)
from visiondepth3d_tpu_torch.state import init_trackers
from visiondepth3d_tpu_torch.stereo import StereoParams

W, H, SIZE, CHUNK = 64, 48, 56, 4
CPU = torch.device("cpu")


def _clip(path, n):
    yy, xx = np.mgrid[0:H, 0:W]
    with Y4MWriter(str(path), W, H, 24.0) as wr:
        for i in range(n):
            f = np.zeros((H, W, 3), np.uint8)
            f[..., 0] = (xx * 4 + i * 9) % 256
            f[..., 1] = (yy * 5 + i * 3) % 256
            f[..., 2] = 100
            f[10:30, 6 + 4 * i: 21 + 4 * i] = (240, 50, 50)
            wr.write(f)
    return path


def _depth_clip(path, n):
    yy, xx = np.mgrid[0:H, 0:W]
    with Y4MWriter(str(path), W, H, 24.0) as wr:
        for i in range(n):
            d = (xx / W * 180 + 30 + i).astype(np.uint8)
            d[10:30, 6 + 4 * i: 21 + 4 * i] = 40
            wr.write(np.repeat(d[..., None], 3, -1))
    return path


@pytest.fixture(scope="module")
def predictor():
    return load_predictor("depth-anything-v2-small", inference_size=SIZE, config=DA_TINY,
                          device="cpu")


def _cfg(**kw) -> RenderConfig:
    return RenderConfig(chunk_size=CHUNK, device="cpu", preserve_original_aspect=True,
                        mesh="off", **kw)


def _geom():
    return resolve_geometry(W, H, "Full-SBS", H, preserve_original_aspect=True)


def _open(path, yuv: bool, start: int = 0):
    rd = Y4MPlaneReader(str(path)) if yuv else open_video(str(path))
    if start:
        assert rd.seek(start)
    return rd


def _serial(chunk_fn, clip, depth, yuv: bool, start: int = 0, limit: int | None = None,
            blank_set=frozenset()) -> list[np.ndarray]:
    """The expectation: the frames of fresh readers from ``start`` (at most
    ``limit``), in chunks of ``CHUNK`` padded with their last frame, each
    through ``chunk_fn`` from fresh trackers -> the packed RGB frames."""
    rd = _open(clip, yuv, start)
    dd = open_depth_reader(str(depth)) if depth is not None else None
    if dd is not None and start:
        assert dd.seek(start)
    frames, depths = [], []
    try:
        while limit is None or len(frames) < limit:
            f = rd.read()
            d = dd.read() if dd is not None and f is not None else None
            if f is None or (dd is not None and d is None):
                break
            frames.append(f)
            depths.append(d)
    finally:
        rd.close()
        if dd is not None:
            dd.close()
    geom = _geom()
    trackers = init_trackers(geom.eye_h, geom.eye_w, device="cpu")
    out = []
    for a in range(0, len(frames), CHUNK):
        fr, dp = frames[a:a + CHUNK], depths[a:a + CHUNK]
        n, pad = len(fr), CHUNK - len(fr)
        fr, dp = fr + [fr[-1]] * pad, dp + [dp[-1]] * pad
        blanks = [start + a + i in blank_set for i in range(n)] + [False] * pad
        if yuv:
            frames_in = tuple(torch.from_numpy(np.stack([f[i] for f in fr])) for i in range(3))
        else:
            frames_in = torch.from_numpy(np.stack(fr))
        blanks_in = torch.tensor(blanks) if any(blanks) else None
        if dd is None:
            trackers, o = chunk_fn(trackers, frames_in, blanks_in)
        else:
            d16 = np.clip(np.stack(dp) * 65535.0 + 0.5, 0, 65535).astype(np.uint16)
            trackers, o = chunk_fn(trackers, frames_in, torch.from_numpy(d16), blanks_in)
        out.extend(o[:n].numpy())
    return out


class RGBSink:
    """A writer without ``write_yuv420``: the stream writes packed RGB."""

    def __init__(self):
        self.frames: list[np.ndarray] = []

    def write(self, frame):
        self.frames.append(np.array(frame))


class CountingReader:
    """A reader that counts its reads and the threads they ran on. Read
    ``fail_at`` (1-based) raises; read ``hold_at`` waits until ``gate`` is
    set."""

    def __init__(self, rd, fail_at: int | None = None, hold_at: int | None = None):
        self.rd, self.fail_at, self.hold_at = rd, fail_at, hold_at
        self.width, self.height = rd.width, rd.height
        self.reads, self.threads = 0, set()
        self.gate = threading.Event()

    def read(self):
        self.reads += 1
        self.threads.add(threading.current_thread())
        if self.reads == self.fail_at:
            raise OSError("the disk went away")
        if self.reads == self.hold_at:
            assert self.gate.wait(timeout=60)
        return self.rd.read()

    def close(self):
        self.rd.close()


def _stream(rd, dd, wr, chunk_fn, yuv: bool, **kw) -> ChunkStream:
    geom = _geom()
    return ChunkStream(rd, dd, wr, chunk_fn, init_trackers(geom.eye_h, geom.eye_w, device="cpu"),
                       CPU, geom, _cfg(), yuv, kw.pop("blank_set", set()), **kw)


# (input, depth reader, clip frames, start, limit, blank frames)
CASES = {
    "planes_short_last_chunk": (True, False, 10, 0, None, ()),
    "planes_whole_chunks": (True, False, 8, 0, None, ()),
    "rgb_probe_frame": (False, False, 10, 0, None, ()),
    "planes_limit_from_a_seek": (True, False, 12, 3, 6, ()),
    "planes_limit_fills_the_chunk": (True, False, 12, 0, 8, ()),
    "planes_blank_frames": (True, False, 10, 0, None, (1, 4, 9)),
    "planes_depth_reader": (True, True, 10, 0, None, (2,)),
    "rgb_depth_reader_limit": (False, True, 11, 2, 7, (5,)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_read_ahead_gives_the_serial_bytes(tmp_path, predictor, case):
    """Each case's frames through the stream equal the serial expectation
    byte for byte, in order, each written once; ``frame_idx`` counts the
    frames handed over, ``eof`` is set."""
    yuv, with_depth, n, start, limit, blanks = CASES[case]
    clip = _clip(tmp_path / "clip.y4m", n)
    depth = _depth_clip(tmp_path / "depth.y4m", n) if with_depth else None
    geom = _geom()
    fn = make_chunk_fn(StereoParams(), geom, _cfg(), predictor=None if with_depth else predictor,
                       yuv_in=yuv)
    want = _serial(fn, clip, depth, yuv, start, limit, set(blanks))
    rd = _open(clip, yuv, start)
    dd = open_depth_reader(str(depth)) if with_depth else None
    if dd is not None and start:
        assert dd.seek(start)
    first = None if yuv else rd.read()  # the probe frame, as the render passes it
    sink = RGBSink()
    stream = _stream(rd, dd, sink, fn, yuv, blank_set=set(blanks), frame_idx=start,
                     frame=first, limit=limit)
    try:
        while not stream.eof:
            if not stream.launch():
                break
        stream.flush()
    finally:
        stream.close()
        rd.close()
        if dd is not None:
            dd.close()
    assert stream.eof and stream.frame_idx == start + len(want)
    assert len(want) == (limit if limit is not None else n - start)
    assert len(sink.frames) == len(want)
    for i, (got, exp) in enumerate(zip(sink.frames, want)):
        assert np.array_equal(got, exp), f"frame {i}"


def test_plane_reader_frames_are_the_callers_and_match_jax(tmp_path):
    """``Y4MPlaneReader.read`` returns three views of one fresh array per
    frame: later reads leave a frame's planes alone, and every plane equals
    the JAX package's reader's."""
    from visiondepth3d_tpu.io.y4m import Y4MPlaneReader as JaxPlaneReader

    clip = _clip(tmp_path / "clip.y4m", 5)
    with Y4MPlaneReader(str(clip)) as rd:
        first = rd.read()
        kept = [p.copy() for p in first]
        rest = list(iter(rd.read, None))
    frames = [first, *rest]
    assert len(frames) == 5
    for p, k in zip(first, kept):
        assert np.array_equal(p, k)  # untouched by the four reads after it
    for i, f in enumerate(frames):
        assert [p.shape for p in f] == [(H, W), (H // 2, W // 2), (H // 2, W // 2)]
        assert all(p.dtype == np.uint8 and p.flags.c_contiguous for p in f)
        for g in frames[i + 1:]:
            assert not any(np.shares_memory(p, q) for p in f for q in g)
    with JaxPlaneReader(str(clip)) as jrd:
        jax_frames = list(iter(jrd.read, None))
    assert len(jax_frames) == 5
    for f, j in zip(frames, jax_frames):
        for p, q in zip(f, j):
            assert np.array_equal(p, q)


def test_a_cancelled_render_checkpoints_the_written_chunks_and_resumes(tmp_path):
    """A render cancelled after two chunks (checkpoint every two) keeps 8
    frames and a checkpoint at frame 8, though the staging thread has read
    the third chunk; the resumed render is byte-identical to an
    uninterrupted one."""
    clip, depth = _clip(tmp_path / "clip.y4m", 14), _depth_clip(tmp_path / "depth.y4m", 14)
    cfg = _cfg(checkpoint_every_chunks=2)
    whole = tmp_path / "whole.y4m"
    render_stereo_video(clip, depth, whole, None, cfg)
    out = tmp_path / "out.y4m"
    done = []
    prog = render_stereo_video(clip, depth, out, None, cfg,
                               progress_cb=lambda p: done.append(p.frames_done),
                               cancel_check=lambda: len(done) >= 2)
    assert prog.frames_done == 8 and done == [4, 8]
    geom = _geom()
    state = resume.load_checkpoint(out, init_trackers(geom.eye_h, geom.eye_w, device="cpu"))
    assert state is not None and state[0] == 8
    with open_video(str(out)) as rd:
        assert rd.count() == 8
    prog = render_stereo_video(clip, depth, out, None, _cfg(checkpoint_every_chunks=2,
                                                            resume=True))
    assert prog.frames_done == 14
    assert out.read_bytes() == whole.read_bytes()
    assert not resume.checkpoint_path(out).exists()


def test_an_error_of_the_staging_thread_is_raised_by_launch(tmp_path):
    """The reader raises at its sixth read, inside the staging of the second
    chunk: the first ``launch`` renders its four frames, the second raises
    the reader's error on the render thread."""
    clip = _clip(tmp_path / "clip.y4m", 12)
    fn = make_chunk_fn(StereoParams(), _geom(), _cfg(), yuv_in=True)
    rd = CountingReader(Y4MPlaneReader(str(clip)), fail_at=6)
    dd = open_depth_reader(str(_depth_clip(tmp_path / "depth.y4m", 12)))
    sink = RGBSink()
    stream = _stream(rd, dd, sink, fn, True)
    try:
        assert stream.launch() == 4
        with pytest.raises(OSError, match="the disk went away"):
            stream.launch()
    finally:
        stream.close()
        rd.close()
        dd.close()
    assert len(sink.frames) == 0 and stream.pending is not None  # the first chunk, unflushed
    assert threading.current_thread() not in rd.threads
    assert {t.name.split("_")[0] for t in rd.threads} == {"vd3d-staging"}


def test_a_closed_stream_reads_nothing_more(tmp_path):
    """``close`` waits for the chunk being staged (held at its second
    frame): then the reader has been read for two chunks, is never read
    again, and ``read`` raises."""
    clip = _clip(tmp_path / "clip.y4m", 20)
    fn = make_chunk_fn(StereoParams(), _geom(), _cfg(), yuv_in=True)
    rd = CountingReader(Y4MPlaneReader(str(clip)), hold_at=CHUNK + 2)
    dd = open_depth_reader(str(_depth_clip(tmp_path / "depth.y4m", 20)))
    stream = _stream(rd, dd, RGBSink(), fn, True)
    try:
        assert stream.launch() == 4
        threading.Timer(0.2, rd.gate.set).start()
        stream.close()
        assert rd.gate.is_set() and rd.reads == 2 * CHUNK
        with pytest.raises(ValueError, match="closed"):
            stream.read()
        time.sleep(0.2)
        assert rd.reads == 2 * CHUNK
        (thread,) = rd.threads
        thread.join(timeout=30)
        assert not thread.is_alive()
    finally:
        stream.close()
        rd.close()
        dd.close()


def test_a_dropped_stream_reads_nothing_after_its_last_staging(tmp_path):
    """A stream dropped without ``close`` (as the benchmark drops its own)
    finishes the chunk it was staging (held at its second frame until the
    stream is gone), then its thread ends and the reader is not read
    again."""
    clip = _clip(tmp_path / "clip.y4m", 20)
    fn = make_chunk_fn(StereoParams(), _geom(), _cfg(), yuv_in=True)
    rd = CountingReader(Y4MPlaneReader(str(clip)), hold_at=CHUNK + 2)
    dd = open_depth_reader(str(_depth_clip(tmp_path / "depth.y4m", 20)))
    try:
        stream = _stream(rd, dd, RGBSink(), fn, True)
        assert stream.launch() == 4
        del stream
        gc.collect()
        rd.gate.set()
        (thread,) = rd.threads
        thread.join(timeout=30)
        assert not thread.is_alive()
        assert rd.reads == 2 * CHUNK
        time.sleep(0.2)
        assert rd.reads == 2 * CHUNK
    finally:
        rd.close()
        dd.close()


@pytest.mark.parametrize("mesh", ["dp=2", "pp=2"])
def test_mesh_renders_give_the_serial_bytes(tmp_path, predictor, mesh):
    """12 frames: dp=2 (the depth route, two 6-frame segments from fresh
    trackers) and pp=2 (the fused route) write the serial expectation's
    YUV bytes, segment by segment for dp."""
    clip = _clip(tmp_path / "clip.y4m", 12)
    geom, cfg = _geom(), _cfg()
    out = tmp_path / "out.y4m"
    mesh_cfg = dataclasses.replace(cfg, mesh=mesh)
    if mesh == "dp=2":
        depth = _depth_clip(tmp_path / "depth.y4m", 12)
        fn = make_chunk_fn(StereoParams(), geom, cfg, yuv_in=True)
        want = []
        for a, b in segment_bounds(12, 2, None):
            want += _serial(fn, clip, depth, True, a, b - a)
        prog = render_stereo_video(clip, depth, out, None, mesh_cfg, devices=[CPU] * 2)
    else:
        fn = make_chunk_fn(StereoParams(), geom, cfg, predictor=predictor, yuv_in=True)
        want = _serial(fn, clip, None, True)
        prog = render_stereo_video(clip, None, out, None, mesh_cfg, predictor=predictor,
                                   devices=[CPU] * 2)
    assert prog.frames_done == 12
    with Y4MPlaneReader(str(out)) as rd:
        got = list(iter(rd.read, None))
    assert len(got) == len(want) == 12
    for i, (g, w) in enumerate(zip(got, want)):
        planes = rgb_u8_to_yuv420(torch.from_numpy(w)[None])
        for p, q in zip(g, planes):
            assert np.array_equal(p, q[0].numpy()), f"frame {i}"
