"""Multi-device rendering: ``vd3d-torch render --mesh dp=N[,sp=M][,tp=K]``.

Counterpart of ``visiondepth3d_tpu/pipeline/mesh_render.py``. Frame-level
DP follows ``parallel/dp.py``: the clip is cut into ``dp`` contiguous
segments (snapped to scene cuts when asked), every mesh device renders its
own segment with freshly warmed trackers -- a render started at a scene
boundary, what a user gets by rendering a long movie in manual pieces --
and the segments' outputs are concatenated in order. Each segment is the
single-device render loop (``stereo_pipeline.ChunkStream``) with the same
chunk function, its own reader seeked to its first frame and its own
``<output>.seg{g}.y4m``; one controller process launches every segment's
chunk before it waits for any readback, so distinct cards overlap. The
output equals the single-device renders of the segments, concatenated.

With ``sp=M`` each segment's frames are split into M row bands over its
``sp`` devices (``stereo/bands.py``): the stereo step runs on every band
with a halo exchange per frame and whole-frame statistics summed on the
segment's lead device, so the output equals the unsharded render's byte
for byte. Decoding, the depth-file resize, the packing and the YUV legs
run on the lead. On the fused route the depth model does not run
row-sharded: the chunk's frames are split by frame over the ``sp``
devices, each runs the model on its frames, and each frame's depth map is
then scattered to the row bands. The model is per frame and normalizes
each frame by its own range, so this is a placement choice and nothing is
reduced. The output then equals the one-device render at ``chunk_size /
M`` frames per chunk (the model's batch per device): the library GEMMs
round by batch size. The token-parallel model exists (``parallel/sp.py``,
``depth --mesh sp=M``), but the fused route does not use it yet: whether a
band of tokens per device beats the frame split at the batches users run
is ROADMAP item 6d.

With ``tp=K`` each (segment, row group) runs the depth model
Megatron-split over its ``tp`` devices (``parallel/tp.py``).

The depth model is replicated once per distinct device (a device may
repeat: ``[cuda:0, cuda:0]`` shares one copy), or split once per distinct
``tp`` group.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import time
from pathlib import Path
from typing import Callable

import torch

from ..io import Y4MPlaneReader
from ..io.depth_io import open_depth_reader
from ..io.video import open_video, open_writer
from ..parallel.dp import segment_bounds
from ..parallel.halo import BandLayout, band_bounds
from ..parallel.mesh import make_mesh, replicate, visible_devices
from ..parallel.tp import tp_predictor
from ..state import init_trackers
from ..stereo import StereoParams
from ..stereo.bands import init_band_trackers, stereo_halo
from .stereo_pipeline import (ChunkStream, RenderConfig, RenderProgress, _blank_frames,
                              make_chunk_fn, plane_input, probe_geometry)


def parse_mesh_spec(spec: str | None, n_auto: int | None = None) -> dict[str, int] | None:
    """'dp=4,sp=2' -> {'dp': 4, 'sp': 2}; 'auto' -> every device on dp;
    None / '' / 'off' -> None (single-device path). ``n_auto``: the devices
    'auto' spreads over (default: the visible CUDA cards), so on one card
    'auto' is the single-device path.

    Axes: dp = frame/segment data parallel; sp = spatial (frame-row)
    parallel; tp = tensor parallel over the depth model's attention heads /
    MLP columns; pp = stage pipeline parallel (depth slice / stereo slice,
    parallel/pp.py)."""
    if spec is None:
        return None
    s = str(spec).strip().lower()
    if s in ("", "off", "none", "1"):
        return None
    if s == "auto":
        n = torch.cuda.device_count() if n_auto is None else n_auto
        return {"dp": n} if n > 1 else None
    out: dict[str, int] = {}
    for part in s.split(","):
        if "=" not in part:
            raise ValueError(
                f"bad mesh spec {spec!r} (want dp=N[,sp=M][,tp=K][,pp=2])")
        k, v = part.split("=", 1)
        k = k.strip()
        if k not in ("dp", "sp", "tp", "pp"):
            raise ValueError(
                f"unknown mesh axis {k!r} (dp/sp/tp/pp supported)")
        out[k] = int(v)
    if any(out.get(a, 1) < 1 for a in ("dp", "sp", "tp", "pp")):
        raise ValueError(f"bad mesh spec {spec!r}")
    if out.get("pp", 1) not in (1, 2):
        raise ValueError(f"pp={out['pp']}: only pp=2 (depth/stereo "
                         "slices) is supported")
    total = 1
    for a in ("dp", "sp", "tp", "pp"):
        total *= out.get(a, 1)
    if total <= 1:
        return None
    return out


def mesh_axes_for(spec: str | None, device="cuda", devices=None) -> dict[str, int] | None:
    """``parse_mesh_spec`` for a run on ``device``: 'auto' spreads over
    ``devices`` when given, else over the visible cards for a run on a
    card, and is one device for a CPU run."""
    if devices is not None:
        n_auto = len(devices)
    else:
        n_auto = torch.cuda.device_count() if torch.device(device).type == "cuda" else 1
    return parse_mesh_spec(spec, n_auto)


def mesh_devices(n: int, device="cuda", devices=None) -> list[torch.device]:
    """The device list of an n-device mesh: ``devices`` when given; the CPU
    n times when ``device`` is the CPU (the caller asked for it); else the
    visible cards (raises without one). The caller checks the count."""
    if devices is not None:
        return [torch.device(d) for d in devices]
    if torch.device(device).type == "cpu":
        return [torch.device("cpu")] * n
    return visible_devices()


def count_video_frames(path) -> int:
    """Total frames; O(1) for fixed-record y4m/vd16, else one scan pass."""
    p = str(path)
    if p.endswith(".vd16"):
        rd = open_depth_reader(p)
        try:
            n = rd.count()
        finally:
            rd.close()
        if n is not None:
            return int(n)
    rd = open_video(p) if not p.endswith(".vd16") else open_depth_reader(p)
    try:
        n = getattr(rd, "count", lambda: None)()
        if n is not None:
            return int(n)
        total = 0
        while rd.read() is not None:
            total += 1
        return total
    finally:
        rd.close()


def _open_at(path, start_frame: int, fps: float, is_depth: bool, planes: bool = False):
    """Open a stream positioned at an absolute frame index (``planes``: a
    raw YUV420 plane reader of a .y4m)."""
    if planes:
        rd = Y4MPlaneReader(path)
    else:
        rd = open_depth_reader(path) if is_depth else open_video(path)
    if start_frame > 0:
        seek = getattr(rd, "seek", None)
        if seek is None or not seek(start_frame):
            # non-seekable container: fall back to a skip-read (or a
            # time-based ffmpeg seek when the rate is known)
            if not is_depth and not planes and fps > 0:
                rd.close()
                rd = open_video(path, start_s=start_frame / fps)
            else:
                for _ in range(start_frame):
                    if rd.read() is None:
                        break
    return rd


def _concat_y4m(seg_paths: list[str], out_path: str) -> None:
    """Byte-level y4m concatenation: header from the first segment, FRAME
    records appended verbatim (all segments share one geometry/rate)."""
    with open(out_path, "wb") as out:
        for i, p in enumerate(seg_paths):
            with open(p, "rb") as f:
                header = f.readline()
                if i == 0:
                    out.write(header)
                shutil.copyfileobj(f, out, 1 << 20)


def _stitch(seg_paths: list[str], output_path, cfg: RenderConfig) -> None:
    """The segments, in order, into the output: byte-level for a .y4m,
    else through ffmpeg (a .y4m beside the output without ffmpeg, as the
    single-device writer does)."""
    out = str(output_path)
    if out.endswith(".y4m"):
        _concat_y4m(seg_paths, out)
        return
    from ..io import ffmpeg as ff

    if not ff.have_ffmpeg():
        _concat_y4m(seg_paths, str(Path(out).with_suffix(".y4m")))
        return
    codec = ff.validate_codec(cfg.codec)
    proc = ff.popen_writer(ff.encode_from_y4m_cmd(out, codec, cfg.crf))
    with proc.stdin as pipe:
        for i, p in enumerate(seg_paths):
            with open(p, "rb") as f:
                header = f.readline()
                if i == 0:
                    pipe.write(header)
                shutil.copyfileobj(f, pipe, 1 << 20)
    proc.wait()


def render_stereo_video_mesh(
    input_path,
    depth_path,
    output_path,
    params: StereoParams | None = None,
    cfg: RenderConfig | None = None,
    progress_cb: Callable[[RenderProgress], None] | None = None,
    cancel_check: Callable[[], bool] | None = None,
    predictor=None,
    mesh_axes: dict[str, int] | None = None,
    snap_scenes: bool = False,
    devices=None,
) -> RenderProgress:
    """Segment-parallel render over a dp x sp x tp device mesh
    (``devices`` as in ``mesh_devices``; a device may repeat).

    Output is identical to rendering each segment on its own with the
    single-device path (fresh trackers per segment) and concatenating; with
    ``sp`` on the fused route, at ``chunk_size / sp`` per chunk (see the
    module docstring). The geometry (and the black-bar crop) comes from the
    clip's first frame; blank frames are detected over the whole clip.
    Resume and a clip window are not supported here: render segments are
    already the natural restart unit, and no checkpoint is written. A
    cancelled render keeps the frames from the clip's start up to the
    first segment left short.
    """
    params = params or StereoParams()
    cfg = cfg or RenderConfig()
    if cfg.resume:
        raise ValueError("--resume is not supported with --mesh; "
                         "re-run without --mesh to continue a checkpoint")
    if cfg.start_s is not None or cfg.end_s is not None:
        raise ValueError("a clip window (--start/--end) is not supported with --mesh; "
                         "render the window without --mesh")
    axes = dict(mesh_axes or {})
    if axes.get("pp", 1) != 1:
        raise ValueError("pp meshes route through pp_render."
                         "render_stereo_video_pp (render_stereo_video "
                         "dispatches there)")
    dp = int(axes.get("dp", 1))
    sp = int(axes.get("sp", 1))
    tp = int(axes.get("tp", 1))
    if tp > 1 and predictor is None:
        raise ValueError("--mesh tp=K shards the depth model and needs the "
                         "fused route (no --depth input)")
    n = dp * sp * tp
    devices = mesh_devices(n, cfg.device, devices)
    if n > len(devices):
        raise ValueError(f"mesh dp={dp},sp={sp},tp={tp} needs {n} devices, "
                         f"have {len(devices)}")
    mesh = make_mesh(dp=dp, sp=sp, tp=tp, devices=devices[:n])
    seg_devices = [mesh.devices[g, 0, 0] for g in range(dp)]
    # the depth model of each (segment, row group): a replica on its
    # device, or split over its tp devices; one per distinct device group
    models: dict = {}
    if predictor is not None:
        for group in {tuple(mesh.devices[g, s, :]) for g in range(dp) for s in range(sp)}:
            models[group] = (tp_predictor(predictor, group) if tp > 1
                             else replicate(predictor, group[0]))

    total = count_video_frames(input_path)
    if depth_path is not None:
        total = min(total, count_video_frames(depth_path))
    if total < dp * 2:  # a degenerate clip renders on the first device
        from .stereo_pipeline import render_stereo_video

        dev0 = seg_devices[0]
        return render_stereo_video(
            input_path, depth_path, output_path, params,
            dataclasses.replace(cfg, mesh="off", device=str(dev0)), progress_cb, cancel_check,
            replicate(predictor, dev0) if predictor is not None else None)

    # probe geometry exactly like the single-device path
    rd0 = open_video(input_path)
    try:
        fps = cfg.fps or rd0.fps or 30.0
        _, geom = probe_geometry(rd0, cfg)
        yuv_in = plane_input(input_path, cfg, rd0)
    finally:
        rd0.close()

    cuts = None
    if snap_scenes:
        from ..utils import detect_scenes

        with open_video(input_path) as rd:
            cuts = detect_scenes(iter(rd))
    bounds = segment_bounds(total, dp, cuts)
    blank_set = _blank_frames(input_path, fps) if cfg.skip_blank_frames else set()

    halo = stereo_halo(params)
    if sp > 1:
        band_bounds(geom.warp_h, sp, halo)  # a warp-size band too thin raises here

    def segment(g):
        """(chunk function, fresh trackers) of segment g."""
        groups = [tuple(mesh.devices[g, s, :]) for s in range(sp)]
        pred = None
        if predictor is not None:
            pred = [models[k] for k in groups] if sp > 1 else models[groups[0]]
        bands = (BandLayout.make(geom.eye_h, [k[0] for k in groups], halo, geom.eye_w)
                 if sp > 1 else None)
        fn = make_chunk_fn(params, geom, cfg, predictor=pred, yuv_in=yuv_in, bands=bands)
        trackers = (init_band_trackers(bands, geom.eye_w) if bands is not None
                    else init_trackers(geom.eye_h, geom.eye_w, seg_devices[g]))
        return fn, trackers

    seg_paths = [f"{output_path}.seg{g}.y4m" for g in range(dp)]
    streams: list[ChunkStream] = []
    opened: list = []  # every reader and writer, closed at the end
    prog = RenderProgress(total_frames=total)
    try:
        for g, ((start, end), dev) in enumerate(zip(bounds, seg_devices)):
            rd = _open_at(input_path, start, fps, is_depth=False, planes=yuv_in)
            opened.append(rd)
            dd = None
            if depth_path is not None:
                dd = _open_at(depth_path, start, fps, is_depth=True)
                opened.append(dd)
            wr = open_writer(seg_paths[g], geom.out_w, geom.out_h, fps)
            opened.append(wr)
            fn, trackers = segment(g)
            streams.append(ChunkStream(rd, dd, wr, fn, trackers, dev, geom, cfg, yuv_in,
                                       blank_set, frame_idx=start, limit=end - start))
        while any(not s.eof for s in streams):
            if cancel_check and cancel_check():
                break
            # every segment's chunk is launched before the next round waits
            # on a segment's previous readback
            n = sum(s.launch() for s in streams if not s.eof)
            if n == 0:
                break
            prog.frames_done += n
            prog.fps = prog.frames_done / max(time.time() - prog.started, 1e-6)
            if progress_cb:
                progress_cb(prog)
        for s in streams:
            s.flush()
    finally:
        for f in opened:
            f.close()

    # a cancel leaves segments short: keep the output gapless
    keep = next((g + 1 for g, (s, (_, end)) in enumerate(zip(streams, bounds))
                 if s.frame_idx < end), dp)
    prog.frames_done = sum(s.frame_idx - a for s, (a, _) in zip(streams[:keep], bounds))
    _stitch(seg_paths[:keep], output_path, cfg)
    for p in seg_paths:
        try:
            os.remove(p)
        except OSError:
            pass
    return prog
