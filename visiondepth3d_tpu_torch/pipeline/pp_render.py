"""Stage-pipelined rendering: ``vd3d-torch render --mesh pp=2``.

Counterpart of ``visiondepth3d_tpu/pipeline/pp_render.py``. The device
list is split into two slices: depth inference (slice A) and the stereo
composition + pack (slice B). While slice B renders chunk i, slice A
already runs chunk i + 1's depth: ``parallel/pp.py``'s two-stage pipeline
enqueues them in that order, and the only traffic between the slices is
the chunk's u8 frames and its [T, eye_h, eye_w] float depth.

Semantics: one segment, serial tracker state -- the output equals the
single-device fused route byte for byte (the stage cut moves no arithmetic
across frames: ``make_pp_bodies``). The reads, the YUV legs and the one
readback in flight are the single-device loop's (``ChunkStream``).

With ``dp=N`` each slice is N devices wide, as in the JAX package: slice
A splits each chunk's frames over its N devices (one model replica each)
and slice B renders the chunk in N row bands (``stereo/bands.py``); each
band takes its rows of every frame group straight from slice A. The output
then equals the single-device fused render at ``chunk_size / N`` frames
per chunk (the model's batch per device; the library GEMMs round by batch
size).
"""

from __future__ import annotations

import time
from typing import Callable

from ..io import Y4MPlaneReader
from ..io.video import open_video, open_writer
from ..parallel.halo import BandLayout, band_bounds
from ..parallel.mesh import replicate
from ..parallel.pp import TwoStagePipeline
from ..state import init_trackers
from ..stereo import StereoParams
from ..stereo.bands import init_band_trackers, stereo_halo
from .mesh_render import mesh_devices
from .stereo_pipeline import (ChunkStream, RenderConfig, RenderProgress, _blank_frames,
                              make_pp_bodies, plane_input, probe_geometry)


def render_stereo_video_pp(
    input_path,
    output_path,
    params: StereoParams | None = None,
    cfg: RenderConfig | None = None,
    progress_cb: Callable[[RenderProgress], None] | None = None,
    cancel_check: Callable[[], bool] | None = None,
    predictor=None,
    mesh_axes: dict[str, int] | None = None,
    devices=None,
) -> RenderProgress:
    """Two-slice pipelined fused 2D->3D render (see the module docstring):
    depth on the first ``dp`` devices, stereo on the next ``dp``
    (``devices`` as in ``mesh_render.mesh_devices``; a device may
    repeat)."""
    params = params or StereoParams()
    cfg = cfg or RenderConfig()
    axes = dict(mesh_axes or {})
    if predictor is None:
        raise ValueError("--mesh pp=2 pipelines depth against stereo and "
                         "needs the fused route (no --depth input)")
    if cfg.resume:
        raise ValueError("--resume is not supported with --mesh; "
                         "re-run without --mesh to continue a checkpoint")
    if axes.get("sp", 1) != 1 or axes.get("tp", 1) != 1:
        raise ValueError("--mesh pp=2 composes with dp only "
                         "(dp=N gives each slice N devices)")
    w = int(axes.get("dp", 1))
    devices = mesh_devices(2 * w, cfg.device, devices)
    if 2 * w > len(devices):
        raise ValueError(f"mesh pp=2,dp={w} needs {2 * w} devices, "
                         f"have {len(devices)}")
    slice_a, slice_b = devices[:w], devices[w:2 * w]
    dev_a, dev_b = slice_a[0], slice_b[0]

    rd = open_video(input_path, cfg.start_s, cfg.end_s)
    wr = stream = None
    try:
        fps = cfg.fps or rd.fps or 30.0
        first, geom = probe_geometry(rd, cfg)
        blank_set = _blank_frames(input_path, fps) if cfg.skip_blank_frames else set()
        yuv_in = plane_input(input_path, cfg, rd)
        if yuv_in:
            rd.close()
            rd = Y4MPlaneReader(input_path)
        bands = None
        if w > 1:
            halo = stereo_halo(params)
            band_bounds(geom.warp_h, w, halo)  # a warp-size band too thin raises here
            bands = BandLayout.make(geom.eye_h, slice_b, halo, geom.eye_w)
        preds = {d: replicate(predictor, d) for d in dict.fromkeys(slice_a)}
        depth_body, _ = make_pp_bodies(
            params, geom, cfg, [preds[d] for d in slice_a] if w > 1 else preds[dev_a], yuv_in)
        _, stereo_body = make_pp_bodies(params, geom, cfg, None, yuv_in, bands)
        wr = open_writer(output_path, geom.out_w, geom.out_h, fps, cfg.codec, cfg.crf)
        # the reads land on slice A; the outputs are read back from slice B
        stream = ChunkStream(rd, None, wr, None, None, dev_a, geom, cfg, yuv_in, blank_set,
                             frame=None if yuv_in else first)

        def chunks():
            while not (cancel_check and cancel_check()):
                item = stream.read()
                if item is None:
                    return
                frames_in, _, blanks_in, n = item
                yield frames_in, blanks_in, n

        def stage_b(trackers, item, depths):
            frames_in, blanks_in, n = item
            trackers, out_u8 = stereo_body(trackers, frames_in, depths, blanks_in)
            return trackers, (out_u8, n)

        pipe = TwoStagePipeline([*slice_a, *slice_b], w, lambda item: depth_body(item[0]),
                                stage_b)
        trackers = (init_band_trackers(bands, geom.eye_w) if bands is not None
                    else init_trackers(geom.eye_h, geom.eye_w, device=dev_b))
        prog = RenderProgress()
        for out_u8, n in pipe.run(chunks(), trackers):
            stream.emit(out_u8, n)
            prog.frames_done += n
            prog.fps = prog.frames_done / max(time.time() - prog.started, 1e-6)
            if progress_cb:
                progress_cb(prog)
        stream.flush()
    finally:
        if stream is not None:
            stream.close()
        rd.close()
        if wr is not None:
            wr.close()
    return prog
