"""End-to-end stereo render: video (+ depth video) -> packed 3D video.

Counterpart of ``visiondepth3d_tpu/pipeline/stereo_pipeline.py`` on one
device. Per chunk of frames: raw YUV420 planes go to the device and become
RGB there; the frames are cropped (black bars first, when asked, then to
the target aspect); depth comes from the predictor (the fused route) or
from a depth video; the stereo step runs frame by frame with the trackers
carried across frames and chunks (blank frames pass the source through);
the eyes are packed in the output format, rounded to u8 and converted to
YUV420 on the device; one readback per chunk. The readback of chunk n is
queued before chunk n + 1 is launched, and its encode on the host
overlaps chunk n + 1 on the device. Every ``checkpoint_every_chunks``
chunks the trackers go to an ``<output>.resume.npz`` sidecar, written
once that chunk's frames are in the file; ``resume`` continues from it.

``RenderConfig.mesh`` runs the render over several devices, as in the JAX
package: ``auto`` (the default) takes every visible card for frame-segment
data parallelism when there is more than one and is this single-device
path on one card; ``dp=N`` pins the segments (``mesh_render.py``);
``pp=2`` pipelines depth against stereo on two devices (``pp_render.py``).
"""

from __future__ import annotations

import dataclasses
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable

import numpy as np
import torch

from ..device import resolve_device, same_device
from ..io import Y4MPlaneReader, blackdetect, open_depth_reader, open_video, open_writer
from ..ops import formats as fmt_ops
from ..ops.convert import (float_to_u8_round, float_to_u8_trunc, rgb_u8_to_yuv420,
                           u8_to_float, yuv420_to_rgb_u8)
from ..ops.resize import resize_bilinear
from ..state import init_trackers
from ..stereo import StereoParams
from ..stereo.bands import render_chunk_bands
from ..stereo.step import render_chunk
from ..utils.observability import count, span
from . import resume
from .geometry import RenderGeometry, resolve_geometry


@dataclasses.dataclass
class RenderConfig:
    output_format: str = "Full-SBS"
    output_height: int = 1080
    aspect: str = "Default (16:9)"
    preserve_original_aspect: bool = False
    codec: str = "libx264"
    crf: int = 23
    fps: float | None = None  # None: the input's
    start_s: float | None = None
    end_s: float | None = None
    chunk_size: int = 16
    skip_blank_frames: bool = False
    auto_crop_black_bars: bool = False
    anaglyph_bgr_convention: bool = False
    resume: bool = False  # continue an interrupted render from its sidecar
    checkpoint_every_chunks: int = 8
    device: str = "cuda"
    # multi-device execution: "auto" = frame-segment DP over every visible
    # card when there is more than one (this single-device path on one
    # card); "dp=N" pins the segments, "pp=2" the depth/stereo stages; "off"
    # forces one device (pipeline/mesh_render.py)
    mesh: str | None = "auto"
    # snap the DP segment boundaries to detected scene cuts (an extra decode
    # pass of the clip on the host)
    mesh_snap_scenes: bool = False


def _detect_black_bars_host(frame_u8: np.ndarray, threshold: float = 10.0):
    """Rows of black bar at the top and the bottom of one RGB u8 frame: the
    first row from each side whose mean luma passes ``threshold``; (0, 0)
    when the bars would cover the whole frame."""
    gray = 0.299 * frame_u8[..., 0] + 0.587 * frame_u8[..., 1] + 0.114 * frame_u8[..., 2]
    h = gray.shape[0]
    top = 0
    for i in range(h):
        if gray[i].mean() > threshold:
            top = i
            break
    bottom = 0
    for i in range(h - 1, -1, -1):
        if gray[i].mean() > threshold:
            bottom = h - i - 1
            break
    if top + bottom >= h:
        return 0, 0
    return top, bottom


def _blank_frames(input_path, fps: float) -> set[int]:
    """The clip's blank frame indices; an empty set, with one warning line,
    when detection fails (the render then skips nothing)."""
    try:
        return set(blackdetect.detect_blank_frames(str(input_path), fps))
    except (OSError, subprocess.SubprocessError, ValueError) as e:
        print(f"warning: blank-frame detection failed ({type(e).__name__}: {e}); "
              f"no frame is skipped", file=sys.stderr)
        return set()


def _to_host(x: torch.Tensor) -> torch.Tensor:
    """A host copy of x, queued asynchronously (pinned) for a CUDA tensor."""
    cuda = x.device.type == "cuda"
    host = torch.empty(x.shape, dtype=x.dtype, pin_memory=cuda)
    host.copy_(x, non_blocking=cuda)
    return host


def _chunk_pieces(params: StereoParams, geom: RenderGeometry, cfg: RenderConfig,
                  yuv_in: bool = False, bands=None):
    """The pieces every chunk function is made of: ``decode`` (u8 frames or
    (Y, U, V) planes -> float RGB), ``crop`` and ``finish`` (the stereo step
    over the eye-sized frames and depths, the eyes packed, u8 out). With
    ``bands`` (a ``parallel.halo.BandLayout`` at the eye size) the stereo
    step runs over its row bands (``stereo/bands.py``); everything else
    runs on the chunk's device."""
    params = params.replace(warp_hw=(geom.warp_h, geom.warp_w)).with_shift_bound(geom.warp_w)
    to_u8 = float_to_u8_trunc if params.parity_quantize else float_to_u8_round

    def crop(x):
        return x[:, geom.crop_y: geom.crop_y + geom.crop_h,
                 geom.crop_x: geom.crop_x + geom.crop_w]

    def decode(frames_in):
        return u8_to_float(yuv420_to_rgb_u8(*frames_in) if yuv_in else frames_in)

    def finish(trackers, frames, depths, blanks):
        with span("step"):
            if bands is None:
                trackers, outs = render_chunk(params, trackers, frames, depths, blanks)
            else:
                trackers, outs = render_chunk_bands(params, trackers, frames, depths, bands,
                                                    blanks)
        with span("pack"):
            packed = []
            for left, right in zip(outs.left, outs.right):
                left, right = fmt_ops.pack_per_eye(left, right, cfg.output_format,
                                                   geom.per_eye_w, geom.per_eye_h)
                packed.append(fmt_ops.format_3d_output(
                    left, right, cfg.output_format,
                    anaglyph_bgr_convention=cfg.anaglyph_bgr_convention))
            return trackers, to_u8(torch.stack(packed))

    return decode, crop, finish


def predict_groups(predictor, frames: torch.Tensor, out_hw):
    """Depth of a chunk's frames: ``predictor.predict_01`` of the whole
    chunk, or, for a list of predictors, the frames split by frame over
    them (as even as possible, in order), each group's depth left on its
    predictor's device -> a list of [T_g, h, w]. The model is per frame and
    normalizes each frame by its own range, so nothing crosses groups."""
    if not isinstance(predictor, (list, tuple)):
        return predictor.predict_01(frames, out_hw=out_hw)
    parts = torch.tensor_split(frames, len(predictor))
    return [pr.predict_01(x, out_hw=out_hw) for pr, x in zip(predictor, parts) if x.shape[0]]


def make_chunk_fn(params: StereoParams, geom: RenderGeometry, cfg: RenderConfig,
                  predictor=None, yuv_in: bool = False, bands=None) -> Callable:
    """The chunk function: u8 in -> (trackers, packed u8 [T, out_h, out_w, 3]).

    With ``predictor``: ``fn(trackers, frames_in, blanks=None)``, depth
    inferred from the cropped frames (the fused route; a list of predictors
    splits the chunk's frames over them, ``predict_groups``). Without:
    ``fn(trackers, frames_in, depths_u16, blanks=None)`` with depth as
    lossless uint16 ([T, Hd, Wd]). ``frames_in`` is RGB u8 [T, H, W, 3], or
    a (Y, U, V) tuple of u8 plane batches when ``yuv_in``; ``blanks`` an
    optional [T] bool tensor of blank frames. ``bands``: see
    ``_chunk_pieces``.
    """
    decode, crop, finish = _chunk_pieces(params, geom, cfg, yuv_in, bands)
    eye_hw = (geom.eye_h, geom.eye_w)

    if predictor is not None:
        @torch.inference_mode()
        def chunk_fused(trackers, frames_in, blanks=None):
            with span("decode"):
                frames = crop(decode(frames_in))  # [T, ch, cw, 3]
            with span("depth"):
                depths = predict_groups(predictor, frames, eye_hw)
            with span("decode"):
                frames = resize_bilinear(frames, eye_hw)
            return finish(trackers, frames, depths, blanks)

        return chunk_fused

    @torch.inference_mode()
    def chunk_fn(trackers, frames_in, depths_u16, blanks=None):
        with span("decode"):
            frames = decode(frames_in)
            depths = depths_u16.to(torch.float32) / 65535.0
            if tuple(depths.shape[1:]) != tuple(frames.shape[1:3]):
                depths = resize_bilinear(depths, tuple(frames.shape[1:3]))
            frames = resize_bilinear(crop(frames), eye_hw)
            depths = resize_bilinear(crop(depths), eye_hw)
        return finish(trackers, frames, depths, blanks)

    return chunk_fn


def make_pp_bodies(params: StereoParams, geom: RenderGeometry, cfg: RenderConfig,
                   predictor, yuv_in: bool = False, bands=None) -> tuple[Callable, Callable]:
    """The fused chunk function cut at the depth/stereo boundary, for the
    two-stage pipeline (``parallel/pp.py``):

      depth_body(frames_in) -> depths01 [T, eye_h, eye_w] (a list of frame
          groups for a list of predictors, ``predict_groups``)
      stereo_body(trackers, frames_in, depths01, blanks=None)
          -> (trackers, packed u8)

    Each stage decodes and crops the u8 frames itself, so only the frames
    and the depth cross between the stages. ``stereo_body(depth_body(x))``
    computes what the fused ``make_chunk_fn`` does, op for op. ``bands``:
    the stereo body's row bands (``_chunk_pieces``)."""
    decode, crop, finish = _chunk_pieces(params, geom, cfg, yuv_in, bands)
    eye_hw = (geom.eye_h, geom.eye_w)

    @torch.inference_mode()
    def depth_body(frames_in):
        with span("decode"):
            frames = crop(decode(frames_in))
        with span("depth"):
            return predict_groups(predictor, frames, eye_hw)

    @torch.inference_mode()
    def stereo_body(trackers, frames_in, depths01, blanks=None):
        with span("decode"):
            frames = resize_bilinear(crop(decode(frames_in)), eye_hw)
        return finish(trackers, frames, depths01, blanks)

    return depth_body, stereo_body


@dataclasses.dataclass
class RenderProgress:
    frames_done: int = 0
    total_frames: int | None = None
    fps: float = 0.0
    started: float = dataclasses.field(default_factory=time.time)

    def eta_seconds(self) -> float | None:
        if not self.total_frames or self.fps <= 0:
            return None
        return (self.total_frames - self.frames_done) / self.fps


class _Staging:
    """One set of host buffers a chunk is staged in, pinned for a CUDA
    device: ``frames`` (the Y, U and V planes, or RGB), ``depths`` (uint16,
    when the stream has a depth reader) and ``blanks``. The staging thread
    writes through their numpy views (``*_np``); ``event`` is recorded
    after the set's H2D copies."""

    def __init__(self, frame_shapes, depth_shape, size: int, dev: torch.device):
        cuda = dev.type == "cuda"

        def buf(shape, dtype):
            return torch.empty(shape, dtype=dtype, pin_memory=cuda)

        self.frames = [buf(shape, torch.uint8) for shape in frame_shapes]
        self.depths = None if depth_shape is None else buf(depth_shape, torch.uint16)
        self.blanks = buf((size,), torch.bool)
        self.frames_np = [t.numpy() for t in self.frames]
        self.depths_np = None if self.depths is None else self.depths.numpy()
        self.blanks_np = self.blanks.numpy()
        self.event = torch.cuda.Event(blocking=True) if cuda else None


class _ChunkReader:
    """The reading side of a ``ChunkStream``, run on its staging thread: the
    readers, the absolute index of the next frame to read, what is left of
    ``limit``, and a frame already read (the probe frame of an RGB reader).
    It makes host reads and numpy copies, and calls nothing of torch but
    the wait on a set's event."""

    def __init__(self, rd, dd, yuv_in: bool, blank_set: set[int], frame_idx: int, frame,
                 limit: int | None, size: int):
        self.rd, self.dd, self.yuv_in, self.blank_set = rd, dd, yuv_in, blank_set
        self.frame_idx, self.frame, self.limit, self.size = frame_idx, frame, limit, size

    def fill(self, st: _Staging) -> tuple[int, bool]:
        """Up to ``size`` frames (and as many depth frames) read into ``st``,
        each into its slot as it is read; a short chunk padded with its
        last frame (static chunk shape). (frames read, whether the stream
        ended)."""
        if st.event is not None:
            st.event.synchronize()  # the set's last H2D copies are done
        planes, depths, blanks = st.frames_np, st.depths_np, st.blanks_np
        n, ended = 0, False
        while n < self.size:
            if self.limit is not None and self.limit <= 0:
                ended = True
                break
            if self.frame is None:
                self.frame = self.rd.read()
            d = self.dd.read() if (self.dd is not None and self.frame is not None) else None
            if self.frame is None or (self.dd is not None and d is None):
                ended = True
                break
            for buf, plane in zip(planes, self.frame if self.yuv_in else (self.frame,)):
                buf[n] = plane
            if depths is not None:
                np.copyto(depths[n], np.clip(d * 65535.0 + 0.5, 0, 65535), casting="unsafe")
            blanks[n] = self.frame_idx in self.blank_set
            self.frame_idx += 1
            self.frame = None
            if self.limit is not None:
                self.limit -= 1
            n += 1
        if n:
            for buf in planes + ([] if depths is None else [depths]):
                buf[n:] = buf[n - 1]
            blanks[n:] = False  # padded tail frames are not blank
        return n, ended


class ChunkStream:
    """Chunks of one stream of frames through a chunk function on one
    device. ``read`` hands over up to ``cfg.chunk_size`` frames (and as many
    depth frames), a short chunk padded with its last frame (static chunk
    shape), on the device; ``emit`` converts a chunk's packed output to
    YUV420 planes on the device, queues its readback and writes the
    previous chunk's (one readback in flight); ``launch`` is read, the chunk
    function, emit. ``flush`` writes the last readback. ``frame``: a frame
    already read from ``rd`` (the probe frame of an RGB reader); ``limit``:
    the frames to render, None for all; ``frame_idx``: the absolute index
    of the next frame handed over (blank frames are indexed so).
    With ``output_path`` the trackers are checkpointed beside the output
    every ``cfg.checkpoint_every_chunks`` chunks.

    The readers are read one chunk ahead on the stream's staging thread,
    into two sets of reused host buffers (pinned for a CUDA device, made at
    the first ``read``): while the render thread runs chunk k, the thread
    reads chunk k + 1 into the other set, once that set's H2D copies are
    done. ``read`` waits for the staged chunk, has the next one read, and
    queues the set's H2D copies into fresh device tensors; every device
    operation is launched from the render thread. ``eof`` and
    ``frame_idx`` count the chunks handed over, never the one staged ahead.
    An error of the staging thread is raised from ``read``. ``close`` waits
    for the staging and ends the thread: call it before closing the
    readers. A stream dropped without it reads nothing more once its last
    staging is done.

    Spans (``utils.observability``): each ``launch`` is a ``chunk``,
    numbered from 0 at the stream's first launch, holding ``read``
    (``read.wait``, ``read.upload``), ``dispatch`` (the chunk function's
    ``decode``, ``depth``, ``step``, ``pack``) and ``emit`` (its ``flush``:
    ``flush.wait``, ``flush.write``); the counter ``frames`` takes the
    frames it holds and ``read.ready`` 1 when its frames were staged before
    ``read`` asked for them, else 0. The staging thread opens no span. A dp
    mesh launches its segments' streams in turn, one chunk each a round, so
    there chunk k is round k: the segments' spans of that round share the
    number and the counters sum over them. The pp render calls ``read`` and
    ``emit`` itself: its spans and ``read.ready`` belong to no chunk and it
    counts no frames."""

    def __init__(self, rd, dd, wr, chunk_fn, trackers, dev: torch.device, geom: RenderGeometry,
                 cfg: RenderConfig, yuv_in: bool, blank_set: set[int], frame_idx: int = 0,
                 frame=None, limit: int | None = None, output_path=None):
        self.rd, self.dd, self.wr = rd, dd, wr
        self.chunk_fn, self.trackers, self.dev = chunk_fn, trackers, dev
        self.geom, self.cfg, self.yuv_in = geom, cfg, yuv_in
        self.frame_idx = frame_idx
        self.output_path = output_path
        self.yuv_out = (hasattr(wr, "write_yuv420") and geom.out_w % 2 == 0
                        and geom.out_h % 2 == 0)
        self.eof = False
        self.pending = None  # (host array, frame count, event, checkpoint)
        self.chunks_since_ckpt = 0
        self.chunks = 0  # chunks launched: the next one's index in its spans
        self._reader = _ChunkReader(rd, dd, yuv_in, blank_set, frame_idx, frame, limit,
                                    cfg.chunk_size)
        self._pool = ThreadPoolExecutor(1, thread_name_prefix="vd3d-staging")
        self._sets = None  # two _Staging, made at the first read
        self._job = None  # (set index, future) of the chunk being staged
        self._closed = False

    def _staging(self) -> _Staging:
        size, h, w = self.cfg.chunk_size, self.rd.height, self.rd.width
        if self.yuv_in:
            ch, cw = (h + 1) // 2, (w + 1) // 2
            frame_shapes = [(size, h, w), (size, ch, cw), (size, ch, cw)]
        else:
            frame_shapes = [(size, h, w, 3)]
        depth_shape = None if self.dd is None else (size, self.dd.height, self.dd.width)
        return _Staging(frame_shapes, depth_shape, size, self.dev)

    def _stage(self, k: int):
        return k, self._pool.submit(self._reader.fill, self._sets[k])

    def read(self):
        """(frames_in, depths_u16 or None, blanks or None, n) on the
        device, or None (and ``eof``) when the stream has no frame left."""
        if self._closed:
            raise ValueError("read from a closed ChunkStream")
        with span("read"):
            if self.eof:
                return None
            with span("read.wait"):
                ready = self._job is not None and self._job[1].done()
                if self._sets is None:  # the first read
                    self._sets = (self._staging(), self._staging())
                    self._job = self._stage(0)
                k, job = self._job
                n, ended = job.result()
            self._job = None
            if n == 0:
                self.eof = True
                return None
            count("read.ready", int(ready))
            if ended:
                self.eof = True
            else:
                self._job = self._stage(1 - k)
            self.frame_idx += n
            with span("read.upload"):
                return self._upload(self._sets[k], n)

    def _upload(self, st: _Staging, n: int):
        """The staged chunk in ``st`` copied into fresh device tensors (the
        copies queued, for a CUDA device), then ``st.event`` recorded."""
        cuda = self.dev.type == "cuda"

        def put(t):
            return t.to(self.dev, non_blocking=cuda, copy=True)

        frames_in = tuple(map(put, st.frames)) if self.yuv_in else put(st.frames[0])
        # a chunk without a blank frame takes the step without the passthrough
        blanks_in = put(st.blanks) if st.blanks_np.any() else None
        depths_in = None if st.depths is None else put(st.depths)
        if cuda:
            st.event.record(torch.cuda.current_stream(self.dev))
        return frames_in, depths_in, blanks_in, n

    def close(self) -> None:
        """Wait for the chunk being staged (dropped, as is its error) and end
        the staging thread; the readers are not read again."""
        self._closed = True
        self._job = None
        self._pool.shutdown(wait=True)

    def launch(self) -> int:
        """Read, run and emit one chunk; the frames it holds (0 at the end)."""
        with span("chunk", chunk=self.chunks):
            self.chunks += 1
            item = self.read()
            if item is None:
                return 0
            frames_in, depths_in, blanks_in, n = item
            count("frames", n)
            with span("dispatch"), torch.inference_mode():
                if depths_in is None:
                    self.trackers, out_u8 = self.chunk_fn(self.trackers, frames_in, blanks_in)
                else:
                    self.trackers, out_u8 = self.chunk_fn(self.trackers, frames_in, depths_in,
                                                          blanks_in)
            self.emit(out_u8, n)
            return n

    def emit(self, out_u8: torch.Tensor, n: int) -> None:
        with span("emit"):
            with torch.inference_mode():
                if self.yuv_out:
                    planes = rgb_u8_to_yuv420(out_u8)
                    out_u8 = torch.cat([p.reshape(p.shape[0], -1) for p in planes], dim=1)
            host = _to_host(out_u8)
            self.chunks_since_ckpt += 1
            ckpt = None
            if self.output_path is not None and \
                    0 < self.cfg.checkpoint_every_chunks <= self.chunks_since_ckpt:
                # the trackers as this chunk left them, copied behind its output
                ckpt = (self.frame_idx, dataclasses.replace(self.trackers, **{
                    f.name: _to_host(getattr(self.trackers, f.name))
                    for f in dataclasses.fields(self.trackers)}))
                self.chunks_since_ckpt = 0
            event = None
            if out_u8.device.type == "cuda":
                event = torch.cuda.Event()
                event.record(torch.cuda.current_stream(out_u8.device))
            self.flush()
            self.pending = (host, n, event, ckpt)

    def flush(self) -> None:
        """Write the chunk whose readback is in flight."""
        if self.pending is None:
            return
        with span("flush"):
            host, n, event, ckpt = self.pending
            self.pending = None
            with span("flush.wait"):
                if event is not None:
                    event.synchronize()
            with span("flush.write"):
                arr = host.numpy()
                hh, ww = self.geom.out_h, self.geom.out_w
                for i in range(n):
                    if self.yuv_out:
                        y = arr[i, : hh * ww].reshape(hh, ww)
                        u, v = arr[i, hh * ww:].reshape(2, hh // 2, ww // 2)
                        self.wr.write_yuv420(y, u, v)
                    else:
                        self.wr.write(arr[i])
                if ckpt is not None:  # after the chunk's frames are in the file
                    resume.save_checkpoint(self.output_path, *ckpt)


def plane_input(input_path, cfg: RenderConfig, rd) -> bool:
    """Whether the render reads raw YUV420 planes (the host only freads, the
    device converts): a .y4m of even size without a clip window."""
    return (str(input_path).endswith(".y4m") and cfg.start_s is None and cfg.end_s is None
            and rd.width % 2 == 0 and rd.height % 2 == 0)


def probe_geometry(rd, cfg: RenderConfig):
    """(first frame, geometry) of an opened clip: the black bars are
    detected on its first frame when asked."""
    first = rd.read()  # black-bar detection reads it before any reopen
    if first is None:
        raise ValueError("empty input video")
    top, bottom = _detect_black_bars_host(first) if cfg.auto_crop_black_bars else (0, 0)
    geom = resolve_geometry(rd.width, rd.height, cfg.output_format, cfg.output_height,
                            cfg.aspect, cfg.preserve_original_aspect, top, bottom)
    return first, geom


def render_stereo_video(input_path, depth_path, output_path,
                        params: StereoParams | None = None,
                        cfg: RenderConfig | None = None,
                        progress_cb: Callable[[RenderProgress], None] | None = None,
                        cancel_check: Callable[[], bool] | None = None,
                        predictor=None, devices=None) -> RenderProgress:
    """Render a whole video; returns the final progress.

    ``depth_path=None`` with a ``predictor`` is the fused 2D->3D route.
    ``cancel_check`` is polled between chunks; a cancelled render keeps its
    last checkpoint, and ``cfg.resume`` continues it (a .y4m output is cut
    back to the checkpoint and appended to). ``cfg.mesh`` other than one
    device dispatches to the mesh routes (not with ``resume``), over
    ``devices`` when given (a device may repeat), else over the visible
    cards, or over the CPU repeated when ``cfg.device`` is the CPU. The
    default 'auto' stays on one device for a clip window, which the mesh
    routes do not take.
    """
    if depth_path is None and predictor is None:
        raise ValueError("need a depth video or a depth predictor")
    if depth_path is not None and predictor is not None:
        raise ValueError("pass either depth_path or predictor, not both")
    params = params or StereoParams()
    cfg = cfg or RenderConfig()
    windowed = cfg.start_s is not None or cfg.end_s is not None
    if not cfg.resume and not (windowed and str(cfg.mesh).strip().lower() == "auto"):
        from .mesh_render import mesh_axes_for

        axes = mesh_axes_for(cfg.mesh, cfg.device, devices)
        if axes is not None and axes.get("pp", 1) == 2:
            from .pp_render import render_stereo_video_pp

            return render_stereo_video_pp(input_path, output_path, params, cfg, progress_cb,
                                          cancel_check, predictor, mesh_axes=axes,
                                          devices=devices)
        if axes is not None:
            from .mesh_render import render_stereo_video_mesh

            return render_stereo_video_mesh(input_path, depth_path, output_path, params, cfg,
                                            progress_cb, cancel_check, predictor,
                                            mesh_axes=axes, snap_scenes=cfg.mesh_snap_scenes,
                                            devices=devices)
    dev = resolve_device(cfg.device)
    if predictor is not None and not same_device(predictor.device, dev):
        raise ValueError(f"predictor is on {predictor.device}, the render on {dev}")

    rd = open_video(input_path, cfg.start_s, cfg.end_s)
    dd = open_depth_reader(depth_path) if depth_path is not None else None
    wr = None
    stream = None
    try:
        fps = cfg.fps or rd.fps or 30.0
        first, geom = probe_geometry(rd, cfg)
        blank_set = _blank_frames(input_path, fps) if cfg.skip_blank_frames else set()
        yuv_in = plane_input(input_path, cfg, rd)
        if yuv_in:
            rd.close()
            rd = Y4MPlaneReader(input_path)
        chunk_fn = make_chunk_fn(params, geom, cfg, predictor=predictor, yuv_in=yuv_in)
        trackers = init_trackers(geom.eye_h, geom.eye_w, device=dev)

        skip_n = 0
        if cfg.resume:
            state = resume.load_checkpoint(output_path, trackers)
            if state is not None:
                skip_n, trackers = state
                # the file may be a chunk ahead of the checkpoint
                resume.truncate_y4m_to(output_path, skip_n)
        wr = open_writer(output_path, geom.out_w, geom.out_h, fps, cfg.codec, cfg.crf,
                         append=skip_n > 0)
        prog = RenderProgress(frames_done=skip_n)

        frame = None if yuv_in else first  # the plane reader starts at frame 0
        eof = False
        # fast-forward both streams past the frames already rendered
        for _ in range(skip_n):
            if frame is None:
                frame = rd.read()
            if frame is None or (dd is not None and dd.read() is None):
                eof = True
                break
            frame = None
        stream = ChunkStream(rd, dd, wr, chunk_fn, trackers, dev, geom, cfg, yuv_in, blank_set,
                             frame_idx=skip_n, frame=frame, output_path=output_path)
        stream.eof = eof
        while not stream.eof:
            if cancel_check and cancel_check():
                break
            n = stream.launch()
            if n == 0:
                break
            prog.frames_done += n
            prog.fps = (prog.frames_done - skip_n) / max(time.time() - prog.started, 1e-6)
            if progress_cb:
                progress_cb(prog)
        stream.flush()
        if stream.eof:
            resume.clear_checkpoint(output_path)
    finally:
        if stream is not None:
            stream.close()
        rd.close()
        if dd is not None:
            dd.close()
        if wr is not None:
            wr.close()
    return prog
