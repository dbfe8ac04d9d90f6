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

Not ported yet, and refused with NotImplementedError: multi-device meshes.
"""

from __future__ import annotations

import dataclasses
import subprocess
import sys
import time
from typing import Callable

import numpy as np
import torch

from ..device import host_to_device, resolve_device
from ..io import Y4MPlaneReader, blackdetect, open_depth_reader, open_video, open_writer
from ..ops import formats as fmt_ops
from ..ops.convert import (float_to_u8_round, float_to_u8_trunc, rgb_u8_to_yuv420,
                           u8_to_float, yuv420_to_rgb_u8)
from ..ops.resize import resize_bilinear
from ..state import init_trackers
from ..stereo import StereoParams
from ..stereo.step import render_chunk
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
    mesh: str | None = None  # not ported yet: only None or "off"


def _check_ported(cfg: RenderConfig):
    if cfg.mesh not in (None, "off"):
        raise NotImplementedError(f"RenderConfig.mesh {cfg.mesh!r} is not ported yet "
                                  f"(one device: None or 'off')")


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


def make_chunk_fn(params: StereoParams, geom: RenderGeometry, cfg: RenderConfig,
                  predictor=None, yuv_in: bool = False) -> Callable:
    """The chunk function: u8 in -> (trackers, packed u8 [T, out_h, out_w, 3]).

    With ``predictor``: ``fn(trackers, frames_in, blanks=None)``, depth
    inferred from the cropped frames (the fused route). Without:
    ``fn(trackers, frames_in, depths_u16, blanks=None)`` with depth as
    lossless uint16 ([T, Hd, Wd]). ``frames_in`` is RGB u8 [T, H, W, 3], or
    a (Y, U, V) tuple of u8 plane batches when ``yuv_in``; ``blanks`` an
    optional [T] bool tensor of blank frames.
    """
    params = params.replace(warp_hw=(geom.warp_h, geom.warp_w)).with_shift_bound(geom.warp_w)
    eye_hw = (geom.eye_h, geom.eye_w)
    to_u8 = float_to_u8_trunc if params.parity_quantize else float_to_u8_round

    def crop(x):
        return x[:, geom.crop_y: geom.crop_y + geom.crop_h,
                 geom.crop_x: geom.crop_x + geom.crop_w]

    def decode(frames_in):
        return u8_to_float(yuv420_to_rgb_u8(*frames_in) if yuv_in else frames_in)

    def finish(trackers, frames, depths, blanks):
        trackers, outs = render_chunk(params, trackers, frames, depths, blanks)
        packed = []
        for left, right in zip(outs.left, outs.right):
            left, right = fmt_ops.pack_per_eye(left, right, cfg.output_format,
                                               geom.per_eye_w, geom.per_eye_h)
            packed.append(fmt_ops.format_3d_output(
                left, right, cfg.output_format,
                anaglyph_bgr_convention=cfg.anaglyph_bgr_convention))
        return trackers, to_u8(torch.stack(packed))

    if predictor is not None:
        @torch.inference_mode()
        def chunk_fused(trackers, frames_in, blanks=None):
            frames = crop(decode(frames_in))  # [T, ch, cw, 3]
            depths = predictor.predict_01(frames, out_hw=eye_hw)
            return finish(trackers, resize_bilinear(frames, eye_hw), depths, blanks)

        return chunk_fused

    @torch.inference_mode()
    def chunk_fn(trackers, frames_in, depths_u16, blanks=None):
        frames = decode(frames_in)
        depths = depths_u16.to(torch.float32) / 65535.0
        if tuple(depths.shape[1:]) != tuple(frames.shape[1:3]):
            depths = resize_bilinear(depths, tuple(frames.shape[1:3]))
        frames = resize_bilinear(crop(frames), eye_hw)
        depths = resize_bilinear(crop(depths), eye_hw)
        return finish(trackers, frames, depths, blanks)

    return chunk_fn


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


def render_stereo_video(input_path, depth_path, output_path,
                        params: StereoParams | None = None,
                        cfg: RenderConfig | None = None,
                        progress_cb: Callable[[RenderProgress], None] | None = None,
                        cancel_check: Callable[[], bool] | None = None,
                        predictor=None) -> RenderProgress:
    """Render a whole video; returns the final progress.

    ``depth_path=None`` with a ``predictor`` is the fused 2D->3D route.
    ``cancel_check`` is polled between chunks; a cancelled render keeps its
    last checkpoint, and ``cfg.resume`` continues it (a .y4m output is cut
    back to the checkpoint and appended to).
    """
    if depth_path is None and predictor is None:
        raise ValueError("need a depth video or a depth predictor")
    if depth_path is not None and predictor is not None:
        raise ValueError("pass either depth_path or predictor, not both")
    params = params or StereoParams()
    cfg = cfg or RenderConfig()
    _check_ported(cfg)
    dev = resolve_device(cfg.device)
    if predictor is not None and predictor.device != dev:
        raise ValueError(f"predictor is on {predictor.device}, the render on {dev}")

    rd = open_video(input_path, cfg.start_s, cfg.end_s)
    dd = open_depth_reader(depth_path) if depth_path is not None else None
    wr = None
    try:
        fps = cfg.fps or rd.fps or 30.0
        first = rd.read()  # black-bar detection reads it before any reopen
        if first is None:
            raise ValueError("empty input video")
        top, bottom = _detect_black_bars_host(first) if cfg.auto_crop_black_bars else (0, 0)
        geom = resolve_geometry(rd.width, rd.height, cfg.output_format, cfg.output_height,
                                cfg.aspect, cfg.preserve_original_aspect, top, bottom)
        blank_set = _blank_frames(input_path, fps) if cfg.skip_blank_frames else set()
        # raw planes in: the host only freads, the device converts
        yuv_in = (str(input_path).endswith(".y4m") and cfg.start_s is None
                  and cfg.end_s is None and rd.width % 2 == 0 and rd.height % 2 == 0)
        if yuv_in:
            rd.close()
            rd = Y4MPlaneReader(input_path)
        chunk_fn = make_chunk_fn(params, geom, cfg, predictor=predictor, yuv_in=yuv_in)
        trackers = init_trackers(geom.eye_h, geom.eye_w, dev)

        skip_n = 0
        if cfg.resume:
            state = resume.load_checkpoint(output_path, trackers)
            if state is not None:
                skip_n, trackers = state
                # the file may be a chunk ahead of the checkpoint
                resume.truncate_y4m_to(output_path, skip_n)
        wr = open_writer(output_path, geom.out_w, geom.out_h, fps, cfg.codec, cfg.crf,
                         append=skip_n > 0)
        yuv_out = (hasattr(wr, "write_yuv420") and geom.out_w % 2 == 0
                   and geom.out_h % 2 == 0)
        prog = RenderProgress(frames_done=skip_n)
        pending = None  # (host array, frame count, event, checkpoint): encode overlaps compute

        def flush(pending):
            if pending is None:
                return
            host, n, event, ckpt = pending
            if event is not None:
                event.synchronize()
            arr = host.numpy()
            hh, ww = geom.out_h, geom.out_w
            for i in range(n):
                if yuv_out:
                    y = arr[i, : hh * ww].reshape(hh, ww)
                    u, v = arr[i, hh * ww:].reshape(2, hh // 2, ww // 2)
                    wr.write_yuv420(y, u, v)
                else:
                    wr.write(arr[i])
            if ckpt is not None:  # after the chunk's frames are in the file
                resume.save_checkpoint(output_path, *ckpt)

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
        frame_idx = skip_n

        chunks_since_ckpt = 0
        while not eof:
            if cancel_check and cancel_check():
                break
            frames, depths, blanks = [], [], []
            while len(frames) < cfg.chunk_size:
                if frame is None:
                    frame = rd.read()
                d = dd.read() if (dd is not None and frame is not None) else None
                if frame is None or (dd is not None and d is None):
                    eof = True
                    break
                frames.append(frame)
                depths.append(d)
                blanks.append(frame_idx in blank_set)
                frame_idx += 1
                frame = None
            if not frames:
                break
            n = len(frames)
            frames += [frames[-1]] * (cfg.chunk_size - n)  # static chunk shape
            depths += [depths[-1]] * (cfg.chunk_size - n)
            blanks += [False] * (cfg.chunk_size - n)  # padded tail frames are not blank
            if yuv_in:
                frames_in = tuple(host_to_device(np.stack([f[i] for f in frames]), dev)
                                  for i in range(3))
            else:
                frames_in = host_to_device(np.stack(frames), dev)
            # a chunk without a blank frame takes the step without the passthrough
            blanks_in = host_to_device(np.asarray(blanks), dev) if any(blanks) else None
            with torch.inference_mode():
                if dd is None:
                    trackers, out_u8 = chunk_fn(trackers, frames_in, blanks_in)
                else:
                    db = np.clip(np.stack(depths) * 65535.0 + 0.5, 0, 65535).astype(np.uint16)
                    trackers, out_u8 = chunk_fn(trackers, frames_in, host_to_device(db, dev),
                                                blanks_in)
                if yuv_out:
                    planes = rgb_u8_to_yuv420(out_u8)
                    out_u8 = torch.cat([p.reshape(p.shape[0], -1) for p in planes], dim=1)
            host = _to_host(out_u8)
            chunks_since_ckpt += 1
            ckpt = None
            if 0 < cfg.checkpoint_every_chunks <= chunks_since_ckpt:
                # the trackers as this chunk left them, copied behind its output
                ckpt = (frame_idx, dataclasses.replace(trackers, **{
                    f.name: _to_host(getattr(trackers, f.name))
                    for f in dataclasses.fields(trackers)}))
                chunks_since_ckpt = 0
            event = None
            if dev.type == "cuda":
                event = torch.cuda.Event()
                event.record()
            flush(pending)
            pending = (host, n, event, ckpt)
            prog.frames_done += n
            prog.fps = (prog.frames_done - skip_n) / max(time.time() - prog.started, 1e-6)
            if progress_cb:
                progress_cb(prog)
        flush(pending)
        if eof:
            resume.clear_checkpoint(output_path)
    finally:
        rd.close()
        if dd is not None:
            dd.close()
        if wr is not None:
            wr.close()
    return prog
