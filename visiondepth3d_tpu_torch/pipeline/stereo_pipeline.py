"""End-to-end stereo render: video (+ depth video) -> packed 3D video.

Counterpart of ``visiondepth3d_tpu/pipeline/stereo_pipeline.py`` on one
device. Per chunk of frames: raw YUV420 planes go to the device and become
RGB there; the frames are cropped; depth comes from the predictor (the
fused route) or from a depth video; the stereo step runs frame by frame
with the trackers carried across frames and chunks; the eyes are packed,
rounded to u8 and converted to YUV420 on the device; one readback per
chunk. The readback of chunk n is queued before chunk n + 1 is launched,
and its encode on the host overlaps chunk n + 1 on the device.

Not ported yet, and refused with NotImplementedError: multi-device
meshes, resume checkpoints, blank-frame detection, black-bar auto-crop.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np
import torch

from ..device import host_to_device, resolve_device
from ..io import Y4MPlaneReader, open_depth_reader, open_video, open_writer
from ..ops import formats as fmt_ops
from ..ops.convert import (float_to_u8_round, float_to_u8_trunc, rgb_u8_to_yuv420,
                           u8_to_float, yuv420_to_rgb_u8)
from ..ops.resize import resize_bilinear
from ..state import init_trackers
from ..stereo import StereoParams
from ..stereo.step import render_chunk
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
    device: str = "cuda"
    # not ported yet: a render that asks for any of these raises
    skip_blank_frames: bool = False
    auto_crop_black_bars: bool = False
    resume: bool = False
    mesh: str | None = None


def _check_ported(params: StereoParams, cfg: RenderConfig):
    unported = {"skip_blank_frames": cfg.skip_blank_frames,
                "auto_crop_black_bars": cfg.auto_crop_black_bars,
                "resume": cfg.resume,
                "mesh": cfg.mesh not in (None, "off")}
    for name, asked in unported.items():
        if asked:
            raise NotImplementedError(f"RenderConfig.{name} is not ported yet")
    if cfg.output_format not in fmt_ops.FORMATS:
        raise NotImplementedError(
            f"output format {cfg.output_format!r} is not ported yet; use {fmt_ops.FORMATS}")


def make_chunk_fn(params: StereoParams, geom: RenderGeometry, cfg: RenderConfig,
                  predictor=None, yuv_in: bool = False) -> Callable:
    """The chunk function: u8 in -> (trackers, packed u8 [T, out_h, out_w, 3]).

    With ``predictor``: ``fn(trackers, frames_in)``, depth inferred from
    the cropped frames (the fused route). Without: ``fn(trackers,
    frames_in, depths_u16)`` with depth as lossless uint16 ([T, Hd, Wd]).
    ``frames_in`` is RGB u8 [T, H, W, 3], or a (Y, U, V) tuple of u8 plane
    batches when ``yuv_in``.
    """
    params = params.replace(warp_hw=(geom.warp_h, geom.warp_w)).with_shift_bound(geom.warp_w)
    eye_hw = (geom.eye_h, geom.eye_w)
    to_u8 = float_to_u8_trunc if params.parity_quantize else float_to_u8_round

    def crop(x):
        return x[:, geom.crop_y: geom.crop_y + geom.crop_h,
                 geom.crop_x: geom.crop_x + geom.crop_w]

    def decode(frames_in):
        return u8_to_float(yuv420_to_rgb_u8(*frames_in) if yuv_in else frames_in)

    def finish(trackers, frames, depths):
        trackers, outs = render_chunk(params, trackers, frames, depths)
        packed = []
        for left, right in zip(outs.left, outs.right):
            left, right = fmt_ops.pack_per_eye(left, right, cfg.output_format,
                                               geom.per_eye_w, geom.per_eye_h)
            packed.append(fmt_ops.format_3d_output(left, right, cfg.output_format))
        return trackers, to_u8(torch.stack(packed))

    if predictor is not None:
        @torch.inference_mode()
        def chunk_fused(trackers, frames_in):
            frames = crop(decode(frames_in))  # [T, ch, cw, 3]
            depths = predictor.predict_01(frames, out_hw=eye_hw)
            return finish(trackers, resize_bilinear(frames, eye_hw), depths)

        return chunk_fused

    @torch.inference_mode()
    def chunk_fn(trackers, frames_in, depths_u16):
        frames = decode(frames_in)
        depths = depths_u16.to(torch.float32) / 65535.0
        if tuple(depths.shape[1:]) != tuple(frames.shape[1:3]):
            depths = resize_bilinear(depths, tuple(frames.shape[1:3]))
        frames = resize_bilinear(crop(frames), eye_hw)
        depths = resize_bilinear(crop(depths), eye_hw)
        return finish(trackers, frames, depths)

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
    ``cancel_check`` is polled between chunks.
    """
    if depth_path is None and predictor is None:
        raise ValueError("need a depth video or a depth predictor")
    if depth_path is not None and predictor is not None:
        raise ValueError("pass either depth_path or predictor, not both")
    params = params or StereoParams()
    cfg = cfg or RenderConfig()
    _check_ported(params, cfg)
    dev = resolve_device(cfg.device)
    if predictor is not None and predictor.device != dev:
        raise ValueError(f"predictor is on {predictor.device}, the render on {dev}")

    rd = open_video(input_path, cfg.start_s, cfg.end_s)
    dd = open_depth_reader(depth_path) if depth_path is not None else None
    wr = None
    try:
        fps = cfg.fps or rd.fps or 30.0
        geom = resolve_geometry(rd.width, rd.height, cfg.output_format, cfg.output_height,
                                cfg.aspect, cfg.preserve_original_aspect)
        # raw planes in: the host only freads, the device converts
        yuv_in = (str(input_path).endswith(".y4m") and cfg.start_s is None
                  and cfg.end_s is None and rd.width % 2 == 0 and rd.height % 2 == 0)
        if yuv_in:
            rd.close()
            rd = Y4MPlaneReader(input_path)
        chunk_fn = make_chunk_fn(params, geom, cfg, predictor=predictor, yuv_in=yuv_in)
        trackers = init_trackers(geom.eye_h, geom.eye_w, dev)
        wr = open_writer(output_path, geom.out_w, geom.out_h, fps, cfg.codec, cfg.crf)
        yuv_out = (hasattr(wr, "write_yuv420") and geom.out_w % 2 == 0
                   and geom.out_h % 2 == 0)
        prog = RenderProgress()
        pending = None  # (host array, frame count, event): encode overlaps compute

        def flush(pending):
            if pending is None:
                return
            host, n, event = pending
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

        eof = False
        while not eof:
            if cancel_check and cancel_check():
                break
            frames, depths = [], []
            while len(frames) < cfg.chunk_size:
                frame = rd.read()
                d = dd.read() if (dd is not None and frame is not None) else None
                if frame is None or (dd is not None and d is None):
                    eof = True
                    break
                frames.append(frame)
                depths.append(d)
            if not frames:
                if prog.frames_done == 0:
                    raise ValueError("empty input video")
                break
            n = len(frames)
            frames += [frames[-1]] * (cfg.chunk_size - n)  # static chunk shape
            depths += [depths[-1]] * (cfg.chunk_size - n)
            if yuv_in:
                frames_in = tuple(host_to_device(np.stack([f[i] for f in frames]), dev)
                                  for i in range(3))
            else:
                frames_in = host_to_device(np.stack(frames), dev)
            with torch.inference_mode():
                if dd is None:
                    trackers, out_u8 = chunk_fn(trackers, frames_in)
                else:
                    db = np.clip(np.stack(depths) * 65535.0 + 0.5, 0, 65535).astype(np.uint16)
                    trackers, out_u8 = chunk_fn(trackers, frames_in, host_to_device(db, dev))
                if yuv_out:
                    planes = rgb_u8_to_yuv420(out_u8)
                    out_u8 = torch.cat([p.reshape(p.shape[0], -1) for p in planes], dim=1)
            host = torch.empty(out_u8.shape, dtype=torch.uint8,
                               pin_memory=dev.type == "cuda")
            host.copy_(out_u8, non_blocking=dev.type == "cuda")
            event = None
            if dev.type == "cuda":
                event = torch.cuda.Event()
                event.record()
            flush(pending)
            pending = (host, n, event)
            prog.frames_done += n
            prog.fps = prog.frames_done / max(time.time() - prog.started, 1e-6)
            if progress_cb:
                progress_cb(prog)
        flush(pending)
    finally:
        rd.close()
        if dd is not None:
            dd.close()
        if wr is not None:
            wr.close()
    return prog
