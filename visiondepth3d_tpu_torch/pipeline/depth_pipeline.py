"""Depth estimation pipeline: 2D video -> grayscale depth video.

Counterpart of ``visiondepth3d_tpu/pipeline/depth_pipeline.py`` on one
device, with four routes:
- feed-forward models (ONNX graphs too): batches of frames go to the device as u8, are
  resized, normalized and run through the depth model (or, with ``tiled``,
  through Hann-blended model tiles), and every frame's depth is normalized
  by its own percentiles and rounded to u8 or u16 on the device; one
  readback per batch, whose writing on the host overlaps the next batch on
  the device. The letterbox tracker crops black bars before inference and
  the writer reinserts them with a neutral fill;
- Video Depth Anything: chunks of the model's window that carry
  ``overlap`` frames from the previous chunk, each chunk's depth aligned
  (scale and shift) to the previous chunk's tail on those frames and
  normalized by a running percentile EMA (0.9 / 0.1), so the model's
  temporal stability survives the normalization;
- Marigold: frames cropped to multiples of 8, per-batch diffusion in [0, 1]
  streamed straight to the writer;
- DepthCrafter: the clip strided down to ``target_fps``, cropped to
  multiples of 8, and streamed in segments of sliding windows; consecutive
  segments share ``overlap`` frames, on which each segment's raw depth is
  fitted (scale and shift) to the previous one's and cross-faded; the raw
  depth spills to a float16 sidecar (``<output>.raw16.tmp``, removed at the
  end) so a second pass can apply the whole-clip min-max normalization.
The video and diffusion routes take one static letterbox crop, bootstrapped
on the first frames. Resizes, alignment, percentiles and rounding run on
the device.

``DepthConfig.mesh`` spreads the work over devices, as in the JAX package:
the feed-forward route splits each batch's frames over the ``dp`` devices
(``auto``: every visible card when there is more than one), each with its
replica of the model (per-frame normalization keeps every frame on its
device), and stitches them in frame order; DepthCrafter denoises each
segment's windows in parallel over the devices (``run_raw_parallel``). The
video and Marigold routes run on one device, as in the JAX package. With
``tp=K`` each ``dp`` run holds the model Megatron-split over its K devices
(``parallel/tp.py``; the feed-forward route: DepthCrafter's windows spread
over the ``dp`` devices only). With ``sp=M`` each ``dp`` run holds the
model row-sharded over its M devices (``parallel/sp.py``: a token-parallel
DINOv2 and a row-banded DPT neck and head, for the Depth Anything family):
each band's device receives the source rows its input resize reads,
resizes and normalizes them, runs its band of the model and resizes its
depth to its rows of the output; the bands are gathered on the run's
first device, which normalizes and quantizes the whole frames (per-frame
percentiles need them whole). The result is the one-device depth, as
GSPMD's partition of the JAX route is. sp for the other families, with
``tiled``, with ``tp`` or for DepthCrafter raises NotImplementedError
(ROADMAP Queue 1 item 6d); the video and Marigold routes run on one
device under any mesh. ``pp`` is a render axis.
"""

from __future__ import annotations

import dataclasses
import itertools
import os
import time
import warnings
from typing import Callable

import numpy as np
import torch

from ..depth.model import snap
from ..depth.registry import CATALOG, load_predictor
from ..device import host_to_device, resolve_device, same_device
from ..io import letterbox as lb
from ..io.depth_io import open_depth16_writer
from ..io.video import open_video, open_writer
from ..ops.resize import resize_bilinear
from ..ops.tiling import tiled_apply_batch

# the families whose DPT head has the fast order
_FAST_HEAD_FAMILIES = ("dpt_dinov2", "dpt_beit", "dpt_classic", "dpt_hybrid")


@dataclasses.dataclass
class DepthConfig:
    model: str = "depth-anything-v2-small"
    checkpoint: str | None = None
    # square int, (h, w) rectangle, or None = source resolution
    inference_size: int | tuple | None = 518
    batch_size: int = 8
    invert: bool = False
    bits: int = 8  # 8 -> video, 16 -> .vd16 (or FFV1 gray16le)
    dtype: str = "float32"
    codec: str = "libx264"
    percentile_lo: float = 1.0
    percentile_hi: float = 99.0
    track_letterbox: bool = False
    # tiled (Hann) inference: the frame is resized to ``inference_size``
    # height (aspect kept) and cut into overlapping ``tile_size`` model tiles
    tiled: bool = False
    tile_size: int = 518
    tile_overlap: int = 64
    fast_head: bool = True
    steps: int = 2  # diffusion denoise steps
    # DepthCrafter: stride long clips down to this rate; its sliding
    # windows; the frames one segment holds in host memory
    target_fps: float = 15.0
    window_size: int = 24
    overlap: int = 6
    max_segment_frames: int = 96
    # random weights produce noise; tests and benchmarks opt in explicitly (Marigold)
    allow_random: bool = False
    # "auto": the batch (DepthCrafter: the windows) over every visible card
    # when there is more than one; "dp=N" pins it; "off" one device
    mesh: str | None = "auto"
    device: str = "cuda"


def _size_h(size) -> int:
    return int(size[0]) if isinstance(size, (tuple, list)) else int(size)


def _not_ported_6d(what: str) -> str:
    return (f"depth --mesh sp {what} is not ported yet (ROADMAP Queue 1 item 6d); sp runs "
            f"the Depth Anything family (dpt_dinov2) on whole frames, else use dp or tp")


def _refuse_sp(cfg: DepthConfig, tp: int) -> None:
    """sp's combinations still to port raise NotImplementedError (item 6d)."""
    family = CATALOG[cfg.model].family if cfg.model in CATALOG else None
    if cfg.tiled:
        raise NotImplementedError(_not_ported_6d("with --tiled"))
    if tp > 1:
        raise NotImplementedError(_not_ported_6d("together with tp"))
    if cfg.model == "depthcrafter":
        raise NotImplementedError(_not_ported_6d("for DepthCrafter"))
    if family not in (None, "dpt_dinov2", "vda", "diffusion"):
        raise NotImplementedError(_not_ported_6d(f"for the {family} family ({cfg.model})"))


def _resolve_mesh(cfg: DepthConfig, devices=None):
    """-> (the device groups, dp, sp), or (None, 1, 1) for one device: one
    group of ``sp`` or ``tp`` devices per ``dp`` run (batch frames,
    DepthCrafter windows), the run's inputs on the group's first device.
    pp is a render-stage axis."""
    from .mesh_render import mesh_axes_for, mesh_devices

    if cfg.bits not in (8, 16):
        raise ValueError(f"bits {cfg.bits} not in (8, 16)")
    axes = mesh_axes_for(cfg.mesh, cfg.device, devices)
    if not axes:
        return None, 1, 1
    if axes.get("pp", 1) != 1:
        raise ValueError("vd3d depth does not pipeline stages; pp is a "
                         "vd3d render axis (--mesh pp=2)")
    dp, sp, tp = (int(axes.get(a, 1)) for a in ("dp", "sp", "tp"))
    if sp > 1:
        _refuse_sp(cfg, tp)
    group = sp * tp
    if dp * group <= 1:
        return None, 1, 1
    devs = mesh_devices(dp * group, cfg.device, devices)
    if dp * group > len(devs):
        raise ValueError(f"mesh dp={dp},sp={sp},tp={tp} needs {dp * group} devices, have "
                         f"{len(devs)}")
    return [tuple(devs[g * group:(g + 1) * group]) for g in range(dp)], dp, sp


def _batch_runs(n: int, parts: int) -> list[tuple[int, int]]:
    """[start, end) runs of an n-frame batch over ``parts`` devices: runs of
    ceil(n / parts) frames in order (fewer runs for a short batch)."""
    k = -(-n // parts)
    return [(a, min(a + k, n)) for a in range(0, n, k)]


def _queue_readback(out: torch.Tensor):
    """(host tensor, event): out's copy to (pinned) host memory, queued;
    wait on the event (None on the CPU) before reading the host tensor."""
    cuda = out.device.type == "cuda"
    host = torch.empty(out.shape, dtype=out.dtype, pin_memory=cuda)
    host.copy_(out, non_blocking=cuda)
    event = None
    if cuda:
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(out.device))
    return host, event


def _quantize(d01: torch.Tensor, bits: int) -> torch.Tensor:
    """[0, 1] depth -> uint8 (8 bits) or int32 holding the u16 values (16)."""
    if bits == 16:
        return torch.clamp(d01 * 65535.0 + 0.5, 0, 65535).to(torch.int32)
    return torch.clamp(d01 * 255.0 + 0.5, 0, 255).to(torch.uint8)


def _percentiles(d: torch.Tensor, qs) -> list[float]:
    """``np.percentile`` (linear interpolation) of every element of ``d``
    at each q in ``qs``, from one sort on d's device (``torch.quantile``
    refuses more than 2^24 elements: one 32-frame 1080p chunk is 66M)."""
    v = torch.sort(d.reshape(-1)).values
    n = v.numel()
    out = []
    for q in qs:
        pos = q / 100.0 * (n - 1)
        lo = int(np.floor(pos))
        hi = min(lo + 1, n - 1)
        a, b = v[lo].double(), v[hi].double()
        t = pos - lo
        # numpy's lerp: from the nearer end
        out.append(float(b - (b - a) * (1 - t) if t >= 0.5 else a + (b - a) * t))
    return out


def _normalize_depth(d: torch.Tensor, cfg: DepthConfig) -> torch.Tensor:
    """Raw depth [B, h, w] -> each frame normalized by its own percentiles
    (linear, as jnp.percentile), inverted if asked, quantized."""
    q = torch.tensor([cfg.percentile_lo / 100.0, cfg.percentile_hi / 100.0],
                     dtype=d.dtype, device=d.device)
    lo, hi = torch.quantile(d.flatten(1), q, dim=1)[..., None, None]
    d01 = torch.clamp((d - lo) / torch.clamp(hi - lo, min=1e-9), 0.0, 1.0)
    if cfg.invert:
        d01 = 1.0 - d01
    return _quantize(d01, cfg.bits)


def make_depth_batch_fn(pred, cfg: DepthConfig, out_hw: tuple[int, int]) -> Callable:
    """u8 frames [B, H, W, 3] on the predictor's device -> normalized depth
    [B, out_h, out_w]: uint8 for 8 bits, int32 holding the u16 values for 16."""
    if cfg.tiled:
        s = pred._size[0]  # the model's (square) tile size
        hh, ww = out_hw
        wh = max(s, _size_h(cfg.inference_size))  # working height
        wwid = max(s, int(round(wh * ww / max(hh, 1))))
        ov = min(cfg.tile_overlap, s - 1)

    @torch.inference_mode()
    def fn(frames_u8: torch.Tensor) -> torch.Tensor:
        frames = frames_u8.to(torch.float32) / 255.0
        if cfg.tiled:
            x = resize_bilinear(frames, (wh, wwid), channel_last=True)
            d = tiled_apply_batch(pred, x, (s, s), ov)
        else:
            d = pred(frames)  # [B, s, s] raw
        return _normalize_depth(resize_bilinear(d, tuple(out_hw), channel_last=False), cfg)

    return fn


def make_sp_depth_batch_fn(sp, cfg: DepthConfig, out_hw: tuple[int, int]) -> Callable:
    """u8 frames [B, H, W, 3] on the host -> normalized depth [B, out_h,
    out_w] on the lead device of ``sp`` (a ``parallel.sp.SPPredictor``):
    each band's source rows to its device, its band of the model and of
    the output resize there, the bands gathered on the lead, which
    normalizes and quantizes as ``make_depth_batch_fn`` does."""
    from ..parallel.sp import resize_rows, split_rows

    bounds = split_rows(out_hw[0], len(sp.devices))

    @torch.inference_mode()
    def fn(frames_u8: np.ndarray) -> torch.Tensor:
        d = sp.forward_rows(sp.scatter(frames_u8), frames_u8.shape[1])
        return _normalize_depth(resize_rows(d, tuple(out_hw), False, bounds).gather(sp.lead),
                                cfg)

    return fn


def _depth_writer(output_path, width: int, height: int, fps: float, cfg: DepthConfig):
    """(writer, write(frame, top, bottom)): a gray y4m/video of u8 frames, or
    a 16-bit depth stream of int32 frames holding u16 values; the letterbox
    bars reinserted with a neutral fill (``height`` includes them)."""
    if cfg.bits == 16:
        wr = open_depth16_writer(output_path, width, height, fps)

        def write(d, t, b):
            wr.write(lb.reinsert_bars(d.astype(np.uint16), t, b, fill=32768))
    else:
        wr = open_writer(output_path, width, height, fps, cfg.codec)

        def write(d, t, b):
            g = lb.reinsert_bars(d, t, b, fill=128)
            wr.write(np.repeat(g[..., None], 3, axis=-1))
    return wr, write


def _bootstrap_letterbox(rd, cfg: DepthConfig):
    """The letterbox tracker bootstrapped on up to 9 probe frames: (probe
    frames, tracker, top, bottom), or ([], None, 0, 0) without
    ``track_letterbox``. The video routes keep this one crop for the whole
    clip (their windows and running statistics carry across it, so a
    mid-clip bar change cannot re-key them)."""
    if not cfg.track_letterbox:
        return [], None, 0, 0
    pending = []
    for _ in range(9):
        f = rd.read()
        if f is None:
            break
        pending.append(f)
    tracker = lb.LetterboxTracker(rd.height, rd.fps)
    top, bot, _ = tracker.bootstrap(pending)
    return pending, tracker, top, bot


def _random_weights_warning(cfg: DepthConfig):
    if cfg.model.startswith(("onnx:", "local:")):  # their weights are in the file
        return
    warnings.warn(f"{cfg.model}: no checkpoint given, running RANDOM weights - "
                  f"output is not real depth (shape and speed testing only)")


def render_depth_video_file(input_path, output_path, cfg: DepthConfig | None = None,
                            progress_cb: Callable | None = None, predictor=None,
                            cancel_check: Callable | None = None, devices=None) -> int:
    """Estimate the depth of every frame; returns the frame count.
    ``cancel_check`` is polled between batches. A dp mesh runs over
    ``devices`` when given (a device may repeat), the CPU repeated when
    ``cfg.device`` is the CPU, else the visible cards."""
    cfg = cfg or DepthConfig()
    groups, dp, sp = _resolve_mesh(cfg, devices)
    mesh_devs = [g[0] for g in groups] if groups is not None else None
    family = CATALOG[cfg.model].family if cfg.model in CATALOG else None
    if family == "vda":
        return _render_depth_vda(input_path, output_path, cfg, progress_cb, predictor,
                                 cancel_check)
    if cfg.model == "depthcrafter":
        return _render_depth_crafter(input_path, output_path, cfg, progress_cb, predictor,
                                     cancel_check, mesh_devs)
    if family == "diffusion":
        return _render_depth_marigold(input_path, output_path, cfg, progress_cb, predictor,
                                      cancel_check)
    dev = resolve_device(cfg.device)
    rd = open_video(input_path)
    wr = None
    segments: list = []  # (first frame, top, bottom) per letterbox crop
    try:
        if cfg.inference_size is None:
            cfg = dataclasses.replace(cfg, inference_size=(rd.height, rd.width))
        if predictor is None:
            if cfg.checkpoint is None:
                _random_weights_warning(cfg)
            predictor = load_predictor(cfg.model, cfg.checkpoint,
                                       cfg.tile_size if cfg.tiled else cfg.inference_size,
                                       dtype=cfg.dtype, device=dev, fast_head=cfg.fast_head)
        elif not same_device(predictor.device, dev):
            raise ValueError(f"predictor is on {predictor.device}, the route on {dev}")
        run_devs = [dev]
        preds = {dev: predictor}
        if groups is not None:
            from ..parallel.mesh import replicate
            from ..parallel.sp import SPPredictor, is_row_shardable
            from ..parallel.tp import tp_predictor

            run_devs = mesh_devs
            if cfg.batch_size % dp:
                # round the batch up so every device gets equal frames
                cfg = dataclasses.replace(cfg, batch_size=-(-cfg.batch_size // dp) * dp)
            if sp > 1 and not is_row_shardable(predictor):
                raise NotImplementedError(_not_ported_6d(
                    f"for {type(getattr(predictor, 'model', predictor)).__name__} "
                    f"({cfg.model})"))

            def split(g):  # a replica, or the model over the group's sp or tp devices
                if sp > 1:
                    return SPPredictor(predictor, g)
                return tp_predictor(predictor, g) if len(g) > 1 else replicate(predictor, g[0])

            models = {g: split(g) for g in dict.fromkeys(groups)}  # one per distinct group
            preds = {g[0]: models[g] for g in groups}

        # letterbox: bootstrap on up to 9 probe frames, then the tracker runs
        # on every frame; a confirmed bar change closes the batch
        pending_frames, tracker, top, bot = _bootstrap_letterbox(rd, cfg)
        if tracker is not None:
            segments = [(0, top, bot)]

        fns: dict = {}

        def get_fn(d, ch):
            if (d, ch) not in fns:
                make = make_sp_depth_batch_fn if sp > 1 else make_depth_batch_fn
                fns[d, ch] = make(preds[d], cfg, (ch, rd.width))
            return fns[d, ch]

        wr, write = _depth_writer(output_path, rd.width, rd.height, rd.fps, cfg)

        n_done = 0
        t0 = time.time()
        batch: list = []
        batch_bars = (top, bot)
        # ([(host tensor, event)] per device run, bars): written while the
        # next batch runs
        pending = None

        def drain():
            if pending is None:
                return
            pieces, bars = pending
            for host, event in pieces:
                if event is not None:
                    event.synchronize()
                for d in host.numpy():
                    write(d, *bars)

        def flush():
            nonlocal n_done, pending
            if not batch:
                return
            arr = np.stack(batch)
            # every device's run is launched before any is read back
            # (an sp run scatters the frames' rows to its bands itself)
            outs = [get_fn(d, arr.shape[1])(arr[a:b] if sp > 1 else host_to_device(arr[a:b], d))
                    for (a, b), d in zip(_batch_runs(len(batch), len(run_devs)), run_devs)]
            pieces = [_queue_readback(out) for out in outs]
            drain()
            pending = (pieces, batch_bars)
            n_done += len(batch)
            batch.clear()
            if progress_cb:
                progress_cb(n_done, n_done / max(time.time() - t0, 1e-6))

        frame_idx = 0
        while True:
            if cancel_check and not batch and cancel_check():
                break
            f = pending_frames.pop(0) if pending_frames else rd.read()
            if f is None:
                break
            t2, b2 = tracker.update(f, frame_idx) if tracker is not None else (0, 0)
            if (t2, b2) != batch_bars:
                flush()  # bars changed: close the batch at the old crop
                batch_bars = (t2, b2)
                if segments and (t2, b2) != segments[-1][1:]:
                    segments.append((frame_idx, t2, b2))
            batch.append(f[t2: rd.height - b2] if (t2 or b2) else f)
            if len(batch) == cfg.batch_size:
                flush()
            frame_idx += 1
        flush()
        drain()
    finally:
        rd.close()
        if wr is not None:
            wr.close()
        if cfg.track_letterbox and segments:
            lb.save_sidecar(output_path, segments[0][1], segments[0][2], segments=segments)
    return n_done


def _video_route_setup(rd, cfg: DepthConfig, dev, predictor, load):
    """The parts both video routes share: the predictor (``load()`` when
    none is given) on the route's device and the static letterbox crop.
    Returns (predictor, probe frames, top, bottom)."""
    if predictor is None:
        if cfg.checkpoint is None:
            _random_weights_warning(cfg)
        predictor = load()
    elif not same_device(predictor.device, dev):
        raise ValueError(f"predictor is on {predictor.device}, the route on {dev}")
    pending, _, top, bot = _bootstrap_letterbox(rd, cfg)
    return predictor, pending, top, bot


def _frames_cropped(rd, pending, top: int, rows: int, cols: int):
    """The clip's frames (the probe frames first), cropped to ``rows`` from
    ``top`` and to ``cols``."""
    for f in pending:
        yield f[top: top + rows, :cols]
    for f in rd:
        yield f[top: top + rows, :cols]


def _render_depth_vda(input_path, output_path, cfg: DepthConfig, progress_cb=None,
                      predictor=None, cancel_check=None) -> int:
    """Video Depth Anything: chunks of the model's window, each carrying the
    previous chunk's last ``overlap`` frames; each chunk's depth is fitted
    (scale and shift) to the previous chunk's tail on those frames, resized
    to the frame, and normalized by a running EMA (0.9 / 0.1) of its
    percentiles. ``cancel_check`` is polled between chunks."""
    from ..depth.vda import _align_scale_shift

    dev = resolve_device(cfg.device)
    rd = open_video(input_path)
    wr = None
    top = bot = 0
    n = 0
    try:
        size = cfg.inference_size if cfg.inference_size is not None else (rd.height, rd.width)
        if isinstance(size, (tuple, list)):
            if size[0] != size[1]:
                raise ValueError("video-depth-anything runs its windowed pipeline at a square "
                                 "size; pass an int inference size")
            size = int(size[0])
        pred, pending, top, bot = _video_route_setup(
            rd, cfg, dev, predictor,
            lambda: load_predictor(cfg.model, cfg.checkpoint, size, dtype=cfg.dtype, device=dev))
        win, ov = pred.cfg.window, max(1, pred.cfg.overlap)
        s = snap(size, pred.cfg.base.backbone.patch_size)
        ch = rd.height - top - bot
        wr, write = _depth_writer(output_path, rd.width, rd.height, rd.fps, cfg)
        t0 = time.time()
        ema = None  # running (lo, hi)
        prev_tail, carry = None, []
        gen = _frames_cropped(rd, pending, top, ch, rd.width)
        with torch.inference_mode():
            while True:
                if cancel_check and cancel_check():
                    break  # chunk-boundary cancel poll
                chunk = list(carry)
                for f in gen:
                    chunk.append(f)
                    if len(chunk) == win:
                        break
                new = len(chunk) - len(carry)
                if new <= 0:
                    break
                x = host_to_device(np.stack(chunk), dev).to(torch.float32) / 255.0
                d = pred(resize_bilinear(x, (s, s), channel_last=True))  # [t, s', s'] raw
                if prev_tail is not None:
                    a, b = _align_scale_shift(d[: len(carry)], prev_tail)
                    d = (d * a + b)[len(carry):]
                prev_tail = d[-ov:]
                carry = chunk[-ov:]
                depth = resize_bilinear(d, (ch, rd.width), channel_last=False)
                lo, hi = _percentiles(depth, (cfg.percentile_lo, cfg.percentile_hi))
                ema = (lo, hi) if ema is None else (0.9 * ema[0] + 0.1 * lo,
                                                    0.9 * ema[1] + 0.1 * hi)
                d01 = torch.clamp((depth.double() - ema[0]) / max(ema[1] - ema[0], 1e-9), 0, 1)
                if cfg.invert:
                    d01 = 1.0 - d01
                for frame in _quantize(d01, cfg.bits).cpu().numpy():
                    write(frame, top, bot)
                n += depth.shape[0]
                if progress_cb:
                    progress_cb(n, n / max(time.time() - t0, 1e-6))
    finally:
        rd.close()
        if wr is not None:
            wr.close()
        if cfg.track_letterbox:
            lb.save_sidecar(output_path, top, bot)
    return n


def _render_depth_marigold(input_path, output_path, cfg: DepthConfig, progress_cb=None,
                           pipeline=None, cancel_check=None) -> int:
    """Marigold: frames cropped to multiples of 8 (the latent stride), each
    batch's depth in [0, 1] streamed straight to the writer (every frame's
    depth is absolute, so nothing carries). ``cancel_check`` is polled after
    each full batch."""
    dev = resolve_device(cfg.device)
    rd = open_video(input_path)
    wr = None
    top = bot = 0
    n = 0
    try:
        pipeline, pending, top, bot = _video_route_setup(
            rd, cfg, dev, pipeline,
            lambda: load_predictor(cfg.model, cfg.checkpoint, dtype=cfg.dtype, device=dev,
                                   steps=cfg.steps, allow_random=cfg.allow_random))
        h8, w8 = ((rd.height - top - bot) // 8) * 8, (rd.width // 8) * 8
        wr, write = _depth_writer(output_path, w8, h8 + top + bot, rd.fps or 24.0, cfg)
        t0 = time.time()
        batch: list = []

        def flush():
            nonlocal n
            if not batch:
                return
            x = host_to_device(np.stack(batch), dev).to(torch.float32) / 255.0
            d = pipeline(x)
            if cfg.invert:
                d = 1.0 - d
            for frame in _quantize(d, cfg.bits).cpu().numpy():
                write(frame, top, bot)
            n += len(batch)
            batch.clear()
            if progress_cb:
                progress_cb(n, n / max(time.time() - t0, 1e-6))

        with torch.inference_mode():
            for f in _frames_cropped(rd, pending, top, h8, w8):
                batch.append(f)
                if len(batch) == cfg.batch_size:
                    flush()
                    if cancel_check and cancel_check():
                        break  # batch-boundary cancel poll
            flush()
    finally:
        rd.close()
        if wr is not None:
            wr.close()
        if cfg.track_letterbox:
            lb.save_sidecar(output_path, top, bot)
    return n


def _render_depth_crafter(input_path, output_path, cfg: DepthConfig, progress_cb=None,
                          pipeline=None, cancel_check=None, mesh_devs=None) -> int:
    """DepthCrafter: the clip strided to ``target_fps`` (the output's fps is
    the input's over the stride), cropped to multiples of 8, in segments of
    max(window, max_segment_frames) frames that share ``overlap`` frames;
    each segment's raw depth (``run_raw``) after the first is fitted to the
    previous segment's on the shared frames and cross-faded there. Pass 1
    spills the raw depth to a float16 sidecar and keeps its float32 min and
    max; pass 2 normalizes over the whole clip. ``cancel_check`` is polled
    at segment boundaries. With ``mesh_devs`` each segment's windows are
    denoised in parallel over those devices (``run_raw_parallel``: per-frame
    noise shared by the windows, instead of the serial re-seeding chain).
    Returns the frames written."""
    from ..depth.vda import _align_scale_shift

    dev = resolve_device(cfg.device)
    mesh = None
    if mesh_devs is not None:
        from ..parallel.mesh import make_mesh

        mesh = make_mesh(dp=len(mesh_devs), devices=mesh_devs)
    rd = open_video(input_path)
    top = bot = 0
    raw_path = str(output_path) + ".raw16.tmp"
    n_raw = 0
    try:
        stride = 1
        if rd.fps and rd.fps > cfg.target_fps:
            stride = max(1, int(round(rd.fps / cfg.target_fps)))
        out_fps = (rd.fps or 24.0) / stride
        pipeline, pending, top, bot = _video_route_setup(
            rd, cfg, dev, pipeline,
            lambda: load_predictor(cfg.model, cfg.checkpoint, dtype=cfg.dtype, device=dev,
                                   steps=cfg.steps, window=cfg.window_size,
                                   overlap=cfg.overlap, allow_random=cfg.allow_random))
        h8, w8 = ((rd.height - top - bot) // 8) * 8, (rd.width // 8) * 8
        frames = itertools.islice(_frames_cropped(rd, pending, top, h8, w8), 0, None, stride)
        ov = max(1, min(cfg.overlap, cfg.window_size - 1))
        seg_len = max(cfg.window_size, cfg.max_segment_frames)
        ramp = torch.from_numpy(np.linspace(0.0, 1.0, ov, endpoint=False, dtype=np.float32)
                                ).to(dev)[:, None, None]
        lo, hi = np.inf, -np.inf
        t0 = time.time()

        def write_raw(fh, d):
            nonlocal lo, hi, n_raw
            lo, hi = min(lo, float(d.min())), max(hi, float(d.max()))
            fh.write(d.to(torch.float16).cpu().numpy().tobytes())
            n_raw += d.shape[0]
            if progress_cb:
                progress_cb(n_raw, n_raw / max(time.time() - t0, 1e-6))

        tail, carry = None, []  # the held-back overlap: raw depth, source frames
        with open(raw_path, "wb") as fh, torch.inference_mode():
            while True:
                if cancel_check and cancel_check():
                    break  # segment-boundary cancel poll
                seg = carry + list(itertools.islice(frames, seg_len - len(carry)))
                new = len(seg) - len(carry)
                if new <= 0:
                    break
                x = host_to_device(np.stack(seg), dev).to(torch.float32) / 255.0
                d = pipeline.run_raw(x) if mesh is None else pipeline.run_raw_parallel(x, mesh=mesh)
                if tail is not None:
                    a, b = _align_scale_shift(d[:ov], tail)
                    d = (d * a + b).float()
                    write_raw(fh, tail * (1.0 - ramp) + d[:ov] * ramp)
                    d = d[ov:]
                if len(d) > ov and len(seg) == seg_len:
                    tail, carry = d[-ov:], seg[-ov:]
                    write_raw(fh, d[:-ov])
                else:  # the last (short) segment: nothing left to align against
                    tail, carry = None, []
                    write_raw(fh, d)
                    break
            if tail is not None:
                write_raw(fh, tail)
        rd.close()

        # pass 2: the whole-clip min-max normalization, streamed from the spill
        wr, write = _depth_writer(output_path, w8, h8 + top + bot, out_fps, cfg)
        scale = 1.0 / max(hi - lo, 1e-9)
        try:
            with open(raw_path, "rb") as fh, torch.inference_mode():
                for _ in range(n_raw):
                    d = np.frombuffer(fh.read(h8 * w8 * 2), np.float16).reshape(h8, w8)
                    d = host_to_device(d.copy(), dev).float()
                    d01 = torch.clamp((d - lo) * scale, 0.0, 1.0)
                    if cfg.invert:
                        d01 = 1.0 - d01
                    write(_quantize(d01, cfg.bits).cpu().numpy(), top, bot)
        finally:
            wr.close()
    finally:
        rd.close()
        if os.path.exists(raw_path):
            os.remove(raw_path)
        if cfg.track_letterbox:
            lb.save_sidecar(output_path, top, bot)
    return n_raw


def render_depth_video(args) -> int:
    """CLI adapter (``vd3d-torch depth``)."""
    cfg = DepthConfig(
        model=args.model, checkpoint=args.checkpoint, inference_size=args.inference_size,
        batch_size=args.batch_size, invert=args.invert, bits=args.bits, dtype=args.dtype,
        track_letterbox=args.track_letterbox, tiled=args.tiled, tile_size=args.tile_size, tile_overlap=args.tile_overlap,
        fast_head=not args.exact_head, mesh=args.mesh, device=args.device, steps=args.steps,
        window_size=args.window, overlap=args.overlap, target_fps=args.target_fps,
        allow_random=args.allow_random_weights)
    output = args.output
    if output is None:
        stem = str(args.input).rsplit(".", 1)[0]
        output = f"{stem}_depth." + ("vd16" if args.bits == 16 else "y4m")
    entry = CATALOG.get(cfg.model)
    if cfg.fast_head and entry is not None and entry.family in _FAST_HEAD_FAMILIES:
        print("note: fast DPT head active (~1.3% depth delta vs the reference op order); "
              "pass --exact-head for exact parity")

    def progress(n, fps):
        print(f"\r{n} frames | {fps:.2f} fps", end="", flush=True)

    cancel_check = None
    if getattr(args, "control", None):
        from ..utils.observability import make_control_check

        cancel_check = make_control_check(args.control)
    n = render_depth_video_file(args.input, output, cfg, progress, cancel_check=cancel_check)
    print(f"\nDepth video complete: {n} frames -> {output}")
    return 0
