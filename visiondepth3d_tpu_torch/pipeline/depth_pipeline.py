"""Depth estimation pipeline: 2D video -> grayscale depth video.

Counterpart of ``visiondepth3d_tpu/pipeline/depth_pipeline.py`` for the
feed-forward route on one device: batches of frames go to the device as
u8, are resized, normalized and run through the depth model (or, with
``tiled``, through Hann-blended model tiles), and every frame's depth is
normalized by its own percentiles and rounded to u8 or u16 on the device;
one readback per batch, whose writing on the host overlaps the next batch
on the device. The letterbox tracker crops black bars before inference and
the writer reinserts them with a neutral fill.

Not ported yet, and refused with NotImplementedError: the diffusion
(Marigold, DepthCrafter; ROADMAP Queue 1 item 9) and Video Depth Anything
(item 7) routes, and multi-device meshes.
"""

from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Callable

import numpy as np
import torch

from ..depth.registry import load_predictor
from ..device import host_to_device, resolve_device
from ..io import letterbox as lb
from ..io.depth_io import open_depth16_writer
from ..io.video import open_video, open_writer
from ..ops.resize import resize_bilinear
from ..ops.tiling import tiled_apply_batch

# the JAX catalog's models whose depth routes are not ported: (family, ROADMAP item)
_UNPORTED_ROUTES = {"marigold": ("diffusion", 9), "depthcrafter": ("diffusion", 9),
                    "video-depth-anything": ("vda", 7)}


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
    # one device: "auto" and "off" run on it; anything else raises
    mesh: str | None = "auto"
    device: str = "cuda"


def _size_h(size) -> int:
    return int(size[0]) if isinstance(size, (tuple, list)) else int(size)


def _check_ported(cfg: DepthConfig):
    if cfg.model in _UNPORTED_ROUTES:
        family, item = _UNPORTED_ROUTES[cfg.model]
        raise NotImplementedError(f"{cfg.model}: the {family} depth route is not ported yet "
                                  f"(ROADMAP Queue 1 item {item})")
    if cfg.mesh not in (None, "auto", "off"):
        raise NotImplementedError(f"mesh {cfg.mesh!r}: the port's depth route runs on one "
                                  f"device ('auto' or 'off')")
    if cfg.bits not in (8, 16):
        raise ValueError(f"bits {cfg.bits} not in (8, 16)")


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
        d = resize_bilinear(d, tuple(out_hw), channel_last=False)
        # per-frame percentile normalization (linear, as jnp.percentile)
        q = torch.tensor([cfg.percentile_lo / 100.0, cfg.percentile_hi / 100.0],
                         dtype=d.dtype, device=d.device)
        lo, hi = torch.quantile(d.flatten(1), q, dim=1)[..., None, None]
        d01 = torch.clamp((d - lo) / torch.clamp(hi - lo, min=1e-9), 0.0, 1.0)
        if cfg.invert:
            d01 = 1.0 - d01
        if cfg.bits == 16:
            return torch.clamp(d01 * 65535.0 + 0.5, 0, 65535).to(torch.int32)
        return torch.clamp(d01 * 255.0 + 0.5, 0, 255).to(torch.uint8)

    return fn


def render_depth_video_file(input_path, output_path, cfg: DepthConfig | None = None,
                            progress_cb: Callable | None = None, predictor=None,
                            cancel_check: Callable | None = None) -> int:
    """Estimate the depth of every frame; returns the frame count.
    ``cancel_check`` is polled between batches."""
    cfg = cfg or DepthConfig()
    _check_ported(cfg)
    dev = resolve_device(cfg.device)
    rd = open_video(input_path)
    wr = None
    segments: list = []  # (first frame, top, bottom) per letterbox crop
    try:
        if cfg.inference_size is None:
            cfg = dataclasses.replace(cfg, inference_size=(rd.height, rd.width))
        if predictor is None:
            if cfg.checkpoint is None:
                warnings.warn(f"{cfg.model}: no checkpoint given, running RANDOM weights - "
                              f"output is not real depth (shape and speed testing only)")
            predictor = load_predictor(cfg.model, cfg.checkpoint,
                                       cfg.tile_size if cfg.tiled else cfg.inference_size,
                                       dtype=cfg.dtype, device=dev, fast_head=cfg.fast_head)
        elif predictor.device != dev:
            raise ValueError(f"predictor is on {predictor.device}, the route on {dev}")

        # letterbox: bootstrap on up to 9 probe frames, then the tracker runs
        # on every frame; a confirmed bar change closes the batch
        pending_frames: list = []
        tracker = None
        top = bot = 0
        if cfg.track_letterbox:
            for _ in range(9):
                f = rd.read()
                if f is None:
                    break
                pending_frames.append(f)
            tracker = lb.LetterboxTracker(rd.height, rd.fps)
            top, bot, _ = tracker.bootstrap(pending_frames)
            segments = [(0, top, bot)]

        fns: dict = {}

        def get_fn(ch):
            if ch not in fns:
                fns[ch] = make_depth_batch_fn(predictor, cfg, (ch, rd.width))
            return fns[ch]

        if cfg.bits == 16:
            wr = open_depth16_writer(output_path, rd.width, rd.height, rd.fps)

            def write(d, t, b):
                wr.write(lb.reinsert_bars(d.astype(np.uint16), t, b, fill=32768))
        else:
            wr = open_writer(output_path, rd.width, rd.height, rd.fps, cfg.codec)

            def write(d, t, b):
                g = lb.reinsert_bars(d, t, b, fill=128)
                wr.write(np.repeat(g[..., None], 3, axis=-1))

        n_done = 0
        t0 = time.time()
        batch: list = []
        batch_bars = (top, bot)
        pending = None  # (host tensor, frames, bars, event): written while the next batch runs

        def drain():
            if pending is None:
                return
            host, n, bars, event = pending
            if event is not None:
                event.synchronize()
            arr = host.numpy()
            for i in range(n):
                write(arr[i], *bars)

        def flush():
            nonlocal n_done, pending
            if not batch:
                return
            out = get_fn(batch[0].shape[0])(host_to_device(np.stack(batch), dev))
            host = torch.empty(out.shape, dtype=out.dtype, pin_memory=dev.type == "cuda")
            host.copy_(out, non_blocking=dev.type == "cuda")
            event = None
            if dev.type == "cuda":
                event = torch.cuda.Event()
                event.record()
            drain()
            pending = (host, len(batch), batch_bars, event)
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


def render_depth_video(args) -> int:
    """CLI adapter (``vd3d-torch depth``)."""
    cfg = DepthConfig(
        model=args.model, checkpoint=args.checkpoint, inference_size=args.inference_size,
        batch_size=args.batch_size, invert=args.invert, bits=args.bits, dtype=args.dtype,
        track_letterbox=args.track_letterbox, tiled=args.tiled, tile_size=args.tile_size, tile_overlap=args.tile_overlap,
        fast_head=not args.exact_head, mesh=args.mesh, device=args.device)
    output = args.output
    if output is None:
        stem = str(args.input).rsplit(".", 1)[0]
        output = f"{stem}_depth." + ("vd16" if args.bits == 16 else "y4m")
    if cfg.fast_head:
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
