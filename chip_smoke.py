#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase; needs one CUDA card

Phases, each printed on its own line; any failure exits nonzero:
  1. the card (nvidia-smi name and power limit), torch / CUDA / nvcc versions;
  2. build the hand-written kernels from visiondepth3d_tpu_torch/kernels/csrc;
  3. each kernel against its plain PyTorch version on the card, with
     CUDA-event times of both, of the library call where one computes the
     same function, and the kernel's bound: K1-K4 at the shapes of the 1080p
     render (1080x1920 frames, 648x1152 subject crop), K5 (the 3x3 conv) in
     f32 and bf16 at five shapes of the frame-tools path;
  4. the render path: a synthetic 1920x1080 y4m clip of 64 frames through
     render_stereo_video with the benchmark configuration (Depth Anything
     V2-Small, random weights from a seed, 518^2, bf16, fast head; healing
     on, bf16 image plane; Full-SBS 1080p; chunks of 16), three timed runs
     with every kernel launch counted, then one run and each layer of one
     chunk under torch.profiler for the card's own time and busy share;
  5. the frame-tools path: a synthetic 960x540 y4m clip of 9 frames through
     run_merged_pipeline with Real-ESRGAN x4plus and practical-RIFE v4.x at
     full width (random weights from a seed), bf16, chunks of 4, two timed
     runs with K5's launches counted, then one run and each layer of one
     chunk under torch.profiler;
  6. kernels against plain versions over whole paths: a 256x144 render and a
     128x72 frame-tools run on the CPU (plain versions) and on the card;
  7. the CLI once per subcommand: python -m visiondepth3d_tpu_torch render /
     tools ...

The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}. Imports nothing of JAX and
nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PKG = ROOT / "visiondepth3d_tpu_torch"

# kernel name -> (source, TPU kernel it replaces)
KERNEL_TABLE = {
    "stereo_warp": ("visiondepth3d_tpu_torch/kernels/csrc/warp.cu",
                    "visiondepth3d_tpu/ops/pallas_warp.py:28"),
    "feather_heal": ("visiondepth3d_tpu_torch/kernels/csrc/postfx.cu",
                     "visiondepth3d_tpu/ops/pallas_postfx.py:60"),
    "quantile_pair": ("visiondepth3d_tpu_torch/kernels/csrc/stats.cu",
                      "visiondepth3d_tpu/ops/pallas_stats.py:44"),
    "subject_stats": ("visiondepth3d_tpu_torch/kernels/csrc/stats.cu",
                      "visiondepth3d_tpu/ops/pallas_stats.py:90"),
    "conv3x3": ("visiondepth3d_tpu_torch/kernels/csrc/conv.cu",
                "visiondepth3d_tpu/ops/pallas_conv.py:44"),
}
# the kernels of each main path: the render's four, the frame tools' conv
RENDER_KERNELS = ("stereo_warp", "feather_heal", "quantile_pair", "subject_stats")
TOOLS_KERNELS = ("conv3x3",)
H, W = 1080, 1920

# H100 SXM peaks (NVIDIA data sheet; at the 700 W power limit): HBM bytes/s,
# dense bf16 tensor-core and float32 CUDA-core FLOP/s
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}


class PhaseError(RuntimeError):
    pass


def say(*parts):
    print(*parts, flush=True)


def expect(cond: bool, what: str):
    if not cond:
        raise PhaseError(what)


def card_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    expect(res.returncode == 0, f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


HAND_KERNELS = ("stereo_warp_kernel", "feather_heal_kernel", "hist_kernel",
                "qpair_replay_kernel", "subject_replay_kernel", "conv3x3_wmma_kernel",
                "conv3x3_fma_kernel")


def bound(flops: float, nbytes: float, dtype: str) -> tuple[float, str]:
    """The least time (ms) the card could take: the larger of the bytes over
    the memory rate and the operations over the peak rate of their type."""
    t_bytes = nbytes / PEAK_BYTES
    t_ops = flops / PEAK_FLOPS[dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def device_profile(fn) -> dict | None:
    """Run fn() once under torch.profiler and read the card's own time.

    Returns, in ms, the summed duration of every device event (kernels,
    memsets, copies), the part spent in this package's hand-written kernels,
    and the union of the device intervals (the time the card was busy);
    None when the trace holds no device event. The profiler slows the host
    but not the device, so the busy share is the union over the wall time of
    the same call made without the profiler.
    """
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ivs = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                 if e.device_type == DeviceType.CUDA)
    if not ivs:
        return None
    busy, cur_s, cur_e = 0.0, ivs[0][0], ivs[0][1]
    for s, e, _ in ivs[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s = s
        cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    return {"device_ms": sum(e - s for s, e, _ in ivs) / 1e3,
            "hand_ms": sum(e - s for s, e, n in ivs if any(k in n for k in HAND_KERNELS)) / 1e3,
            "events": len(ivs), "busy_ms": busy / 1e3}


def fmt_profile(p: dict | None, wall_ms: float) -> str:
    """The profile beside the unprofiled wall time of the same call."""
    if p is None:
        return (f"wall {wall_ms:.3f} ms; device time not measured "
                f"(the profiler saw no device event)")
    return (f"device {p['device_ms']:.3f} ms in {p['events']} events "
            f"(hand kernels {p['hand_ms']:.3f} ms), busy {p['busy_ms']:.3f} ms of "
            f"{wall_ms:.3f} ms wall = {100 * p['busy_ms'] / wall_ms:.1f} % busy")


def time_ms(fn, warmup: int = 3, runs: int = 21) -> float:
    """Median CUDA-event time of fn() over `runs` launches, after a warm-up."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# ---------------------------------------------------------------- inputs


def smooth_depth(gen, h, w, device, edges=True):
    """A depth-like [h, w] map in [0, 1]: smooth waves, optional step edges."""
    import torch

    yy = torch.linspace(0, 1, h)[:, None]
    xx = torch.linspace(0, 1, w)[None, :]
    phase = torch.rand(2, generator=gen) * 6.28
    d = 0.5 + 0.3 * torch.sin(xx * 11 + phase[0]) * torch.cos(yy * 7 + phase[1])
    d = d + 0.15 * (xx - 0.5)
    if edges:
        d = d + 0.2 * ((xx > 0.3) & (xx < 0.55) & (yy > 0.2) & (yy < 0.7)).float()
    d = d + 0.01 * torch.rand(h, w, generator=gen)
    return d.clamp(0, 1).to(device)


def smooth_frame(gen, h, w, device):
    import torch

    yy = torch.linspace(0, 1, h)[:, None, None]
    xx = torch.linspace(0, 1, w)[None, :, None]
    ch = torch.arange(3)[None, None, :]
    f = 0.5 + 0.4 * torch.sin(xx * (13 + 5 * ch) + yy * (7 + 3 * ch))
    f = f + 0.05 * torch.rand(h, w, 3, generator=gen)
    return f.clamp(0, 1).to(device)


# ---------------------------------------------------------------- phases


def phase_card():
    import torch

    line = card_line()
    say(f"PHASE card: {line}")
    from visiondepth3d_tpu_torch.kernels._lib import find_nvcc

    nvcc = subprocess.run([find_nvcc(), "--version"], capture_output=True, text=True)
    say(f"PHASE versions: python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} nvcc '{nvcc.stdout.strip().splitlines()[-1]}'")
    return line


def phase_build():
    from visiondepth3d_tpu_torch.kernels import _lib

    t0 = time.perf_counter()
    path = _lib.build_library()
    _lib.lib()
    dt = time.perf_counter() - t0
    regs = [ln.strip() for ln in _lib.build_log.splitlines() if "registers" in ln]
    say(f"PHASE build: {path.name} in {dt:.1f} s")
    for ln in regs:
        say(f"  ptxas: {ln}")


def phase_kernels(card: str) -> dict:
    """Each kernel against its plain version: K1-K4 at the 1080p render's
    shapes, K5 at five shapes of the frame-tools path. Returns, per kernel
    and type, its error, times (kernel, plain, library) and bound."""
    import torch

    from visiondepth3d_tpu_torch.kernels import postfx, stats, warp

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    results = {}

    def record(name, dt, err, ms, plain, flops, nbytes, library_ms=None):
        tname = "bfloat16" if dt == torch.bfloat16 else "float32"
        bound_ms, bound_by = bound(flops, nbytes, tname)
        results[(name, dt)] = dict(err=err, ms=ms, plain=plain, bound_ms=bound_ms,
                                   bound_by=bound_by, library_ms=library_ms)
        return (f"kernel {ms:.4f} ms plain {plain:.4f} ms bound {bound_ms:.4f} ms "
                f"({bound_by}) library "
                f"{'none' if library_ms is None else f'{library_ms:.4f} ms'} [{card}]")

    # K1: the dual-eye warp, f32 and bf16. |shift| <= 0.042 grid units is
    # 40.3 px, inside the render's disparity bound ceil(0.02 * 1920) + 2 = 41
    # px (the plain shifted accumulation sums only that many taps); columns
    # near both borders sample past the edge and exercise the clamp.
    # Bound: read frame (3), depth, shift (f32), write 2 x (3 + 1) values;
    # 38 operations per pixel (shift scale, then per eye the clamped source
    # column, its floor and weights, and 2 multiplies + 1 add per value).
    frame = smooth_frame(gen, H, W, dev)
    depth = smooth_depth(gen, H, W, dev)
    shift = ((torch.rand(H, W, generator=gen) * 2 - 1) * 0.042).to(dev)
    max_shift = 41
    for dt, tol in ((torch.float32, 1e-5), (torch.bfloat16, 8e-3)):
        f, d = frame.to(dt), depth.to(dt)
        got = warp.stereo_warp_cuda(f, d, shift, max_shift)
        ref = warp.stereo_warp_torch(f, d, shift, max_shift)
        err = max((a.float() - b.float()).abs().max().item() for a, b in zip(got, ref))
        ms = time_ms(lambda: warp.stereo_warp_cuda(f, d, shift, max_shift))
        plain = time_ms(lambda: warp.stereo_warp_torch(f, d, shift, max_shift))
        s = f.element_size()
        line = record("stereo_warp", dt, err, ms, plain, 38 * H * W, H * W * (12 * s + 4))
        say(f"PHASE kernels stereo_warp {dt} max_abs_err={err:.3e} (tol {tol}) {line}")
        expect(err <= tol, f"stereo_warp {dt}: max |err| {err} > {tol}")

    # K2: feather + heal, f32 and bf16. Bound: read both eyes, the frame
    # (3 each) and both depths, write both eyes; 376 operations per pixel at
    # blur_ksize 9 (per eye: depth gradient 6, mask 2, 9x9 box 82, lerp 9,
    # gray 5, gray gradient 6, threshold 1, 5x5 box 26, heal blend 12,
    # 3x3 soften 30, its blend 9)
    base = smooth_frame(gen, H, W, dev)
    left = (base + 0.05 * torch.randn(H, W, 3, generator=gen).to(dev)).clamp(0, 1)
    right = (base - 0.05 * torch.randn(H, W, 3, generator=gen).to(dev)).clamp(0, 1)
    dl, dr = depth, torch.roll(depth, 7, dims=1)
    kw = dict(blur_ksize=9, feather_strength=10.0, heal_strength=0.5)
    for dt in (torch.float32, torch.bfloat16):
        args = [t.to(dt) for t in (left, right, frame, dl, dr)]
        got = postfx.feather_heal_cuda(*args, **kw)
        ref = postfx.feather_heal_torch(*args, **kw)
        diff = torch.cat([(a.float() - b.float()).abs().reshape(-1) for a, b in zip(got, ref)])
        err = diff.max().item()
        ms = time_ms(lambda: postfx.feather_heal_cuda(*args, **kw))
        plain = time_ms(lambda: postfx.feather_heal_torch(*args, **kw))
        line = record("feather_heal", dt, err, ms, plain, 376 * H * W,
                      H * W * 17 * args[0].element_size())
        if dt == torch.float32:
            within = (diff <= 1e-4).float().mean().item()
            say(f"PHASE kernels feather_heal {dt} max_abs_err={err:.3e} "
                f"within_1e-4={within:.6f} (need >= 0.9999) {line}")
            expect(within >= 0.9999, f"feather_heal f32: {within} within 1e-4")
        else:
            mean = diff.mean().item()
            say(f"PHASE kernels feather_heal {dt} max_abs_err={err:.3e} "
                f"mean_abs_err={mean:.3e} (need <= 2e-3) {line}")
            expect(mean <= 2e-3, f"feather_heal bf16: mean |err| {mean}")

    # K3: the quantile pair, bit-exact, on a depth map and a constant map.
    # Bound: one read of the map; 12 bisection steps of a compare and a
    # count per pixel (24 operations).
    for name, x, qs in (("depth", depth, (0.02, 0.98)), ("stretch", depth, (0.05, 0.95)),
                        ("constant", torch.full((H, W), 0.37, device=dev), (0.02, 0.98))):
        got = stats.quantile_pair_cuda(x, *qs)
        ref = stats.quantile_pair_torch(x, *qs)
        expect(torch.equal(got, ref), f"quantile_pair {name}: {got.tolist()} != {ref.tolist()}")
    ms = time_ms(lambda: stats.quantile_pair_cuda(depth, 0.02, 0.98))
    plain = time_ms(lambda: stats.quantile_pair_torch(depth, 0.02, 0.98))
    line = record("quantile_pair", torch.float32, 0.0, ms, plain, 24 * H * W, 4 * H * W + 8)
    say(f"PHASE kernels quantile_pair bit-exact on 3 maps, max_abs_err=0 {line}")

    # K4: subject statistics on the 60 % center crop (a strided view).
    # Bound: one read of the crop; 42 operations per pixel (valid band 3,
    # 64-bin index 3, 12 bisection steps of 3).
    for name, m in (("depth", depth), ("constant", torch.full((H, W), 0.37, device=dev)),
                    ("empty", torch.full((H, W), 0.01, device=dev))):
        crop = m[H // 5: H * 4 // 5, W // 5: W * 4 // 5]
        expect(tuple(crop.shape) == (648, 1152), f"crop shape {tuple(crop.shape)}")
        got = stats.subject_stats_cuda(crop)
        ref = stats.subject_stats_torch(crop)
        for a, b, part in zip(got, ref, ("hist", "count", "median")):
            expect(torch.equal(a, b), f"subject_stats {name} {part}: {a} != {b}")
    crop = depth[H // 5: H * 4 // 5, W // 5: W * 4 // 5]
    ms = time_ms(lambda: stats.subject_stats_cuda(crop))
    plain = time_ms(lambda: stats.subject_stats_torch(crop))
    line = record("subject_stats", torch.float32, 0.0, ms, plain, 42 * crop.numel(),
                  4 * crop.numel() + 4 * 66)
    say(f"PHASE kernels subject_stats bit-exact on 3 crops, max_abs_err=0 {line}")
    del frame, depth, shift, base, left, right, dl, dr, args, got, ref, diff
    phase_conv_kernel(card, results)
    return results


# K5 at the shapes of the frame-tools path (960x540 input, chunks of 5
# frames): name, input [B, H, W, C], O, activation
CONV_SHAPES = (("rdb_conv1", (5, 540, 960, 64), 32, "lrelu"),
               ("rdb_conv5", (5, 540, 960, 192), 64, None),
               ("conv_first", (5, 540, 960, 3), 64, None),
               ("conv_last_tail", (5, 1096, 1936, 64), 3, None),
               ("rife_res", (4, 135, 240, 64), 64, None))


def phase_conv_kernel(card: str, results: dict):
    """K5 against its plain version, f32 (TF32 off) and bf16, at the five
    shapes; the library yardstick is one cuDNN F.conv2d (channels_last, with
    bias; the activation is not in it). The JSON line carries the sums over
    the five shapes."""
    import torch
    import torch.nn.functional as F

    from visiondepth3d_tpu_torch.kernels import conv

    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(5)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        for dt, tname in ((torch.float32, "float32"), (torch.bfloat16, "bfloat16")):
            tot = dict(err=0.0, ms=0.0, plain=0.0, library=0.0, flops=0.0, bytes=0.0)
            for name, shape, o, act in CONV_SHAPES:
                c = shape[-1]
                x = torch.randn(shape, generator=gen, device=dev).to(dt)
                w = torch.randn(3, 3, c, o, generator=gen, device=dev) / (9 * c) ** 0.5
                b = 0.1 * torch.randn(o, generator=gen, device=dev)
                packed = conv.pack_conv3x3(w, b, dt)
                got = conv.conv3x3_cuda(x, w, b, act, packed=packed)
                ref = conv.conv3x3_torch(x, w, b, act)
                torch.cuda.synchronize()
                diff = (got.float() - ref.float()).abs()
                scale = ref.float().abs().max().item()
                err, mean = diff.max().item(), diff.mean().item()
                del got, ref, diff
                ms = time_ms(lambda: conv.conv3x3_cuda(x, w, b, act, packed=packed),
                             warmup=2, runs=7)
                plain = time_ms(lambda: conv.conv3x3_torch(x, w, b, act), warmup=1, runs=3)
                xc = x.permute(0, 3, 1, 2)  # NCHW view of NHWC memory: channels_last
                wc = w.to(dt).permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
                bc = b.to(dt)
                library = time_ms(lambda: F.conv2d(xc, wc, bc, padding=1), warmup=2, runs=7)
                n_px = shape[0] * shape[1] * shape[2]
                flops = 2.0 * n_px * 9 * c * o
                nbytes = (n_px * (c + o) + 9 * c * o + o) * x.element_size()
                bound_ms, bound_by = bound(flops, nbytes, tname)
                if dt == torch.float32:
                    ok = err <= 1e-4 * scale
                    gate = f"need max <= 1e-4 * {scale:.3f}"
                else:
                    ok = err <= 8e-3 * scale and mean <= 1e-3 * scale
                    gate = f"need max <= 8e-3 and mean <= 1e-3 of {scale:.3f}"
                say(f"PHASE kernels conv3x3 {name} {list(shape)}->{o} {act} {dt} "
                    f"max_abs_err={err:.3e} mean_abs_err={mean:.3e} ({gate}) kernel {ms:.4f} ms "
                    f"plain {plain:.4f} ms library {library:.4f} ms bound {bound_ms:.4f} ms "
                    f"({bound_by}; {flops / ms / 1e9:.1f} TFLOP/s) [{card}]")
                expect(ok, f"conv3x3 {name} {dt}: max |err| {err}, mean {mean}, max |ref| {scale}")
                for k, v in (("err", err), ("ms", ms), ("plain", plain), ("library", library),
                             ("flops", flops), ("bytes", nbytes)):
                    tot[k] = max(tot[k], v) if k == "err" else tot[k] + v
                del x, w, b, packed, xc, wc, bc
                torch.cuda.empty_cache()
            bound_ms, bound_by = bound(tot["flops"], tot["bytes"], tname)
            results[("conv3x3", dt)] = dict(err=tot["err"], ms=tot["ms"], plain=tot["plain"],
                                            bound_ms=bound_ms, bound_by=bound_by,
                                            library_ms=tot["library"])
            say(f"PHASE kernels conv3x3 {dt} five shapes: kernel {tot['ms']:.4f} ms plain "
                f"{tot['plain']:.4f} ms library {tot['library']:.4f} ms bound {bound_ms:.4f} ms "
                f"({bound_by}) [{card}]")
    finally:
        torch.backends.cudnn.allow_tf32 = tf32


def write_clip(path, w, h, n, fps=24.0):
    import numpy as np

    from visiondepth3d_tpu_torch.io import Y4MWriter

    yy, xx = np.mgrid[0:h, 0:w]
    with Y4MWriter(str(path), w, h, fps) as wr:
        for i in range(n):
            f = np.empty((h, w, 3), np.uint8)
            f[..., 0] = (xx * 255 // max(w - 1, 1) + 4 * i) % 256
            f[..., 1] = yy * 255 // max(h - 1, 1)
            f[..., 2] = 100
            x0 = w // 8 + (w // 64) * i % (w // 2)
            f[h // 4: h // 2, x0: x0 + w // 6] = (240, 50, 50)
            wr.write(f)


def read_clip(path):
    import numpy as np

    from visiondepth3d_tpu_torch.io import Y4MReader

    with Y4MReader(str(path)) as rd:
        frames = list(rd)
        return rd.width, rd.height, np.stack(frames) if frames else None


def phase_render(card: str, tmp: Path) -> dict:
    """The benchmark configuration through render_stereo_video."""
    import torch

    from visiondepth3d_tpu_torch.depth.registry import load_predictor
    from visiondepth3d_tpu_torch.kernels import launch_counts, reset_launch_counts
    from visiondepth3d_tpu_torch.pipeline.geometry import resolve_geometry
    from visiondepth3d_tpu_torch.pipeline.stereo_pipeline import (
        RenderConfig, make_chunk_fn, render_stereo_video)
    from visiondepth3d_tpu_torch.state.trackers import init_trackers
    from visiondepth3d_tpu_torch.stereo.params import StereoParams
    from visiondepth3d_tpu_torch.stereo.step import render_chunk

    dev = torch.device("cuda")
    pred = load_predictor("depth-anything-v2-small", None, inference_size=518, seed=0,
                          dtype="bfloat16", device=dev, fast_head=True)
    params = StereoParams(enable_healing=True, image_dtype="bfloat16")
    cfg = RenderConfig(output_format="Full-SBS", output_height=1080, chunk_size=16,
                       device="cuda")
    n_frames, reps = 64, 3
    warm_clip, clip = tmp / "warm_1080p.y4m", tmp / "clip_1080p.y4m"
    write_clip(warm_clip, W, H, 16)
    write_clip(clip, W, H, n_frames)
    render_stereo_video(warm_clip, None, tmp / "warm_sbs.y4m", params, cfg, predictor=pred)
    torch.cuda.synchronize()

    # the main path, timed `reps` times; the counts are zeroed before each run
    # and read right after it, and every run must launch the same kernels
    torch.cuda.reset_peak_memory_stats()
    fps, counts = [], None
    for _ in range(reps):
        reset_launch_counts()
        t0 = time.perf_counter()
        prog = render_stereo_video(clip, None, tmp / "clip_sbs.y4m", params, cfg,
                                   predictor=pred)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        run_counts = dict(launch_counts)
        expect(counts is None or run_counts == counts,
               f"launch counts differ between runs: {counts} then {run_counts}")
        counts = run_counts
        fps.append(n_frames / wall)
    peak = torch.cuda.max_memory_allocated()
    ow, oh, out = read_clip(tmp / "clip_sbs.y4m")
    expect((ow, oh) == (2 * W, H), f"output is {ow}x{oh}, want {2 * W}x{H}")
    expect(out is not None and out.shape[0] == n_frames,
           f"output has {0 if out is None else out.shape[0]} frames, want {n_frames}")
    halves = float(abs(out[:, :, :W].astype(int) - out[:, :, W:].astype(int)).mean())
    expect(halves > 0.1, f"left and right halves are identical (mean |L-R| {halves})")
    for k in RENDER_KERNELS:
        expect(counts[k] > 0, f"kernel {k} was not launched on the render path")
    say(f"PHASE render: {n_frames} frames 1920x1080 -> {ow}x{oh} Full-SBS, {reps} runs: "
        f"{', '.join(f'{f:.2f}' for f in fps)} fps end to end (median "
        f"{statistics.median(fps):.2f}; frames_done={prog.frames_done}), "
        f"mean |L-R| {halves:.2f}, peak allocated {peak / 2**30:.3f} GiB [{card}]")
    say(f"PHASE render launches: {json.dumps(counts)}")
    prof = device_profile(lambda: render_stereo_video(clip, None, tmp / "prof_sbs.y4m",
                                                      params, cfg, predictor=pred))
    say(f"PHASE render profile ({n_frames} frames, one more run under torch.profiler, "
        f"against the median run's wall): "
        f"{fmt_profile(prof, 1e3 * n_frames / statistics.median(fps))} [{card}]")

    # the layers of one 16-frame chunk on device-resident input: the card's
    # own time from the profiler, against the host-gated wall span (CUDA
    # events around the launches, so it holds the card's idle time while the
    # host is still launching)
    geom = resolve_geometry(W, H, "Full-SBS", 1080)
    chunk_fn = make_chunk_fn(params, geom, cfg, predictor=pred, yuv_in=False)
    frames_u8 = (torch.rand(16, H, W, 3, generator=torch.Generator().manual_seed(1))
                 * 255).to(torch.uint8).to(dev)
    frames = frames_u8.float() / 255.0
    trackers = init_trackers(H, W, dev)
    run_params = params.replace(warp_hw=(H, W)).with_shift_bound(W)
    depths = pred.predict_01(frames, out_hw=(H, W))
    layers = {
        "chunk": lambda: chunk_fn(trackers, frames_u8),
        "depth model": lambda: pred.predict_01(frames, out_hw=(H, W)),
        "stereo step": lambda: render_chunk(run_params, trackers, frames, depths),
    }
    for name, fn in layers.items():
        span = time_ms(fn, warmup=2, runs=5)
        say(f"PHASE layers {name} (16-frame chunk, wall = host-gated span, median of 5): "
            f"{fmt_profile(device_profile(fn), span)} [{card}]")
    _, outs = render_chunk(run_params, trackers, frames, depths)
    finite = bool(torch.isfinite(outs.left.float()).all() and
                  torch.isfinite(outs.right.float()).all())
    expect(finite, "non-finite pixels in the stereo output")
    say("PHASE layers: stereo outputs finite")
    return counts


def ssim_gray(a, b) -> float:
    """Mean SSIM of two u8 RGB frames on their luma (7x7 box windows)."""
    import numpy as np

    def box(x, k=7):
        c = np.cumsum(np.cumsum(np.pad(x, ((1, 0), (1, 0))), 0), 1)
        return (c[k:, k:] - c[:-k, k:] - c[k:, :-k] + c[:-k, :-k]) / (k * k)

    wts = np.array([0.299, 0.587, 0.114])
    x = (a.astype(np.float64) @ wts)
    y = (b.astype(np.float64) @ wts)
    c1, c2 = (0.01 * 255) ** 2, (0.03 * 255) ** 2
    mx, my = box(x), box(y)
    vx, vy = box(x * x) - mx * mx, box(y * y) - my * my
    cxy = box(x * y) - mx * my
    s = ((2 * mx * my + c1) * (2 * cxy + c2)) / ((mx * mx + my * my + c1) * (vx + vy + c2))
    return float(s.mean())


def phase_parity(card: str, tmp: Path):
    """The same small render on the CPU (plain versions) and on the card."""
    import numpy as np
    import torch

    from visiondepth3d_tpu_torch.depth.registry import load_predictor
    from visiondepth3d_tpu_torch.kernels import launch_counts, reset_launch_counts
    from visiondepth3d_tpu_torch.pipeline.stereo_pipeline import (
        RenderConfig, render_stereo_video)
    from visiondepth3d_tpu_torch.stereo.params import StereoParams

    # float32 depth model on both sides, TF32 off: the comparison is about
    # the stereo kernels, not about matmul rounding in the random ViT
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    clip = tmp / "small.y4m"
    write_clip(clip, 256, 144, 4)
    params = StereoParams(enable_healing=True, image_dtype="bfloat16")
    outs = {}
    for device in ("cpu", "cuda"):
        pred = load_predictor("depth-anything-v2-small", None, inference_size=518, seed=0,
                              dtype="float32", device=device, fast_head=True)
        cfg = RenderConfig(preserve_original_aspect=True, chunk_size=4, device=device)
        reset_launch_counts()
        render_stereo_video(clip, None, tmp / f"small_{device}.y4m", params, cfg,
                            predictor=pred)
        if device == "cuda":
            torch.cuda.synchronize()
            expect(all(launch_counts[k] > 0 for k in RENDER_KERNELS),
                   f"card render skipped a kernel: {launch_counts}")
        else:
            expect(not any(launch_counts.values()), "CPU render launched a kernel")
        outs[device] = read_clip(tmp / f"small_{device}.y4m")[2]
    a, b = outs["cpu"], outs["cuda"]
    expect(a.shape == b.shape == (4, 144, 512, 3), f"shapes {a.shape} {b.shape}")
    mean = float(np.abs(a.astype(int) - b.astype(int)).mean())
    ssim = min(ssim_gray(x, y) for x, y in zip(a, b))
    say(f"PHASE parity: 256x144 x4 frames, CPU plain vs card kernels: "
        f"mean |d| {mean:.4f} u8 (need <= 1), min SSIM {ssim:.5f} (need >= 0.99)")
    expect(mean <= 1.0 and ssim >= 0.99, "CPU and card renders disagree")


TOOLS_W, TOOLS_H, TOOLS_FRAMES, TOOLS_CHUNK = 960, 540, 9, 4


def tools_models(dtype: str, seed: int = 0):
    """Full-width random weights from a seed: Real-ESRGAN x4plus geometry
    (nf 64, nb 23, gc 32, x4, two up-convs, unshuffle style) and
    practical-RIFE v4.x (IFNetConfig(): widths 192/128/96/64 at scales
    8/4/2/1, 8 residual convs per block), the latter as the (state dict,
    IFNetConfig) pair the CLI passes."""
    import torch

    from visiondepth3d_tpu_torch.enhance.pipeline import (EnhanceConfig, init_enhance_params,
                                                          init_random_)
    from visiondepth3d_tpu_torch.enhance.rife import IFNetConfig

    cfg = EnhanceConfig(use_esrgan=True, use_rife=True, fps_multiplier=2,
                        chunk_size=TOOLS_CHUNK, keep_original_size=True, dtype=dtype,
                        allow_random_weights=True)
    ep, _ = init_enhance_params(dataclasses.replace(cfg, use_rife=False), seed)
    rcfg = IFNetConfig()
    rife = init_random_(rcfg.build(), torch.Generator().manual_seed(seed + 1))
    return cfg, ep, (rife.state_dict(), rcfg)


def phase_tools(card: str, tmp: Path) -> dict:
    """The frame-tools path: ESRGAN x4 + RIFE x2 at full width, bf16, over a
    960x540 clip, through run_merged_pipeline; K5 launches counted on every
    run; the card's time per layer of one chunk from torch.profiler."""
    import torch

    from visiondepth3d_tpu_torch.enhance.esrgan import staged_tail
    from visiondepth3d_tpu_torch.enhance.pipeline import (_tile_len, make_enhance_fn,
                                                          run_merged_pipeline)
    from visiondepth3d_tpu_torch.kernels import launch_counts, reset_launch_counts

    dev = torch.device("cuda")
    cfg, ep, rp = tools_models("bfloat16")
    clip = tmp / "tools_540p.y4m"
    write_clip(clip, TOOLS_W, TOOLS_H, TOOLS_FRAMES)
    n_out = (TOOLS_FRAMES - 1) * 2 + 1
    chunks = -(-(TOOLS_FRAMES - 1) // TOOLS_CHUNK)
    # per chunk of 5 frames (5 x 540 x 960 trunk pixels > 2^21: the staged
    # route): 1 + 23 x 15 + 1 trunk convs, 4 tiles x 4 tail convs, 4 RIFE
    # blocks x 8 residual convs
    tiles = (TOOLS_H // _tile_len(TOOLS_H)) * (TOOLS_W // _tile_len(TOOLS_W))
    want_k5 = chunks * (2 + 23 * 15 + 4 * tiles + 4 * 8)
    run_merged_pipeline(clip, tmp / "tools_warm.y4m", cfg, ep, rp, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    walls, counts = [], None
    for _ in range(2):
        reset_launch_counts()
        t0 = time.perf_counter()
        n = run_merged_pipeline(clip, tmp / "tools_out.y4m", cfg, ep, rp, device=dev)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        run_counts = dict(launch_counts)
        expect(counts is None or run_counts == counts,
               f"launch counts differ between runs: {counts} then {run_counts}")
        counts = run_counts
    peak = torch.cuda.max_memory_allocated()
    expect(n == n_out, f"tools wrote {n} frames, want {n_out}")
    expect(counts["conv3x3"] == want_k5,
           f"K5 launched {counts['conv3x3']} times per run, want {want_k5}")
    ow, oh, out = read_clip(tmp / "tools_out.y4m")
    expect((ow, oh) == (TOOLS_W, TOOLS_H) and out is not None and out.shape[0] == n_out,
           f"tools output {ow}x{oh} with {0 if out is None else out.shape[0]} frames")
    spread = float(out.astype(float).std())
    expect(spread > 1.0, f"tools output is flat (std {spread:.3f})")
    say(f"PHASE tools: {TOOLS_FRAMES} frames {TOOLS_W}x{TOOLS_H} -> {n} frames (ESRGAN x4 "
        f"nf64 nb23 + RIFE v4.x x2, bf16, chunks of {TOOLS_CHUNK}), 2 runs: "
        f"{', '.join(f'{n / w:.3f}' for w in walls)} fps out "
        f"({', '.join(f'{TOOLS_FRAMES / w:.3f}' for w in walls)} fps in), "
        f"K5 launches per run {counts['conv3x3']} (want {want_k5}), peak allocated "
        f"{peak / 2**30:.3f} GiB [{card}]")
    say(f"PHASE tools launches: {json.dumps(counts)}")
    prof = device_profile(lambda: run_merged_pipeline(clip, tmp / "tools_prof.y4m", cfg, ep,
                                                      rp, device=dev))
    say(f"PHASE tools profile (one more run under torch.profiler, against the faster "
        f"run's wall): {fmt_profile(prof, 1e3 * min(walls))} [{card}]")

    # the layers of one device-resident 5-frame chunk
    from visiondepth3d_tpu_torch.enhance.esrgan import RRDBNet

    fn = make_enhance_fn(cfg, ep, rp, (TOOLS_H, TOOLS_W), dev)
    esrgan = RRDBNet().to(dev)
    esrgan.load_state_dict(ep)
    esrgan = esrgan.to(torch.bfloat16).eval()
    rife = rp[1].build().to(dev)
    rife.load_state_dict(rp[0])
    rife = rife.to(torch.bfloat16).eval()
    frames_u8 = (torch.rand(TOOLS_CHUNK + 1, TOOLS_H, TOOLS_W, 3,
                            generator=torch.Generator().manual_seed(3)) * 255).to(torch.uint8)
    frames_u8 = frames_u8.to(dev)
    x = frames_u8.to(torch.bfloat16) / 255.0
    with torch.inference_mode():
        feat = esrgan.trunk(x)
    tile = (_tile_len(TOOLS_H), _tile_len(TOOLS_W))
    layers = {
        "chunk": lambda: fn(frames_u8),
        "esrgan trunk": torch.inference_mode()(lambda: esrgan.trunk(x)),
        "esrgan tail (staged, 4 tiles)": lambda: staged_tail(esrgan, feat, tile),
        "rife x2": torch.inference_mode()(lambda: rife(x[:-1], x[1:], 0.5)),
    }
    for name, f in layers.items():
        span = time_ms(f, warmup=1, runs=3)
        say(f"PHASE tools layers {name} ({TOOLS_CHUNK + 1}-frame chunk, wall = host-gated "
            f"span, median of 3): {fmt_profile(device_profile(f), span)} [{card}]")
    return counts


def phase_tools_parity(tmp: Path):
    """The tools path on a small clip on the CPU (plain versions) and on the
    card (K5), float32, TF32 off, full-width models."""
    import numpy as np
    import torch

    from visiondepth3d_tpu_torch.enhance.pipeline import run_merged_pipeline
    from visiondepth3d_tpu_torch.kernels import launch_counts, reset_launch_counts

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    clip = tmp / "tools_small.y4m"
    write_clip(clip, 128, 72, 5)
    cfg, ep, rp = tools_models("float32")
    outs = {}
    for device in ("cpu", "cuda"):
        reset_launch_counts()
        n = run_merged_pipeline(clip, tmp / f"tools_small_{device}.y4m", cfg, ep, rp,
                                device=device)
        expect(n == 9, f"tools on {device} wrote {n} frames, want 9")
        if device == "cuda":
            torch.cuda.synchronize()
            expect(launch_counts["conv3x3"] > 0, "card tools run did not launch K5")
        else:
            expect(not any(launch_counts.values()), "CPU tools run launched a kernel")
        outs[device] = read_clip(tmp / f"tools_small_{device}.y4m")[2]
    a, b = outs["cpu"], outs["cuda"]
    expect(a.shape == b.shape == (9, 72, 128, 3), f"shapes {a.shape} {b.shape}")
    mean = float(np.abs(a.astype(int) - b.astype(int)).mean())
    ssim = min(ssim_gray(x, y) for x, y in zip(a, b))
    say(f"PHASE parity tools: 128x72 x5 frames -> 9, CPU plain vs card K5 (f32, TF32 off): "
        f"mean |d| {mean:.4f} u8 (need <= 1), min SSIM {ssim:.5f} (need >= 0.99)")
    expect(mean <= 1.0 and ssim >= 0.99, "CPU and card tools runs disagree")


def phase_cli(tmp: Path):
    clip = tmp / "small.y4m"
    out = tmp / "cli_sbs.y4m"
    cmd = [sys.executable, "-m", "visiondepth3d_tpu_torch", "render", "--input", str(clip),
           "--allow-random", "--device", "cuda", "--output", str(out),
           "--preserve-aspect", "--chunk-size", "4"]
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=600, cwd=ROOT)
    expect(res.returncode == 0, f"CLI rc={res.returncode}: {res.stderr[-2000:]}")
    w, h, frames = read_clip(out)
    expect((w, h) == (512, 144) and frames is not None and frames.shape[0] == 4,
           f"CLI output {w}x{h} with {0 if frames is None else frames.shape[0]} frames")
    say(f"PHASE cli: vd3d-torch render -> {w}x{h}, {frames.shape[0]} frames")
    out = tmp / "cli_tools.y4m"
    cmd = [sys.executable, "-m", "visiondepth3d_tpu_torch", "tools", "--input", str(clip),
           "--output", str(out), "--esrgan", "--rife", "--allow-random-weights",
           "--device", "cuda"]
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=600, cwd=ROOT)
    expect(res.returncode == 0, f"tools CLI rc={res.returncode}: {res.stderr[-2000:]}")
    w, h, frames = read_clip(out)
    expect((w, h) == (256, 144) and frames is not None and frames.shape[0] == 7,
           f"tools CLI output {w}x{h} with {0 if frames is None else frames.shape[0]} frames")
    say(f"PHASE cli: vd3d-torch tools --esrgan --rife -> {w}x{h}, {frames.shape[0]} frames")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default="all",
                    help="comma list of card,build,kernels,render,tools,parity,cli")
    args = ap.parse_args(argv)
    if not PKG.is_dir():
        print(f"chip_smoke: {PKG} not found; run from a checkout of the repo",
              file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    phases = set(args.phases.split(",")) if args.phases != "all" else {
        "card", "build", "kernels", "render", "tools", "parity", "cli"}
    try:
        card = phase_card()
        phase_build()
        kernels = phase_kernels(card) if "kernels" in phases else {}
        counts = {}
        with tempfile.TemporaryDirectory(prefix="vd3d_smoke_") as td:
            tmp = Path(td)
            if "render" in phases:
                render_counts = phase_render(card, tmp)
                counts.update({k: render_counts[k] for k in RENDER_KERNELS})
            if "tools" in phases:
                tools_counts = phase_tools(card, tmp)
                counts.update({k: tools_counts[k] for k in TOOLS_KERNELS})
            if "parity" in phases:
                phase_parity(card, tmp)
                phase_tools_parity(tmp)
            if "cli" in phases:
                if "parity" not in phases:
                    write_clip(tmp / "small.y4m", 256, 144, 4)
                phase_cli(tmp)
        leaked = sorted(m for m in sys.modules if m.split(".")[0] in
                        ("jax", "jaxlib", "flax", "visiondepth3d_tpu"))
        expect(not leaked, f"the JAX package or jax was imported: {leaked}")
    except PhaseError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1

    # launches are counted on each main path (render: K1-K4, tools: K5);
    # a kernel whose path did not run has null launches
    product_dtype = {"stereo_warp": torch.bfloat16, "feather_heal": torch.bfloat16,
                     "conv3x3": torch.bfloat16}
    table = []
    for name, (source, replaces) in KERNEL_TABLE.items():
        key = (name, product_dtype.get(name, torch.float32))
        if key not in kernels:
            continue
        k = kernels[key]
        table.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                      "launches": counts.get(name), "max_abs_err": k["err"], "ms": k["ms"],
                      "plain_ms": k["plain"], "bound_ms": k["bound_ms"],
                      "bound_by": k["bound_by"], "library_ms": k["library_ms"]})
    say(card_line())
    say(json.dumps({"kernels": table}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
