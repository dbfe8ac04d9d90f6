#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase; needs one CUDA card

Phases, each printed on its own line; any failure exits nonzero:
  1. the card (nvidia-smi name and power limit), torch / CUDA / nvcc versions;
  2. build the hand-written kernels from visiondepth3d_tpu_torch/kernels/csrc;
  3. each kernel against its plain PyTorch version on the card, at the
     shapes of the 1080p render (1080x1920 frames, 648x1152 subject crop),
     with CUDA-event times of both;
  4. the render path: a synthetic 1920x1080 y4m clip of 64 frames through
     render_stereo_video with the benchmark configuration (Depth Anything
     V2-Small, random weights from a seed, 518^2, bf16, fast head; healing
     on, bf16 image plane; Full-SBS 1080p; chunks of 16), three timed runs
     with every kernel launch counted, then one run and each layer of one
     chunk under torch.profiler for the card's own time and busy share;
  5. kernels against plain versions over the whole render: a 256x144 clip
     rendered on the CPU (plain versions) and on the card (kernels);
  6. the CLI once: python -m visiondepth3d_tpu_torch render ...

The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
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
}
H, W = 1080, 1920


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
                "qpair_replay_kernel", "subject_replay_kernel")


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
    """Each kernel against its plain version at the 1080p render's shapes."""
    import torch

    from visiondepth3d_tpu_torch.kernels import postfx, stats, warp

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    results = {}

    # K1: the dual-eye warp, f32 and bf16. |shift| <= 0.042 grid units is
    # 40.3 px, inside the render's disparity bound ceil(0.02 * 1920) + 2 = 41
    # px (the plain shifted accumulation sums only that many taps); columns
    # near both borders sample past the edge and exercise the clamp.
    frame = smooth_frame(gen, H, W, dev)
    depth = smooth_depth(gen, H, W, dev)
    shift = ((torch.rand(H, W, generator=gen) * 2 - 1) * 0.042).to(dev)
    bound = 41
    for dt, tol in ((torch.float32, 1e-5), (torch.bfloat16, 8e-3)):
        f, d = frame.to(dt), depth.to(dt)
        got = warp.stereo_warp_cuda(f, d, shift, bound)
        ref = warp.stereo_warp_torch(f, d, shift, bound)
        err = max((a.float() - b.float()).abs().max().item() for a, b in zip(got, ref))
        ms = time_ms(lambda: warp.stereo_warp_cuda(f, d, shift, bound))
        plain = time_ms(lambda: warp.stereo_warp_torch(f, d, shift, bound))
        say(f"PHASE kernels stereo_warp {dt} max_abs_err={err:.3e} (tol {tol}) "
            f"kernel {ms:.4f} ms plain {plain:.4f} ms [{card}]")
        expect(err <= tol, f"stereo_warp {dt}: max |err| {err} > {tol}")
        results[("stereo_warp", dt)] = (err, ms, plain)

    # K2: feather + heal, f32 and bf16
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
        if dt == torch.float32:
            within = (diff <= 1e-4).float().mean().item()
            say(f"PHASE kernels feather_heal {dt} max_abs_err={err:.3e} "
                f"within_1e-4={within:.6f} (need >= 0.9999) "
                f"kernel {ms:.4f} ms plain {plain:.4f} ms [{card}]")
            expect(within >= 0.9999, f"feather_heal f32: {within} within 1e-4")
        else:
            mean = diff.mean().item()
            say(f"PHASE kernels feather_heal {dt} max_abs_err={err:.3e} "
                f"mean_abs_err={mean:.3e} (need <= 2e-3) "
                f"kernel {ms:.4f} ms plain {plain:.4f} ms [{card}]")
            expect(mean <= 2e-3, f"feather_heal bf16: mean |err| {mean}")
        results[("feather_heal", dt)] = (err, ms, plain)

    # K3: the quantile pair, bit-exact, on a depth map and a constant map
    for name, x, qs in (("depth", depth, (0.02, 0.98)), ("stretch", depth, (0.05, 0.95)),
                        ("constant", torch.full((H, W), 0.37, device=dev), (0.02, 0.98))):
        got = stats.quantile_pair_cuda(x, *qs)
        ref = stats.quantile_pair_torch(x, *qs)
        expect(torch.equal(got, ref), f"quantile_pair {name}: {got.tolist()} != {ref.tolist()}")
    ms = time_ms(lambda: stats.quantile_pair_cuda(depth, 0.02, 0.98))
    plain = time_ms(lambda: stats.quantile_pair_torch(depth, 0.02, 0.98))
    say(f"PHASE kernels quantile_pair bit-exact on 3 maps, max_abs_err=0 "
        f"kernel {ms:.4f} ms plain {plain:.4f} ms [{card}]")
    results[("quantile_pair", torch.float32)] = (0.0, ms, plain)

    # K4: subject statistics on the 60 % center crop (a strided view)
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
    say(f"PHASE kernels subject_stats bit-exact on 3 crops, max_abs_err=0 "
        f"kernel {ms:.4f} ms plain {plain:.4f} ms [{card}]")
    results[("subject_stats", torch.float32)] = (0.0, ms, plain)
    return results


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
    for k, v in counts.items():
        expect(v > 0, f"kernel {k} was not launched on the render path")
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
            expect(all(v > 0 for v in launch_counts.values()),
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default="all",
                    help="comma list of card,build,kernels,render,parity,cli")
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
        "card", "build", "kernels", "render", "parity", "cli"}
    try:
        card = phase_card()
        phase_build()
        kernels = phase_kernels(card) if "kernels" in phases else {}
        counts = None
        with tempfile.TemporaryDirectory(prefix="vd3d_smoke_") as td:
            tmp = Path(td)
            if "render" in phases:
                counts = phase_render(card, tmp)
            if "parity" in phases:
                phase_parity(card, tmp)
            if "cli" in phases:
                if "parity" not in phases:
                    write_clip(tmp / "small.y4m", 256, 144, 4)
                phase_cli(tmp)
        expect("jax" not in sys.modules, "jax was imported")
    except PhaseError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1

    # launches are measured only by the render phase; without it they are null
    product_dtype = {"stereo_warp": torch.bfloat16, "feather_heal": torch.bfloat16}
    table = []
    for name, (source, replaces) in KERNEL_TABLE.items():
        key = (name, product_dtype.get(name, torch.float32))
        if key not in kernels:
            continue
        err, ms, plain = kernels[key]
        table.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                      "launches": None if counts is None else counts[name],
                      "max_abs_err": err, "ms": ms,
                      "plain_ms": plain})
    say(card_line())
    say(json.dumps({"kernels": table}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
