#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase; needs one CUDA card

    python3 chip_smoke.py --phases card,build,kernels     # a subset

Phases, each printed on its own line; any failure exits nonzero:
  1. (card) the card (nvidia-smi name and power limit), torch / CUDA / nvcc
     versions;
  2. (build) build the hand-written kernels from
     visiondepth3d_tpu_torch/kernels/csrc;
  3. (kernels) each kernel against its plain PyTorch version on the card,
     with times of both, of the library call where one computes the same
     function, and the kernel's bound. A kernel's time is `runs` back-to-
     back launches captured in one CUDA graph and replayed between one
     CUDA-event pair, over `runs`; beside it the host loop of the same
     launches (the host launching each), one call's device operations
     counted from a CUDA-graph capture (the count the gates read), and its
     device time from torch.profiler where the profiler sees the card.
     Library calls are timed by graph replay too, plain versions by the
     host loop. An empty kernel timed both ways is the launch floor. K1-K4
     at the shapes of the 1080p render (1080x1920 frames, 648x1152 subject crop, and an unaligned crop), K5 (the 3x3
     conv) in f32 and bf16 at five shapes of the frame-tools path and on
     the dense block's strided views (input a channel slice of the
     192-channel buffer, output written into a slice of it), K6 (DOF +
     grade) at 1080p, both eyes, dof_strength 2 and 5, all in focus and all
     out of focus, K7 (attention) at the depth model's shapes
     [16|8|2, 1370, 6, 64], ViT-B's and ViT-L's [8, 1370, 12|16, 64] and a
     padded [2, 270, 3, 64];
  4. (render) the render path: a synthetic 1920x1080 y4m clip of 64 frames
     through render_stereo_video with the benchmark configuration (Depth
     Anything V2-Small, random weights from a seed, 518^2, bf16, fast head;
     healing on, bf16 image plane; Full-SBS 1080p; chunks of 16), three
     timed runs with every kernel launch counted, then one run and each
     layer of one chunk under torch.profiler for the card's own time and
     busy share;
  5. (dof) the depth-of-field render: the same configuration with
     dof_strength 2 over a 32-frame clip, two timed runs with K6 (and one
     with the plain DOF ops on the card), launches counted, one profiled run;
  6. (depth) the depth-only route: render_depth_video_file (DA-V2-Small,
     518^2, bf16, fast head, batch 8) over a 64-frame 1080p clip, two timed
     runs with SDPA and two with the ops.attention.USE_VMEM_KERNEL opt-in
     (K7, 12 launches per model call), one profiled run of each;
  7. (tools) the frame-tools path: a synthetic 960x540 y4m clip of 9 frames
     through run_merged_pipeline with Real-ESRGAN x4plus and practical-RIFE
     v4.x at full width (random weights from a seed), bf16, chunks of 4, two
     timed runs with K5's launches counted, then one run and each layer of
     one chunk under torch.profiler, with the device time in concatenation
     kernels (none in the ESRGAN trunk);
  8. (parity) kernels against plain versions over whole paths, on the CPU
     (plain versions) and on the card: a 256x144 render without and with
     depth of field and in each other output format, the depth route with
     the attention opt-in, and a 128x72 frame-tools run;
  9. (surface) the render configuration of phase 4 in the other output
     formats (Half-SBS, VR, Red-Cyan Anaglyph in both channel conventions,
     Passive Interlaced; 16 frames each, K1-K4 launches gated per frame,
     fps and the profiler's device time printed), a clip whose frames 5-9
     are black with skip_blank_frames (those frames' two halves equal bit
     for bit, their neighbours' not), a letterboxed clip (138 black rows at
     top and bottom) with auto_crop_black_bars, and a 48-frame render
     cancelled after its second chunk and resumed, byte-identical to an
     unbroken render;
 10. (catalog) Depth Anything V2-Large (random weights from seed 0, 518^2,
     bf16, fast head) through the fused 1080p Full-SBS render (32 frames,
     chunks of 16; fps, device time, busy share, K1-K4 launches gated per
     frame); V2-Base and V2-Large through the depth route with the K7
     opt-in (16 frames, batch 8: 12 and 24 K7 launches per model call); one
     518^2 frame through V2-Large in float32 on the CPU and on the card
     (TF32 off), the route's u8 depth within a mean of 1 u8;
 11. (cli) the CLI once per subcommand: python -m visiondepth3d_tpu_torch
     render (also with --dof_strength 2, --format "Red-Cyan Anaglyph",
     --preset best3d --dry-run, and --control FILE with 'cancel' written
     once frames come out) / depth / tools ...

Optional, run only when named: (k2shapes) K2 built at other strip widths,
rows per step and CTAs per SM, each checked and timed against the default
at the render's shapes.

The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}. Imports nothing of JAX and
nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import dataclasses
import filecmp
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PKG = ROOT / "visiondepth3d_tpu_torch"

# kernel name -> (source, TPU kernel it replaces: its public function and
# the line of its pallas_call)
KERNEL_TABLE = {
    "stereo_warp": ("visiondepth3d_tpu_torch/kernels/csrc/warp.cu",
                    "visiondepth3d_tpu/ops/pallas_warp.py:126 stereo_warp_pallas "
                    "(pallas_call :168)"),
    "feather_heal": ("visiondepth3d_tpu_torch/kernels/csrc/postfx.cu",
                     "visiondepth3d_tpu/ops/pallas_postfx.py:139 feather_heal_pallas "
                     "(pallas_call :207)"),
    "quantile_pair": ("visiondepth3d_tpu_torch/kernels/csrc/stats.cu",
                      "visiondepth3d_tpu/ops/pallas_stats.py:72 quantile_pair_pallas "
                      "(pallas_call :78)"),
    "subject_stats": ("visiondepth3d_tpu_torch/kernels/csrc/stats.cu",
                      "visiondepth3d_tpu/ops/pallas_stats.py:128 subject_stats_pallas "
                      "(pallas_call :137)"),
    "conv3x3": ("visiondepth3d_tpu_torch/kernels/csrc/conv.cu",
                "visiondepth3d_tpu/ops/pallas_conv.py:116 conv3x3_pallas (pallas_call :158)"),
    "dof_grade": ("visiondepth3d_tpu_torch/kernels/csrc/dof.cu",
                  "visiondepth3d_tpu/ops/pallas_dof.py:111 dof_grade_pallas (pallas_call :180)"),
    "vmem_attention": ("visiondepth3d_tpu_torch/kernels/csrc/attention.cu",
                       "visiondepth3d_tpu/ops/pallas_attention.py:86 vmem_attention "
                       "(pallas_call :114)"),
}
# the kernels of each main path: the render's four, the DOF render's K6 (on
# top of the four), the depth route's attention, the frame tools' conv
RENDER_KERNELS = ("stereo_warp", "feather_heal", "quantile_pair", "subject_stats")
DOF_KERNELS = ("dof_grade",)
DEPTH_KERNELS = ("vmem_attention",)
TOOLS_KERNELS = ("conv3x3",)
ALL_PHASES = ("card", "build", "kernels", "render", "dof", "depth", "tools", "surface",
              "catalog", "parity", "cli")
OPTIONAL_PHASES = ("k2shapes",)  # run only when named
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


HAND_KERNELS = ("stereo_warp_kernel", "feather_heal_kernel", "quantile_pair_kernel",
                "subject_stats_kernel", "conv3x3_wgmma_kernel",
                "conv3x3_fma_kernel", "dof_grade_kernel", "attention_wgmma_kernel",
                "attention_fma_kernel")

_PREDICTORS: dict = {}


def da_predictor(device: str = "cuda", dtype: str = "bfloat16",
                 model: str = "depth-anything-v2-small"):
    """A catalog model (Depth Anything V2-Small unless named) at 518^2,
    fast head, random weights from seed 0: one instance per (model,
    device, dtype), shared by the phases."""
    key = (model, device, dtype)
    if key not in _PREDICTORS:
        from visiondepth3d_tpu_torch.depth.registry import CATALOG, load_predictor

        expect(model in CATALOG, f"{model} is not in the port's catalog")
        _PREDICTORS[key] = load_predictor(model, None, inference_size=518, seed=0,
                                          dtype=dtype, device=device, fast_head=True)
    return _PREDICTORS[key]


def drop_predictors(model: str):
    """Free a model's predictors (the catalog phase's large ones)."""
    import torch

    for key in [k for k in _PREDICTORS if k[0] == model]:
        del _PREDICTORS[key]
    torch.cuda.empty_cache()


def bound(flops: float, nbytes: float, dtype: str) -> tuple[float, str]:
    """The least time (ms) the card could take: the larger of the bytes over
    the memory rate and the operations over the peak rate of their type."""
    t_bytes = nbytes / PEAK_BYTES
    t_ops = flops / PEAK_FLOPS[dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def device_profile(fn) -> dict | None:
    """Run fn() once under torch.profiler and read the card's own time.

    Returns, in ms, the summed duration of every device event (kernels,
    memsets, copies), the part spent in this package's hand-written kernels
    and the part in concatenation kernels (names with "Cat"), and the union
    of the device intervals (the time the card was busy);
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
            "cat_ms": sum(e - s for s, e, n in ivs if "Cat" in n) / 1e3,
            "events": len(ivs), "busy_ms": busy / 1e3}


def fmt_profile(p: dict | None, wall_ms: float) -> str:
    """The profile beside the unprofiled wall time of the same call."""
    if p is None:
        return (f"wall {wall_ms:.3f} ms; device time not measured "
                f"(the profiler saw no device event)")
    return (f"device {p['device_ms']:.3f} ms in {p['events']} events "
            f"(hand kernels {p['hand_ms']:.3f} ms), busy {p['busy_ms']:.3f} ms of "
            f"{wall_ms:.3f} ms wall = {100 * p['busy_ms'] / wall_ms:.1f} % busy")


def fmt_cat(p: dict | None) -> str:
    return "" if p is None else f"; concatenation kernels {p['cat_ms']:.3f} ms"


def _events_ms(run) -> float:
    """CUDA-event time of run() (which enqueues work), synchronized."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def time_ms(fn, warmup: int = 3, runs: int = 20) -> float:
    """Host loop: `runs` back-to-back calls of fn() between one CUDA-event
    pair, after a warm-up; the total over `runs`. The host launches every
    call, so a call shorter than the host's own time per call measures the
    host (see graph_ms)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()

    def run():
        for _ in range(runs):
            fn()
    return _events_ms(run) / runs


def graph_ms(fn, warmup: int = 3, runs: int = 20) -> float:
    """Graph replay: `runs` calls of fn() captured in one CUDA graph, which
    is replayed between one CUDA-event pair; the total over `runs`. The same
    back-to-back launches with no host work between them: a kernel's own
    time plus the card's gap between launches."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(runs):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    ms = _events_ms(graph.replay) / runs
    del graph
    torch.cuda.empty_cache()
    return ms


def launch_floor(card: str) -> dict:
    """An empty kernel timed both ways: the least a launch costs."""
    import torch

    from visiondepth3d_tpu_torch.kernels._lib import check, lib, stream_of

    probe = torch.empty(1, device="cuda")

    def empty():
        check(lib().vd3d_empty(stream_of(probe)), "empty kernel")
    floor = {"host": time_ms(empty, runs=200), "graph": graph_ms(empty, runs=200)}
    say(f"PHASE kernels launch floor (an empty kernel): host loop {floor['host']:.4f} ms, "
        f"graph replay {floor['graph']:.4f} ms per launch [{card}]")
    return floor


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
    say(f"PHASE build: {path.name} in {dt:.1f} s")
    for name, regs, spill in ptxas_kernels(_lib.build_log):
        say(f"  ptxas: {name}: {regs}; {spill}")


def ptxas_kernels(log: str) -> list[tuple[str, str, str]]:
    """(kernel, registers line, spill line) of each entry function in the
    `-Xptxas -v` log; the kernel is named by its HAND_KERNELS stem and the
    mangled template arguments after it."""
    out, name, spill = [], None, ""
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            mangled = m.group(1)
            stem = next((k for k in HAND_KERNELS + ("empty_kernel",) if k in mangled), mangled)
            tail = mangled.split(stem, 1)[-1] if stem in mangled else ""
            args = re.match(r"I(.*?)EEv", tail)
            name, spill = stem + (f"<{args.group(1)}>" if args else ""), ""
        elif "spill stores" in ln:
            spill = ln.strip()
        elif "Used" in ln and "registers" in ln and name:
            out.append((name, ln.split(":", 1)[-1].strip(), spill))
            name = None
    return out


def kernel_times(fn, runs: int = 20) -> dict:
    """A kernel wrapper's times: graph replay (`ms`, the kernel's row), the
    host loop (`host`), the device operations of one call counted from a
    CUDA-graph capture (`events`), and one call's device time and device
    events from the profiler (`device`, `prof_events`; None where the
    profiler saw no device event: the gates read only `events`)."""
    from visiondepth3d_tpu_torch.kernels._lib import device_ops

    prof = device_profile(fn)
    return {"ms": graph_ms(fn, runs=runs), "host": time_ms(fn, runs=runs),
            "events": device_ops(fn),
            "device": None if prof is None else prof["device_ms"],
            "prof_events": None if prof is None else prof["events"]}


def fmt_times(t: dict) -> str:
    prof = ("device time not measured (the profiler saw no device event)" if t["device"] is None
            else f"profiler {t['device']:.4f} ms of device time in {t['prof_events']} events")
    return (f"kernel {t['ms']:.4f} ms (graph replay; host loop {t['host']:.4f} ms; one call "
            f"{t['events']} device operations, {prof})")


def phase_kernels(card: str) -> dict:
    """Each kernel against its plain version: K1-K4 at the 1080p render's
    shapes, then K5, K6 and K7. Returns, per kernel and type, its error,
    times (kernel, plain, library) and bound."""
    import torch

    from visiondepth3d_tpu_torch.kernels import postfx, stats, warp
    from visiondepth3d_tpu_torch.kernels._lib import device_ops

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    results = {}
    floor = launch_floor(card)

    def record(name, dt, err, times, plain, flops, nbytes, library_ms=None):
        tname = "bfloat16" if dt == torch.bfloat16 else "float32"
        bound_ms, bound_by = bound(flops, nbytes, tname)
        results[(name, dt)] = dict(err=err, ms=times["ms"], plain=plain, bound_ms=bound_ms,
                                   bound_by=bound_by, library_ms=library_ms)
        return (f"{fmt_times(times)} plain {plain:.4f} ms bound {bound_ms:.4f} ms "
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
        times = kernel_times(lambda: warp.stereo_warp_cuda(f, d, shift, max_shift))
        plain = time_ms(lambda: warp.stereo_warp_torch(f, d, shift, max_shift))
        s = f.element_size()
        line = record("stereo_warp", dt, err, times, plain, 38 * H * W, H * W * (12 * s + 4))
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
        times = kernel_times(lambda: postfx.feather_heal_cuda(*args, **kw))
        plain = time_ms(lambda: postfx.feather_heal_torch(*args, **kw))
        line = record("feather_heal", dt, err, times, plain, 376 * H * W,
                      H * W * 17 * args[0].element_size())
        expect(times["events"] == 1, f"feather_heal: {times['events']} device events per call")
        if dt == torch.float32:
            within = (diff <= 1e-4).float().mean().item()
            say(f"PHASE kernels feather_heal {dt} max_abs_err={err:.3e} "
                f"within_1e-4={within:.6f} (need >= 0.9999: margin "
                f"{1e6 * (within - 0.9999):.1f} per million values) {line}")
            expect(within >= 0.9999, f"feather_heal f32: {within} within 1e-4")
        else:
            mean = diff.mean().item()
            say(f"PHASE kernels feather_heal {dt} max_abs_err={err:.3e} "
                f"mean_abs_err={mean:.3e} (need <= 2e-3) {line}")
            expect(mean <= 2e-3, f"feather_heal bf16: mean |err| {mean}")
    floor_note = (f"launch floor {floor['graph']:.4f} ms graph replay, {floor['host']:.4f} ms "
                  f"host loop")

    # K3: the quantile pair, bit-exact, on a depth map and a constant map,
    # one launch and one device operation per call. Bound: one read of the
    # map; 12 bisection steps of a compare and a count per pixel (24
    # operations).
    for name, x, qs in (("depth", depth, (0.02, 0.98)), ("stretch", depth, (0.05, 0.95)),
                        ("constant", torch.full((H, W), 0.37, device=dev), (0.02, 0.98))):
        got = stats.quantile_pair_cuda(x, *qs)
        ref = stats.quantile_pair_torch(x, *qs)
        expect(torch.equal(got, ref), f"quantile_pair {name}: {got.tolist()} != {ref.tolist()}")
    times = kernel_times(lambda: stats.quantile_pair_cuda(depth, 0.02, 0.98), runs=100)
    plain = time_ms(lambda: stats.quantile_pair_torch(depth, 0.02, 0.98))
    line = record("quantile_pair", torch.float32, 0.0, times, plain, 24 * H * W, 4 * H * W + 8)
    say(f"PHASE kernels quantile_pair bit-exact on 3 maps, max_abs_err=0, 1 device operation "
        f"per call {line}; {floor_note}")
    expect(times["events"] == 1, f"quantile_pair: {times['events']} device operations per call")

    # K4: subject statistics on the 60 % center crop (a strided view), and
    # on an unaligned view (start column 385, odd width: the scalar loads).
    # One cluster launch: one device event per call. Bound: one read of the
    # crop; 42 operations per pixel (valid band 3, 64-bin index 3, 12
    # bisection steps of 3).
    crops = {name: m[H // 5: H * 4 // 5, W // 5: W * 4 // 5]
             for name, m in (("depth", depth), ("constant", torch.full((H, W), 0.37, device=dev)),
                             ("empty", torch.full((H, W), 0.01, device=dev)))}
    crops["unaligned"] = depth[H // 5: H * 4 // 5, W // 5 + 1: W * 4 // 5]
    expect(tuple(crops["depth"].shape) == (648, 1152), f"crop {tuple(crops['depth'].shape)}")
    for name, crop in crops.items():
        got = stats.subject_stats_cuda(crop)
        ref = stats.subject_stats_torch(crop)
        for a, b, part in zip(got, ref, ("hist", "count", "median")):
            expect(torch.equal(a, b), f"subject_stats {name} {part}: {a} != {b}")
        events = device_ops(lambda: stats.subject_stats_cuda(crop))
        expect(events == 1, f"subject_stats {name}: {events} device events per call, want 1")
    crop = crops["depth"]
    times = kernel_times(lambda: stats.subject_stats_cuda(crop), runs=100)
    plain = time_ms(lambda: stats.subject_stats_torch(crop))
    line = record("subject_stats", torch.float32, 0.0, times, plain, 42 * crop.numel(),
                  4 * crop.numel() + 4 * 66)
    say(f"PHASE kernels subject_stats bit-exact on 4 crops ({', '.join(crops)}), "
        f"max_abs_err=0, cluster of {stats.cluster_size()} CTAs, 1 device event per call "
        f"{line}; {floor_note}")
    del frame, depth, shift, base, left, right, dl, dr, args, got, ref, diff, crops, crop
    phase_conv_kernel(card, results)
    phase_dof_kernel(card, results)
    phase_attention_kernel(card, results)
    return results


# K2 shapes (strip width TW, rows per step RB, CTAs per SM the registers
# are capped for) of the optional phase k2shapes; csrc/postfx.cu's defaults
# are (128, 4, 2) in bf16 and (96, 4, 2) in f32
K2_SHAPES = ((128, 4, 2), (96, 4, 2), (128, 4, 1), (96, 4, 1), (64, 4, 2), (128, 8, 1),
             (96, 8, 1))


def phase_k2_shapes(card: str, rounds: int = 5):
    """K2 built at each of K2_SHAPES (the -D overrides of csrc/postfx.cu,
    one shape for both image types, one nvcc each, all started together), checked against its plain
    version and timed by graph replay at the render's shapes (1080p, both
    eyes, blur_ksize 9, feather and heal), bf16 and f32. The shapes take
    turns in `rounds` rounds, so a drift of the card's clock reaches every
    shape alike; the median of the rounds is the shape's time."""
    import ctypes

    import torch

    from visiondepth3d_tpu_torch.kernels import _lib, postfx

    with tempfile.TemporaryDirectory(prefix="vd3d_k2shapes_") as td:
        procs = {}
        for shape in K2_SHAPES:
            tw, rb, ctas = shape
            so = Path(td) / f"k2_tw{tw}_rb{rb}_c{ctas}.so"
            cmd = [_lib.find_nvcc(), *_lib.NVCC_FLAGS, f"-DVD3D_K2_TW_BF16={tw}",
                   f"-DVD3D_K2_TW_F32={tw}", f"-DVD3D_K2_RB={rb}", f"-DVD3D_K2_CTAS={ctas}",
                   "-o", str(so), str(_lib.CSRC / "postfx.cu")]
            procs[shape] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                 stderr=subprocess.STDOUT, text=True))
        libs = {}
        pv, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        try:
            for shape, (so, proc) in procs.items():
                log = proc.communicate()[0]
                expect(proc.returncode == 0, f"k2shapes {shape}: nvcc failed\n{log[-2000:]}")
                for name, regs, spill in ptxas_kernels(log):
                    say(f"  ptxas k2 {shape}: {name}: {regs}; {spill}")
                fn = ctypes.CDLL(str(so)).vd3d_feather_heal  # stays mapped once the file is gone
                fn.argtypes = [pv] * 7 + [i, i, i, f, f, f, i, i, i, pv]
                fn.restype = ctypes.c_int
                libs[shape] = fn
        finally:
            for _, proc in procs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    frame = smooth_frame(gen, H, W, dev)
    depth = smooth_depth(gen, H, W, dev)
    base = smooth_frame(gen, H, W, dev)
    left = (base + 0.05 * torch.randn(H, W, 3, generator=gen).to(dev)).clamp(0, 1)
    right = (base - 0.05 * torch.randn(H, W, 3, generator=gen).to(dev)).clamp(0, 1)
    dl, dr = depth, torch.roll(depth, 7, dims=1)
    for dt in (torch.bfloat16, torch.float32):
        args = [t.to(dt).contiguous() for t in (left, right, frame, dl, dr)]
        ref = postfx.feather_heal_torch(*args, blur_ksize=9)
        runs, times = {}, {}
        for shape, fn in libs.items():
            ol, orr = torch.empty_like(args[0]), torch.empty_like(args[0])

            def run(fn=fn, ol=ol, orr=orr):
                rc = fn(*(t.data_ptr() for t in args), ol.data_ptr(), orr.data_ptr(), H, W, 9,
                        10.0, 0.5, 0.05, 1, 1, int(dt == torch.bfloat16), _lib.stream_of(ol))
                if rc:
                    raise PhaseError(f"rc {rc}")
            try:
                run()
            except PhaseError as e:
                say(f"PHASE k2shapes TW={shape[0]} RB={shape[1]} ctas={shape[2]} {dt}: "
                    f"launch refused ({e})")
                continue
            torch.cuda.synchronize()
            diff = torch.cat([(a.float() - b.float()).abs().reshape(-1)
                              for a, b in zip((ol, orr), ref)])
            within, mean = (diff <= 1e-4).float().mean().item(), diff.mean().item()
            expect(within >= 0.9999 if dt == torch.float32 else mean <= 2e-3,
                   f"k2shapes {shape} {dt}: within 1e-4 {within}, mean |err| {mean}")
            runs[shape], times[shape] = run, []
        for _ in range(rounds):
            for shape, run in runs.items():
                times[shape].append(graph_ms(run, runs=50))
        for shape, ts in times.items():
            say(f"PHASE k2shapes TW={shape[0]} RB={shape[1]} ctas={shape[2]} {dt}: "
                f"median {statistics.median(ts):.4f} ms of rounds "
                f"{' '.join(f'{t:.4f}' for t in ts)} (graph replay) [{card}]")


def phase_dof_kernel(card: str, results: dict):
    """K6 against its plain version at 1080p, both eyes, grade on, f32 and
    bf16, dof_strength 2 (5 levels, reach 4: the DOF render's setting) and
    5 (reach 10, the preset maximum); then bf16 at strength 2 with every
    pixel in focus (levels 0-1 only) and every pixel out of focus (levels
    3-4). No library call computes the LOD stack and the lerp; library is
    none. The JSON line carries dof_strength 2 bf16 on the smooth depth.

    Bound: read both eyes (3 values each) and the f32 depth, write both
    eyes. Operations per value (in f32 on CUDA cores whatever the storage
    type): a multiply and an add per tap of both separable passes of every
    blurred level (4 x the summed kernel sizes: 96 at sigma 2, 224 at 5),
    the two-level lerp 4, clamp 2, grade 8; per pixel 8 for the blur index.
    """
    import torch

    from visiondepth3d_tpu_torch.kernels import dof as kdof
    from visiondepth3d_tpu_torch.ops.dof import level_ksize, level_sigmas

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(6)
    base = smooth_frame(gen, H, W, dev)
    left = (base + 0.03 * torch.randn(H, W, 3, generator=gen).to(dev)).clamp(0, 1)
    right = (base - 0.03 * torch.randn(H, W, 3, generator=gen).to(dev)).clamp(0, 1)
    depth = smooth_depth(gen, H, W, dev)
    focal = torch.tensor(0.45, device=dev)
    flat = torch.full((H, W), 0.45, device=dev)
    kw = dict(saturation=1.2, contrast=1.1, brightness=0.02)
    n = 5
    cases = [(sigma, dt, "smooth depth", depth, focal) for sigma in (2.0, 5.0)
             for dt in (torch.float32, torch.bfloat16)]
    cases += [(2.0, torch.bfloat16, "all in focus", flat, focal),
              (2.0, torch.bfloat16, "all out of focus", flat, torch.tensor(0.95, device=dev))]
    for sigma, dt, what, dmap, fd in cases:
        ksum = sum(level_ksize(sg) for sg in level_sigmas(sigma, n) if sg > 0)
        flops = H * W * (6 * (4 * ksum + 14) + 8)
        args = (left.to(dt), right.to(dt), dmap, fd, sigma, 0.35, n)
        got = kdof.dof_grade_cuda(*args, **kw)
        ref = kdof.dof_grade_torch(*args, **kw)
        diff = torch.cat([(a.float() - b.float()).abs().reshape(-1) for a, b in zip(got, ref)])
        err, mean = diff.max().item(), diff.mean().item()
        del got, ref, diff
        times = kernel_times(lambda: kdof.dof_grade_cuda(*args, **kw))
        plain = time_ms(lambda: kdof.dof_grade_torch(*args, **kw), warmup=1, runs=5)
        nbytes = H * W * (12 * args[0].element_size() + 4) + 4
        bound_ms, bound_by = bound(flops, nbytes, "float32")
        if dt == torch.float32:
            ok, gate = err <= 1e-5, "need max <= 1e-5"
        else:
            ok, gate = err <= 1.6e-2 and mean <= 2e-3, "need max <= 1.6e-2, mean <= 2e-3"
        if sigma == 2.0 and what == "smooth depth":
            results[("dof_grade", dt)] = dict(err=err, ms=times["ms"], plain=plain,
                                              bound_ms=bound_ms, bound_by=bound_by,
                                              library_ms=None)
        say(f"PHASE kernels dof_grade sigma {sigma} reach {kdof.dof_reach(sigma, n)} {dt} {what} "
            f"max_abs_err={err:.3e} mean_abs_err={mean:.3e} ({gate}) {fmt_times(times)} "
            f"plain {plain:.4f} ms bound {bound_ms:.4f} ms ({bound_by}; "
            f"{flops / 1e9:.3f} GFLOP) library none [{card}]")
        expect(ok, f"dof_grade sigma {sigma} {dt} {what}: max |err| {err}, mean {mean}")
        expect(times["events"] == 1, f"dof_grade: {times['events']} device events per call")
    del base, left, right, depth, flat
    torch.cuda.empty_cache()


# K7 at the depth route's shapes: [B, N, H, D] and type. B 8 is the depth
# route's batch, 16 the render's chunk; H 6, 12 and 16 are ViT-S, ViT-B and
# ViT-L; [2, 270, 3, 64] pads 270 keys to whole 64-key tiles.
ATTN_SHAPES = (((16, 1370, 6, 64), "bfloat16"), ((8, 1370, 6, 64), "bfloat16"),
               ((8, 1370, 12, 64), "bfloat16"), ((8, 1370, 16, 64), "bfloat16"),
               ((2, 1370, 6, 64), "float32"), ((2, 270, 3, 64), "bfloat16"),
               ((2, 270, 3, 64), "float32"))


def phase_attention_kernel(card: str, results: dict):
    """K7 against its plain version (f32 matmuls without TF32), with SDPA on
    BHND views as the library call. Bound: 4 B H N^2 D operations (the two
    products) at the type's peak, Q, K, V read and O written once. The JSON
    line carries [8, 1370, 6, 64] bf16, the depth route's call."""
    import torch
    import torch.nn.functional as F

    from visiondepth3d_tpu_torch.kernels import attention as kattn

    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(7)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for shape, tname in ATTN_SHAPES:
            dt = getattr(torch, tname)
            q, k, v = (torch.randn(shape, generator=gen, device=dev).to(dt) for _ in range(3))
            got = kattn.vmem_attention_cuda(q, k, v)
            ref = kattn.vmem_attention_torch(q, k, v)
            diff = (got.float() - ref.float()).abs()
            err, mean = diff.max().item(), diff.mean().item()
            del got, ref, diff
            times = kernel_times(lambda: kattn.vmem_attention_cuda(q, k, v))
            ms = times["ms"]
            plain = time_ms(lambda: kattn.vmem_attention_torch(q, k, v), warmup=1, runs=5)
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            library = graph_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt))
            b, n, h, d = shape
            flops = 4.0 * b * h * n * n * d
            nbytes = 4 * b * n * h * d * q.element_size()
            bound_ms, bound_by = bound(flops, nbytes, tname)
            if dt == torch.float32:
                ok, gate = err <= 1e-5, "need max <= 1e-5"
            else:
                ok, gate = err <= 1.6e-2 and mean <= 1e-3, "need max <= 1.6e-2, mean <= 1e-3"
            if shape in ((8, 1370, 6, 64), (2, 1370, 6, 64)):
                results[("vmem_attention", dt)] = dict(err=err, ms=ms, plain=plain,
                                                       bound_ms=bound_ms, bound_by=bound_by,
                                                       library_ms=library)
            say(f"PHASE kernels vmem_attention {list(shape)} {tname} max_abs_err={err:.3e} "
                f"mean_abs_err={mean:.3e} ({gate}) {fmt_times(times)} plain {plain:.4f} ms "
                f"library {library:.4f} ms (SDPA, graph replay) bound {bound_ms:.4f} ms "
                f"({bound_by}; {flops / ms / 1e9:.1f} TFLOP/s) [{card}]")
            expect(ok, f"vmem_attention {list(shape)} {tname}: max |err| {err}, mean {mean}")
            del q, k, v, qt, kt, vt
            torch.cuda.empty_cache()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


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
                times = kernel_times(lambda: conv.conv3x3_cuda(x, w, b, act, packed=packed),
                                     runs=5)
                ms = times["ms"]
                plain = time_ms(lambda: conv.conv3x3_torch(x, w, b, act), warmup=1, runs=3)
                xc = x.permute(0, 3, 1, 2)  # NCHW view of NHWC memory: channels_last
                wc = w.to(dt).permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
                bc = b.to(dt)
                library = graph_ms(lambda: F.conv2d(xc, wc, bc, padding=1), warmup=2, runs=5)
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
                    f"max_abs_err={err:.3e} mean_abs_err={mean:.3e} ({gate}) {fmt_times(times)} "
                    f"plain {plain:.4f} ms library {library:.4f} ms (graph replay) bound "
                    f"{bound_ms:.4f} ms ({bound_by}; {flops / ms / 1e9:.1f} TFLOP/s) [{card}]")
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
            conv_dense_block_views(card, dt, gen)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32


def conv_dense_block_views(card: str, dt, gen):
    """K5 on the views the dense block gives it: conv k reads the first 64 +
    32 (k - 1) channels of a 192-channel [1, 540, 960] buffer and writes its
    32 channels right after them (conv5 reads all 192 into a new tensor),
    against the plain version on the same views, with the gates of the
    contiguous shapes; the channels it must not write are checked unchanged."""
    import torch

    from visiondepth3d_tpu_torch.kernels import conv

    dev = torch.device("cuda")
    buf = torch.randn(1, 540, 960, 192, generator=gen, device=dev).to(dt)
    for k in range(1, 6):
        c, o = 64 + 32 * (k - 1), (32 if k < 5 else 64)
        act = "lrelu" if k < 5 else None
        w = torch.randn(3, 3, c, o, generator=gen, device=dev) / (9 * c) ** 0.5
        b = 0.1 * torch.randn(o, generator=gen, device=dev)
        packed = conv.pack_conv3x3(w, b, dt)
        ref = conv.conv3x3_torch(buf[..., :c], w, b, act)
        if k < 5:
            before = buf.clone()
            out = buf[..., c:c + o]
            conv.conv3x3_cuda(buf[..., :c], w, b, act, packed=packed, out=out)
            torch.cuda.synchronize()
            kept = bool(torch.equal(buf[..., :c], before[..., :c]) and
                        torch.equal(buf[..., c + o:], before[..., c + o:]))
            got = out.clone()
            buf.copy_(before)
            del before

            def run():
                conv.conv3x3_cuda(buf[..., :c], w, b, act, packed=packed, out=out)
        else:
            got, kept = conv.conv3x3_cuda(buf, w, b, act, packed=packed), True

            def run():
                conv.conv3x3_cuda(buf, w, b, act, packed=packed)
        diff = (got.float() - ref.float()).abs()
        scale = ref.float().abs().max().item()
        err, mean = diff.max().item(), diff.mean().item()
        ms = graph_ms(run, warmup=2, runs=5)
        if dt == torch.float32:
            ok, gate = err <= 1e-4 * scale, f"need max <= 1e-4 * {scale:.3f}"
        else:
            ok = err <= 8e-3 * scale and mean <= 1e-3 * scale
            gate = f"need max <= 8e-3 and mean <= 1e-3 of {scale:.3f}"
        view = f"buf[..., :{c}] -> " + (f"buf[..., {c}:{c + o}]" if k < 5 else "new")
        say(f"PHASE kernels conv3x3 dense block conv{k} {view} {act} {dt} max_abs_err={err:.3e} "
            f"mean_abs_err={mean:.3e} ({gate}) other channels unchanged {kept} kernel {ms:.4f} "
            f"ms (graph replay) [{card}]")
        expect(ok and kept, f"conv3x3 dense block conv{k} {dt}: max |err| {err}, mean {mean}, "
                            f"other channels unchanged {kept}")
        del got, ref, diff, w, b, packed
    del buf
    torch.cuda.empty_cache()


def write_clip(path, w, h, n, fps=24.0, blank=(), bars=0):
    """A synthetic clip: gradients and a moving box; the frames in ``blank``
    all black, ``bars`` black rows at the top and the bottom of each."""
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
            if bars:
                f[:bars] = 0
                f[h - bars:] = 0
            if i in blank:
                f[:] = 0
            wr.write(f)


def read_planes(path):
    """A y4m's (Y, U, V) planes, each stacked over the frames."""
    import numpy as np

    from visiondepth3d_tpu_torch.io import Y4MPlaneReader

    with Y4MPlaneReader(str(path)) as rd:
        frames = []
        while (f := rd.read()) is not None:
            frames.append(f)
    return tuple(np.stack(p) for p in zip(*frames))


def read_clip(path):
    import numpy as np

    from visiondepth3d_tpu_torch.io import Y4MReader

    with Y4MReader(str(path)) as rd:
        frames = list(rd)
        return rd.width, rd.height, np.stack(frames) if frames else None


def warm_clip(tmp: Path) -> Path:
    """A 16-frame 1080p clip for warm-up runs (one chunk)."""
    path = tmp / "warm_1080p.y4m"
    if not path.exists():
        write_clip(path, W, H, 16)
    return path


def phase_render(card: str, tmp: Path) -> dict:
    """The benchmark configuration through render_stereo_video."""
    import torch

    from visiondepth3d_tpu_torch.kernels import launch_counts, reset_launch_counts
    from visiondepth3d_tpu_torch.pipeline.geometry import resolve_geometry
    from visiondepth3d_tpu_torch.pipeline.stereo_pipeline import (
        RenderConfig, make_chunk_fn, render_stereo_video)
    from visiondepth3d_tpu_torch.state.trackers import init_trackers
    from visiondepth3d_tpu_torch.stereo.params import StereoParams
    from visiondepth3d_tpu_torch.stereo.step import render_chunk

    dev = torch.device("cuda")
    pred = da_predictor()
    params = StereoParams(enable_healing=True, image_dtype="bfloat16")
    cfg = RenderConfig(output_format="Full-SBS", output_height=1080, chunk_size=16,
                       device="cuda")
    n_frames, reps = 64, 3
    clip = tmp / "clip_1080p.y4m"
    write_clip(clip, W, H, n_frames)
    render_stereo_video(warm_clip(tmp), None, tmp / "warm_sbs.y4m", params, cfg,
                        predictor=pred)
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
        say(f"PHASE layers {name} (16-frame chunk, wall = host-gated span, mean of 5 "
            f"back-to-back): "
            f"{fmt_profile(device_profile(fn), span)} [{card}]")
    _, outs = render_chunk(run_params, trackers, frames, depths)
    finite = bool(torch.isfinite(outs.left.float()).all() and
                  torch.isfinite(outs.right.float()).all())
    expect(finite, "non-finite pixels in the stereo output")
    say("PHASE layers: stereo outputs finite")
    return counts


def phase_render_dof(card: str, tmp: Path) -> dict:
    """Path A: the benchmark render with dof_strength 2 (K1-K4 and K6, one
    K6 launch per frame for both eyes), two timed runs; then one run with
    the plain DOF ops on the card (dof_backend "torch") and one profiled
    run."""
    import numpy as np
    import torch

    from visiondepth3d_tpu_torch.kernels import launch_counts, reset_launch_counts
    from visiondepth3d_tpu_torch.pipeline.stereo_pipeline import (RenderConfig,
                                                                  render_stereo_video)
    from visiondepth3d_tpu_torch.stereo.params import StereoParams

    pred = da_predictor()
    params = StereoParams(enable_healing=True, image_dtype="bfloat16", dof_strength=2.0)
    cfg = RenderConfig(output_format="Full-SBS", output_height=1080, chunk_size=16,
                       device="cuda")
    n_frames = 32
    clip = tmp / "clip_dof_1080p.y4m"
    write_clip(clip, W, H, n_frames)
    render_stereo_video(warm_clip(tmp), None, tmp / "warm_dof.y4m", params, cfg,
                        predictor=pred)
    torch.cuda.synchronize()
    runs = {}
    for name, p in (("K6", params), ("K6", params),
                    ("plain DOF", params.replace(dof_backend="torch"))):
        reset_launch_counts()
        t0 = time.perf_counter()
        render_stereo_video(clip, None, tmp / f"dof_{name.replace(' ', '_')}.y4m", p, cfg,
                            predictor=pred)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(launch_counts)
        prev = runs.setdefault(name, {"fps": [], "counts": counts})
        expect(prev["counts"] == counts,
               f"launch counts differ between runs: {prev['counts']} then {counts}")
        prev["fps"].append(n_frames / wall)
    counts = runs["K6"]["counts"]
    expect(counts["dof_grade"] == n_frames,
           f"K6 launched {counts['dof_grade']} times, want {n_frames} (one per frame)")
    for k in RENDER_KERNELS:
        expect(counts[k] > 0, f"kernel {k} was not launched on the DOF render path")
    expect(runs["plain DOF"]["counts"]["dof_grade"] == 0, "the plain-DOF run launched K6")
    ow, oh, out = read_clip(tmp / "dof_K6.y4m")
    expect((ow, oh) == (2 * W, H) and out is not None and out.shape[0] == n_frames,
           f"DOF render output {ow}x{oh} with {0 if out is None else out.shape[0]} frames")
    plain_out = read_clip(tmp / "dof_plain_DOF.y4m")[2]
    d = float(np.abs(out.astype(np.int16) - plain_out.astype(np.int16)).mean())
    expect(d <= 1.0, f"K6 and plain-DOF renders differ by mean |d| {d:.4f} u8")
    fps_k6 = runs["K6"]["fps"]
    say(f"PHASE render dof: {n_frames} frames 1920x1080 -> {ow}x{oh} Full-SBS, dof_strength "
        f"2, K6 runs {', '.join(f'{f:.2f}' for f in fps_k6)} fps, plain-DOF run "
        f"{runs['plain DOF']['fps'][0]:.2f} fps; K6 vs plain-DOF output mean |d| {d:.4f} u8 "
        f"[{card}]")
    say(f"PHASE render dof launches: {json.dumps(counts)}")
    prof = device_profile(lambda: render_stereo_video(clip, None, tmp / "dof_prof.y4m", params,
                                                      cfg, predictor=pred))
    say(f"PHASE render dof profile ({n_frames} frames, one more K6 run under torch.profiler, "
        f"against the faster K6 run's wall): {fmt_profile(prof, 1e3 * n_frames / max(fps_k6))} "
        f"[{card}]")
    return counts


def phase_depth(card: str, tmp: Path) -> dict:
    """Path B: render_depth_video_file over a 64-frame 1080p clip, batch 8,
    two timed runs with SDPA and two with the USE_VMEM_KERNEL opt-in (K7,
    12 launches per model call), one profiled run of each."""
    import numpy as np
    import torch

    from visiondepth3d_tpu_torch.kernels import launch_counts, reset_launch_counts
    from visiondepth3d_tpu_torch.ops import attention as attn_ops
    from visiondepth3d_tpu_torch.pipeline.depth_pipeline import (DepthConfig,
                                                                 render_depth_video_file)

    pred = da_predictor()
    cfg = DepthConfig(batch_size=8, dtype="bfloat16", device="cuda")
    n_frames = 64
    clip = tmp / "depth_1080p.y4m"
    write_clip(clip, W, H, n_frames)
    layers = pred.cfg.backbone.num_layers
    want_k7 = {"sdpa": 0, "K7": layers * -(-n_frames // cfg.batch_size)}
    walls, outs, counts_k7 = {}, {}, None
    try:
        for mode in ("sdpa", "K7"):
            attn_ops.USE_VMEM_KERNEL = mode == "K7"
            render_depth_video_file(warm_clip(tmp), tmp / "depth_warm.y4m", cfg, predictor=pred)
            torch.cuda.synchronize()
            walls[mode], counts = [], None
            for _ in range(2):
                reset_launch_counts()
                t0 = time.perf_counter()
                n = render_depth_video_file(clip, tmp / f"depth_{mode}.y4m", cfg, predictor=pred)
                torch.cuda.synchronize()
                walls[mode].append(time.perf_counter() - t0)
                run_counts = dict(launch_counts)
                expect(counts is None or run_counts == counts,
                       f"launch counts differ between runs: {counts} then {run_counts}")
                counts = run_counts
            expect(n == n_frames, f"depth route wrote {n} frames, want {n_frames}")
            expect(counts["vmem_attention"] == want_k7[mode],
                   f"{mode}: K7 launched {counts['vmem_attention']} times, want {want_k7[mode]}")
            others = {k: v for k, v in counts.items() if k != "vmem_attention" and v}
            expect(not others, f"the depth route launched other kernels: {others}")
            ow, oh, out = read_clip(tmp / f"depth_{mode}.y4m")
            outs[mode] = out[..., 0]  # a gray video: R = G = B through Y4M's YUV
            expect((ow, oh) == (W, H) and out.shape[0] == n_frames,
                   f"depth output {ow}x{oh} with {outs[mode].shape[0]} frames")
            expect(float(outs[mode].std()) > 1.0, f"{mode} depth output is flat")
            say(f"PHASE depth {mode}: {n_frames} frames 1920x1080, DA-V2-S 518 bf16 fast head, "
                f"batch {cfg.batch_size}, 2 runs: "
                f"{', '.join(f'{n_frames / w:.2f}' for w in walls[mode])} fps end to end, "
                f"K7 launches per run {counts['vmem_attention']} [{card}]")
            prof = device_profile(lambda: render_depth_video_file(
                clip, tmp / f"depth_{mode}_prof.y4m", cfg, predictor=pred))
            say(f"PHASE depth {mode} profile (one more run under torch.profiler, against the "
                f"faster run's wall): {fmt_profile(prof, 1e3 * min(walls[mode]))} [{card}]")
            if mode == "K7":
                counts_k7 = counts
    finally:
        attn_ops.USE_VMEM_KERNEL = False
    # the two bf16 routes against each other and against the same route in
    # float32 (SDPA, TF32 off): two bf16 attentions round at other places,
    # and the random-weight ViT and the per-frame percentile stretch amplify
    # that, so K7 is held to be no further from float32 than SDPA is
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        render_depth_video_file(clip, tmp / "depth_f32.y4m",
                                DepthConfig(batch_size=8, device="cuda"),
                                predictor=da_predictor("cuda", "float32"))
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    ref = read_clip(tmp / "depth_f32.y4m")[2][..., 0]

    def mean_d(a, b):
        return float(np.abs(a.astype(np.int16) - b.astype(np.int16)).mean())

    d = mean_d(outs["sdpa"], outs["K7"])
    d_sdpa, d_k7 = mean_d(outs["sdpa"], ref), mean_d(outs["K7"], ref)
    # SSIM on the first frame of each batch (full-frame SSIM of all 64 costs a minute)
    ssim = min(ssim_gray(a, b) for a, b in zip(outs["sdpa"][::cfg.batch_size],
                                                outs["K7"][::cfg.batch_size]))
    say(f"PHASE depth: bf16 outputs SDPA vs K7 mean |d| {d:.4f} u8, min SSIM {ssim:.5f} over "
        f"every {cfg.batch_size}th frame (need >= 0.99); against the float32 SDPA route: SDPA "
        f"{d_sdpa:.4f} u8, K7 {d_k7:.4f} u8 (need K7 <= SDPA + 0.25)")
    expect(ssim >= 0.99 and d_k7 <= d_sdpa + 0.25,
           f"K7 depth output: SSIM {ssim:.5f} to SDPA, {d_k7:.4f} u8 from float32 against "
           f"SDPA's {d_sdpa:.4f}")
    return counts_k7


def ssim_gray(a, b) -> float:
    """Mean SSIM of two u8 RGB frames on their luma, or of two gray frames
    (7x7 box windows)."""
    import numpy as np

    def box(x, k=7):
        c = np.cumsum(np.cumsum(np.pad(x, ((1, 0), (1, 0))), 0), 1)
        return (c[k:, k:] - c[:-k, k:] - c[k:, :-k] + c[:-k, :-k]) / (k * k)

    wts = np.array([0.299, 0.587, 0.114])
    x, y = ((f.astype(np.float64) @ wts) if f.ndim == 3 else f.astype(np.float64)
            for f in (a, b))
    c1, c2 = (0.01 * 255) ** 2, (0.03 * 255) ** 2
    mx, my = box(x), box(y)
    vx, vy = box(x * x) - mx * mx, box(y * y) - my * my
    cxy = box(x * y) - mx * my
    s = ((2 * mx * my + c1) * (2 * cxy + c2)) / ((mx * mx + my * my + c1) * (vx + vy + c2))
    return float(s.mean())


def phase_parity(card: str, tmp: Path):
    """The same small runs on the CPU (plain versions) and on the card: the
    render without and with depth of field (K1-K4, and K6) and in each other
    output format, and the depth route with the attention opt-in (K7)."""
    import numpy as np
    import torch

    from visiondepth3d_tpu_torch.kernels import launch_counts, reset_launch_counts
    from visiondepth3d_tpu_torch.ops import attention as attn_ops
    from visiondepth3d_tpu_torch.pipeline.depth_pipeline import (DepthConfig,
                                                                 render_depth_video_file)
    from visiondepth3d_tpu_torch.pipeline.stereo_pipeline import (
        RenderConfig, render_stereo_video)
    from visiondepth3d_tpu_torch.stereo.params import StereoParams

    # float32 depth model on both sides, TF32 off: the comparison is about
    # the hand kernels, not about matmul rounding in the random ViT
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    clip = tmp / "small.y4m"
    write_clip(clip, 256, 144, 4)

    def render(device, params, out, fmt="Full-SBS", bgr=False):
        cfg = RenderConfig(output_format=fmt, anaglyph_bgr_convention=bgr,
                           preserve_original_aspect=True, chunk_size=4, device=device)
        render_stereo_video(clip, None, out, params, cfg,
                            predictor=da_predictor(device, "float32"))

    def depth_route(device, out):
        attn_ops.USE_VMEM_KERNEL = True
        try:
            render_depth_video_file(clip, out, DepthConfig(batch_size=4, device=device),
                                    predictor=da_predictor(device, "float32"))
        finally:
            attn_ops.USE_VMEM_KERNEL = False

    base = StereoParams(enable_healing=True, image_dtype="bfloat16")
    cases = (
        ("render", lambda dev, out: render(dev, base, out), RENDER_KERNELS, (4, 144, 512, 3)),
        ("render dof", lambda dev, out: render(dev, base.replace(dof_strength=2.0), out),
         RENDER_KERNELS + DOF_KERNELS, (4, 144, 512, 3)),
        ("depth K7", depth_route, DEPTH_KERNELS, (4, 144, 256, 3)),
    )
    # the other output formats (preserve-aspect geometry of a 256x144 clip)
    shapes = {"Half-SBS": (4, 144, 256, 3), "VR": (4, 1600, 2880, 3),
              "Red-Cyan Anaglyph": (4, 144, 256, 3), "Passive Interlaced": (4, 144, 256, 3)}
    cases += tuple((f"render {fmt}{' BGR' if bgr else ''}",
                    lambda dev, out, fmt=fmt, bgr=bgr: render(dev, base, out, fmt, bgr),
                    RENDER_KERNELS, shapes[fmt]) for fmt, bgr in SURFACE_FORMATS)
    for name, run, kernels, shape in cases:
        outs = {}
        for device in ("cpu", "cuda"):
            out = tmp / f"parity_{name.replace(' ', '_')}_{device}.y4m"
            reset_launch_counts()
            run(device, out)
            if device == "cuda":
                torch.cuda.synchronize()
                expect(all(launch_counts[k] > 0 for k in kernels),
                       f"card {name} skipped a kernel: {launch_counts}")
            else:
                expect(not any(launch_counts.values()), f"CPU {name} launched a kernel")
            outs[device] = read_clip(out)[2]
        a, b = outs["cpu"], outs["cuda"]
        expect(a.shape == b.shape == shape, f"{name} shapes {a.shape} {b.shape}")
        mean = float(np.abs(a.astype(int) - b.astype(int)).mean())
        ssim = min(ssim_gray(x, y) for x, y in zip(a, b))
        say(f"PHASE parity {name}: 256x144 x4 frames, CPU plain vs card kernels "
            f"({', '.join(kernels)}): mean |d| {mean:.4f} u8 (need <= 1), min SSIM {ssim:.5f} "
            f"(need >= 0.99)")
        expect(mean <= 1.0 and ssim >= 0.99, f"CPU and card {name} runs disagree")


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
        f"run's wall): {fmt_profile(prof, 1e3 * min(walls))}{fmt_cat(prof)} [{card}]")

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
        prof = device_profile(f)
        say(f"PHASE tools layers {name} ({TOOLS_CHUNK + 1}-frame chunk, wall = host-gated "
            f"span, mean of 3 back-to-back): {fmt_profile(prof, span)}{fmt_cat(prof)} [{card}]")
        if name == "esrgan trunk" and prof is not None:
            expect(prof["cat_ms"] == 0.0,
                   f"the ESRGAN trunk ran concatenation kernels ({prof['cat_ms']:.3f} ms)")
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


# the surface phase's formats: (format, anaglyph BGR convention)
SURFACE_FORMATS = (("Half-SBS", False), ("VR", False), ("Red-Cyan Anaglyph", False),
                   ("Red-Cyan Anaglyph", True), ("Passive Interlaced", False))
# K1-K4 launches per rendered frame on every format
PER_FRAME = {"stereo_warp": 1, "feather_heal": 1, "quantile_pair": 2, "subject_stats": 3}


def counted_render(clip, out, params, cfg, predictor, n_frames: int, what: str, **kw):
    """One render with the launch counts zeroed just before it and read just
    after; K1-K4 gated per frame, no other kernel. Returns (wall s, progress)."""
    import torch

    from visiondepth3d_tpu_torch.kernels import launch_counts, reset_launch_counts
    from visiondepth3d_tpu_torch.pipeline.stereo_pipeline import render_stereo_video

    reset_launch_counts()
    t0 = time.perf_counter()
    prog = render_stereo_video(clip, None, out, params, cfg, predictor=predictor, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(launch_counts)
    want = {k: (PER_FRAME.get(k, 0) * n_frames) for k in counts}
    expect(counts == want, f"{what}: launches {counts}, want {want} ({n_frames} frames)")
    return wall, prog


def phase_surface(card: str, tmp: Path):
    """The render configuration of phase render in the other output formats,
    with blank frames, with a black-bar crop, and cancelled and resumed."""
    import numpy as np
    import torch

    from visiondepth3d_tpu_torch.io import blackdetect, open_video
    from visiondepth3d_tpu_torch.pipeline.geometry import resolve_geometry
    from visiondepth3d_tpu_torch.pipeline.resume import checkpoint_path
    from visiondepth3d_tpu_torch.pipeline.stereo_pipeline import (RenderConfig,
                                                                  _detect_black_bars_host)
    from visiondepth3d_tpu_torch.stereo.params import StereoParams

    pred = da_predictor()
    params = StereoParams(enable_healing=True, image_dtype="bfloat16")
    base = RenderConfig(output_format="Full-SBS", output_height=1080, chunk_size=16,
                        device="cuda")
    n = 16
    clip = tmp / "surface_1080p.y4m"
    write_clip(clip, W, H, n)
    for fmt, bgr in SURFACE_FORMATS:
        cfg = dataclasses.replace(base, output_format=fmt, anaglyph_bgr_convention=bgr)
        tag = fmt.replace(" ", "_") + ("_bgr" if bgr else "")
        out = tmp / f"surface_{tag}.y4m"
        counted_render(warm_clip(tmp), tmp / "surface_warm.y4m", params, cfg, pred, 16,
                       f"{tag} warm-up")
        wall, _ = counted_render(clip, out, params, cfg, pred, n, tag)
        geom = resolve_geometry(W, H, fmt, 1080)
        ow, oh, frames = read_clip(out)
        expect((ow, oh) == (geom.out_w, geom.out_h) and frames is not None
               and frames.shape[0] == n and float(frames.std()) > 1.0,
               f"{tag}: output {ow}x{oh} with {0 if frames is None else frames.shape[0]} "
               f"frames, want {geom.out_w}x{geom.out_h} x {n}, not flat")
        prof = device_profile(lambda: counted_render(clip, tmp / "surface_prof.y4m", params,
                                                     cfg, pred, n, f"{tag} profiled"))
        say(f"PHASE surface {fmt}{' (BGR convention)' if bgr else ''}: {n} frames 1920x1080 "
            f"-> {ow}x{oh}, {n / wall:.2f} fps end to end, launches per frame "
            f"{json.dumps(PER_FRAME)}; profiled run: {fmt_profile(prof, 1e3 * wall)} [{card}]")
        del frames

    # blank frames 5-9 in Full-SBS: both eyes carry the same source
    blank_clip = tmp / "blank_1080p.y4m"
    write_clip(blank_clip, W, H, n, blank=range(5, 10))
    cfg = dataclasses.replace(base, skip_blank_frames=True)
    wall, _ = counted_render(blank_clip, tmp / "blank_sbs.y4m", params, cfg, pred, n,
                             "blank frames")
    detector = "ffmpeg blackdetect" if blackdetect.ff.have_ffmpeg() else "frame scan"
    blank = set(blackdetect.detect_blank_frames(str(blank_clip), 24.0))  # the render's cache
    expect(set(range(5, 10)) <= blank, f"blank frames detected {sorted(blank)}, want 5-9")
    planes = read_planes(tmp / "blank_sbs.y4m")
    equal = [all(np.array_equal(p[i, :, : p.shape[2] // 2], p[i, :, p.shape[2] // 2:])
                 for p in planes) for i in range(n)]
    expect(all(equal[i] == (i in blank) for i in range(n)),
           f"halves equal on frames {[i for i in range(n) if equal[i]]}, blank {sorted(blank)}")
    expect(not equal[4] and not equal[max(blank) + 1],
           "the frames before and after the blank run have equal halves")
    say(f"PHASE surface blank frames: {n} frames Full-SBS, blank {sorted(blank)} ({detector}): "
        f"left half == right half bit for bit (Y, U, V) on exactly those frames, "
        f"{n / wall:.2f} fps [{card}]")
    del planes

    # letterbox: 138 black rows top and bottom, cropped before the aspect crop
    bars_clip = tmp / "bars_1080p.y4m"
    write_clip(bars_clip, W, H, n, bars=138)
    with open_video(bars_clip) as rd:
        top, bottom = _detect_black_bars_host(rd.read())
    expect((top, bottom) == (138, 138), f"black bars detected {(top, bottom)}, want (138, 138)")
    geom = resolve_geometry(W, H, "Full-SBS", 1080, crop_black_top=top, crop_black_bottom=bottom)
    cfg = dataclasses.replace(base, auto_crop_black_bars=True)
    counted_render(bars_clip, tmp / "bars_sbs.y4m", params, cfg, pred, n, "black-bar crop")
    y = read_planes(tmp / "bars_sbs.y4m")[0]
    rows = y[:, :, : W].mean(axis=(0, 2))  # the left eye's rows
    expect(y.shape == (n, geom.out_h, geom.out_w) and rows[:8].min() > 10
           and rows[-8:].min() > 10,
           f"black-bar crop: output {y.shape}, top rows {rows[:8].min():.1f} bottom rows "
           f"{rows[-8:].min():.1f} (want luma > 10: the bars cropped away)")
    say(f"PHASE surface black bars: detected (top, bottom) = ({top}, {bottom}) on the first "
        f"frame; crop x {geom.crop_x} y {geom.crop_y} {geom.crop_w}x{geom.crop_h} -> "
        f"{geom.out_w}x{geom.out_h}; output rows nearest the bars: luma "
        f"{rows[:8].min():.1f} / {rows[-8:].min():.1f} [{card}]")
    del y

    # resume: cancelled after its second chunk, continued from the sidecar
    n_resume = 48
    res_clip = tmp / "resume_1080p.y4m"
    write_clip(res_clip, W, H, n_resume)
    cfg = dataclasses.replace(base, checkpoint_every_chunks=1)
    counted_render(res_clip, tmp / "resume_full.y4m", params, cfg, pred, n_resume, "unbroken")
    calls = {"n": 0}

    def cancel():
        calls["n"] += 1
        return calls["n"] > 2

    part = tmp / "resume_part.y4m"
    counted_render(res_clip, part, params, cfg, pred, 32, "cancelled", cancel_check=cancel)
    expect(checkpoint_path(part).exists(), "the cancelled render left no checkpoint")
    _, prog = counted_render(res_clip, part, params, dataclasses.replace(cfg, resume=True),
                             pred, 16, "resumed")
    same = filecmp.cmp(part, tmp / "resume_full.y4m", shallow=False)
    if not same:
        a, b = read_planes(part)[0], read_planes(tmp / "resume_full.y4m")[0]
        diff = [i for i in range(min(len(a), len(b))) if not np.array_equal(a[i], b[i])]
        raise PhaseError(f"resumed render differs from the unbroken one: {len(a)} vs {len(b)} "
                         f"frames, Y differs on frames {diff[:8]}")
    expect(prog.frames_done == n_resume and not checkpoint_path(part).exists(),
           f"resumed render: {prog.frames_done} frames, checkpoint left behind")
    say(f"PHASE surface resume: {n_resume}-frame Full-SBS render cancelled after 2 chunks "
        f"(32 frames, checkpoint every chunk), resumed from frame 32: byte-identical to the "
        f"unbroken render ({os.path.getsize(part)} bytes) [{card}]")
    torch.cuda.empty_cache()


def phase_catalog(card: str, tmp: Path):
    """Depth Anything V2-Large through the fused 1080p render; V2-Base and
    V2-Large through the depth route with the K7 opt-in; V2-Large in float32
    on the CPU against the card."""
    import numpy as np
    import torch

    from visiondepth3d_tpu_torch.kernels import launch_counts, reset_launch_counts
    from visiondepth3d_tpu_torch.ops import attention as attn_ops
    from visiondepth3d_tpu_torch.pipeline.depth_pipeline import (DepthConfig,
                                                                 make_depth_batch_fn,
                                                                 render_depth_video_file)
    from visiondepth3d_tpu_torch.pipeline.stereo_pipeline import RenderConfig
    from visiondepth3d_tpu_torch.stereo.params import StereoParams

    large = "depth-anything-v2-large"
    pred = da_predictor("cuda", "bfloat16", large)
    params = StereoParams(enable_healing=True, image_dtype="bfloat16")
    cfg = RenderConfig(output_format="Full-SBS", output_height=1080, chunk_size=16,
                       device="cuda")
    n = 32
    clip = tmp / "catalog_1080p.y4m"
    write_clip(clip, W, H, n)
    counted_render(warm_clip(tmp), tmp / "catalog_warm.y4m", params, cfg, pred, 16,
                   "V2-Large warm-up")
    torch.cuda.reset_peak_memory_stats()
    walls = [counted_render(clip, tmp / "catalog_sbs.y4m", params, cfg, pred, n,
                            "V2-Large render")[0] for _ in range(2)]
    peak = torch.cuda.max_memory_allocated()
    ow, oh, out = read_clip(tmp / "catalog_sbs.y4m")
    expect((ow, oh) == (2 * W, H) and out.shape[0] == n, f"V2-Large output {ow}x{oh}")
    halves = float(abs(out[:, :, :W].astype(int) - out[:, :, W:].astype(int)).mean())
    expect(halves > 0.1, f"V2-Large render: identical halves (mean |L-R| {halves})")
    del out
    prof = device_profile(lambda: counted_render(clip, tmp / "catalog_prof.y4m", params, cfg,
                                                 pred, n, "V2-Large profiled"))
    per_frame = "not measured" if prof is None else f"{prof['device_ms'] / n:.3f} ms"
    say(f"PHASE catalog render: DA-V2-Large (24 layers, 1024 wide, 16 heads) 518^2 bf16 fast "
        f"head, {n} frames 1920x1080 -> {ow}x{oh} Full-SBS, chunks of 16, 2 runs: "
        f"{', '.join(f'{n / w:.2f}' for w in walls)} fps end to end, device time per frame "
        f"{per_frame}, launches per frame {json.dumps(PER_FRAME)}, mean |L-R| {halves:.2f}, "
        f"peak allocated {peak / 2**30:.3f} GiB; profiled run: "
        f"{fmt_profile(prof, 1e3 * min(walls))} [{card}]")

    # the depth route at ViT-B and ViT-L widths with the K7 opt-in
    dclip = tmp / "catalog_depth_1080p.y4m"
    n_depth = 16
    write_clip(dclip, W, H, n_depth)
    dcfg = DepthConfig(batch_size=8, dtype="bfloat16", device="cuda")
    try:
        attn_ops.USE_VMEM_KERNEL = True
        for model in ("depth-anything-v2-base", large):
            dpred = da_predictor("cuda", "bfloat16", model)
            layers = dpred.cfg.backbone.num_layers
            render_depth_video_file(warm_clip(tmp), tmp / "catalog_depth_warm.y4m", dcfg,
                                    predictor=dpred)
            torch.cuda.synchronize()
            reset_launch_counts()
            t0 = time.perf_counter()
            got = render_depth_video_file(dclip, tmp / "catalog_depth.y4m", dcfg, predictor=dpred)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = dict(launch_counts)
            calls = -(-n_depth // dcfg.batch_size)
            want = {k: (layers * calls if k == "vmem_attention" else 0) for k in counts}
            expect(got == n_depth and counts == want,
                   f"{model} depth route: {got} frames, launches {counts}, want {want}")
            ow, oh, dout = read_clip(tmp / "catalog_depth.y4m")
            expect((ow, oh) == (W, H) and float(dout[..., 0].std()) > 1.0,
                   f"{model} depth output {ow}x{oh} flat or misshapen")
            say(f"PHASE catalog depth {model}: {n_depth} frames 1920x1080, 518^2 bf16 fast "
                f"head, batch 8, K7 opt-in ({dpred.cfg.backbone.num_heads} heads): "
                f"{n_depth / wall:.2f} fps, K7 launches {counts['vmem_attention']} "
                f"({layers} per model call x {calls}) [{card}]")
            if model != large:
                drop_predictors(model)
    finally:
        attn_ops.USE_VMEM_KERNEL = False

    # one 518^2 frame through V2-Large in float32: CPU against the card
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        frame = (smooth_frame(torch.Generator().manual_seed(11), 518, 518, "cpu") * 255
                 ).round().to(torch.uint8)[None]
        depth = {}
        for device in ("cpu", "cuda"):
            fpred = da_predictor(device, "float32", large)
            fn = make_depth_batch_fn(fpred, DepthConfig(device=device), (518, 518))
            depth[device] = fn(frame.to(device)).cpu().numpy().astype(np.int16)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
        drop_predictors(large)
    d = float(np.abs(depth["cpu"] - depth["cuda"]).mean())
    expect(depth["cpu"].std() > 1.0 and d <= 1.0,
           f"V2-Large float32 depth: CPU vs card mean |d| {d:.4f} u8 (need <= 1)")
    say(f"PHASE catalog parity: DA-V2-Large 518^2 float32 (TF32 off), one frame, CPU vs card "
        f"after the depth route's u8 rounding: mean |d| {d:.4f} u8 (need <= 1), max "
        f"{int(np.abs(depth['cpu'] - depth['cuda']).max())} [{card}]")



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
    for sub, extra, want in (("render", ["--dof_strength", "2", "--allow-random",
                                         "--preserve-aspect", "--chunk-size", "4"], (512, 144)),
                             ("depth", ["--allow-random-weights"], (256, 144))):
        out = tmp / f"cli_{sub}_extra.y4m"
        cmd = [sys.executable, "-m", "visiondepth3d_tpu_torch", sub, "--input", str(clip),
               "--output", str(out), "--device", "cuda", *extra]
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=600, cwd=ROOT)
        expect(res.returncode == 0, f"{sub} CLI rc={res.returncode}: {res.stderr[-2000:]}")
        w, h, frames = read_clip(out)
        expect((w, h) == want and frames is not None and frames.shape[0] == 4,
               f"{sub} CLI output {w}x{h} with {0 if frames is None else frames.shape[0]} "
               f"frames")
        say(f"PHASE cli: vd3d-torch {sub} {' '.join(extra)} -> {w}x{h}, {frames.shape[0]} "
            f"frames")
    # the new render flags: an anaglyph, a builtin preset's dry run, and a
    # control file that cancels once the first frames are in the output
    out = tmp / "cli_anaglyph.y4m"
    cmd = [sys.executable, "-m", "visiondepth3d_tpu_torch", "render", "--input", str(clip),
           "--allow-random", "--device", "cuda", "--output", str(out), "--preserve-aspect",
           "--chunk-size", "4", "--format", "Red-Cyan Anaglyph"]
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=600, cwd=ROOT)
    expect(res.returncode == 0, f"anaglyph CLI rc={res.returncode}: {res.stderr[-2000:]}")
    w, h, frames = read_clip(out)
    expect((w, h) == (256, 144) and frames is not None and frames.shape[0] == 4,
           f"anaglyph CLI output {w}x{h} with {0 if frames is None else frames.shape[0]} frames")
    say(f"PHASE cli: vd3d-torch render --format 'Red-Cyan Anaglyph' -> {w}x{h}, "
        f"{frames.shape[0]} frames")
    cmd = [sys.executable, "-m", "visiondepth3d_tpu_torch", "render", "--input", str(clip),
           "--preset", "best3d", "--dry-run", "--device", "cuda"]
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=600, cwd=ROOT)
    expect(res.returncode == 0, f"dry-run CLI rc={res.returncode}: {res.stderr[-2000:]}")
    dry = json.loads(res.stdout)
    expect(dry["params"]["fg_shift"] == 12.0 and dry["params"]["blur_ksize"] == 9.0
           and dry["output"].endswith("_Full-SBS.y4m"), f"dry-run JSON {res.stdout[:400]}")
    say(f"PHASE cli: vd3d-torch render --preset best3d --dry-run -> {len(dry['params'])} "
        f"parameters (fg_shift {dry['params']['fg_shift']}), output {Path(dry['output']).name}")
    long_clip, ctl, out = tmp / "cli_long.y4m", tmp / "cli_control", tmp / "cli_control.y4m"
    n_long = 64
    write_clip(long_clip, 256, 144, n_long)
    ctl.write_text("run")
    cmd = [sys.executable, "-m", "visiondepth3d_tpu_torch", "render", "--input",
           str(long_clip), "--allow-random", "--device", "cuda", "--output", str(out),
           "--preserve-aspect", "--chunk-size", "1", "--control", str(ctl)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            cwd=ROOT)
    try:
        header, record = 0, 6 + 512 * 144 * 3 // 2
        deadline = time.time() + 600
        while proc.poll() is None and time.time() < deadline:
            if out.exists() and not header:
                with open(out, "rb") as f:
                    line = f.readline()
                header = len(line) if line.endswith(b"\n") else 0
            if header and os.path.getsize(out) >= header + record:
                ctl.write_text("cancel")  # the first frame is out
                break
            time.sleep(0.002)
        _, err = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    expect(proc.returncode == 0, f"control CLI rc={proc.returncode}: {err[-2000:]}")
    w, h, frames = read_clip(out)
    got = 0 if frames is None else frames.shape[0]
    expect((w, h) == (512, 144) and 1 <= got < n_long,
           f"control CLI output {w}x{h} with {got} frames, want 1..{n_long - 1} (cancelled)")
    say(f"PHASE cli: vd3d-torch render --control FILE: 'cancel' written once the first frame "
        f"was in the output; stopped after {got} of {n_long} frames -> {w}x{h}")
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
                    help=f"comma list of {','.join(ALL_PHASES + OPTIONAL_PHASES)}")
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
    phases = set(args.phases.split(",")) if args.phases != "all" else set(ALL_PHASES)
    unknown = phases - set(ALL_PHASES + OPTIONAL_PHASES)
    if unknown:
        print(f"chip_smoke: unknown phases {sorted(unknown)}", file=sys.stderr)
        return 2
    try:
        def timed(name, fn, *a):
            t0 = time.perf_counter()
            out = fn(*a)
            say(f"PHASE {name} took {time.perf_counter() - t0:.1f} s")
            return out

        card = phase_card()
        timed("build", phase_build)
        kernels = timed("kernels", phase_kernels, card) if "kernels" in phases else {}
        if "k2shapes" in phases:
            timed("k2shapes", phase_k2_shapes, card)
        counts = {}
        with tempfile.TemporaryDirectory(prefix="vd3d_smoke_") as td:
            tmp = Path(td)
            # each main path, with the kernels whose launches it counts
            for name, fn, path_kernels in (("render", phase_render, RENDER_KERNELS),
                                           ("dof", phase_render_dof, DOF_KERNELS),
                                           ("depth", phase_depth, DEPTH_KERNELS),
                                           ("tools", phase_tools, TOOLS_KERNELS)):
                if name in phases:
                    run_counts = timed(name, fn, card, tmp)
                    counts.update({k: run_counts[k] for k in path_kernels})
            for name, fn in (("surface", phase_surface), ("catalog", phase_catalog)):
                if name in phases:
                    timed(name, fn, card, tmp)
            if "parity" in phases:
                timed("parity", phase_parity, card, tmp)
                timed("parity tools", phase_tools_parity, tmp)
            if "cli" in phases:
                if "parity" not in phases:
                    write_clip(tmp / "small.y4m", 256, 144, 4)
                timed("cli", phase_cli, tmp)
        leaked = sorted(m for m in sys.modules if m.split(".")[0] in
                        ("jax", "jaxlib", "flax", "visiondepth3d_tpu"))
        expect(not leaked, f"the JAX package or jax was imported: {leaked}")
    except PhaseError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1

    # launches are counted on each main path (render: K1-K4, DOF render: K6,
    # depth route with the opt-in: K7, tools: K5); a kernel whose path did
    # not run has null launches
    product_dtype = {"stereo_warp": torch.bfloat16, "feather_heal": torch.bfloat16,
                     "conv3x3": torch.bfloat16, "dof_grade": torch.bfloat16,
                     "vmem_attention": torch.bfloat16}
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
