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
     function (K1: one F.grid_sample over both eyes, its layout copy timed
     apart), and the kernel's bound. A kernel's time is `runs` back-to-
     back launches captured in one CUDA graph and replayed between one
     CUDA-event pair, over `runs`; beside it the host loop of the same
     launches (the host launching each), one call's device operations
     counted from a CUDA-graph capture (the count the gates read), and its
     device time from torch.profiler where the profiler sees the card.
     Library calls are timed by graph replay too, plain versions by the
     host loop. An empty kernel timed both ways is the launch floor. K1-K4
     at the shapes of the 1080p render (1080x1920 frames, 648x1152 subject crop, and an unaligned crop;
     K3's and K4's band forms and finishes over 2 and 3 row bands, bit for
     bit against the one-shot kernels), K5 (the 3x3
     conv) in f32 and bf16 at five shapes of the frame-tools path and on
     the dense block's strided views (input a channel slice of the
     192-channel buffer, output written into a slice of it), K6 (DOF +
     grade) at 1080p, both eyes, dof_strength 2 and 5, all in focus and all
     out of focus, K7 (attention) at the depth model's shapes
     [16|8|2, 1370, 6, 64], ViT-B's and ViT-L's [8, 1370, 12|16, 64], a
     padded [2, 270, 3, 64], DPT-Large's and DPT-Hybrid's 384^2
     [8, 577, 16|12, 64] (bf16) and [2, 577, 16, 64] (f32), and the
     depth routes' shapes (bf16): Depth Pro's patch encoder at 1536^2 over
     8 frames [280, 577, 16, 64] (35 windows a frame), VDA-Small's 32-frame
     window [32, 1370, 6, 64], Marigold's UNet level 2 at 1080p
     [2, 2040, 20, 64] (34 x 60 latents, batch 2), and DepthCrafter's over
     a 24-frame window [24, 2040, 20, 64] (bf16 and f32), [8, 1370, 6, 64]
     in f32 too, each with SDPA's time on the same shape; K7's query-band
     form at the sp=2 depth route's bands ([8, 667 | 703, 6, 64] against
     1370 keys, bf16 and f32) against its plain version and against the
     same rows of the whole-sequence kernel (bit for bit). K5's and K7's
     float32 bounds take their operations as three TF32 products each at
     495 TFLOP/s ("operations, split TF32"), the other float32 bounds at
     the CUDA cores' 67 TFLOP/s;
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
     kernels (none in the ESRGAN trunk); one more timed run in float32 (the
     CLI's default type: K5's split-TF32 body) with its launches counted
     and K5's share of its device time;
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
     unbroken render; then the functions that complete the JAX package's
     surface (the one-image ops at 1080p, rife_apply and esrgan_apply at
     toy widths) on the card against the same calls on the CPU, within the
     CPU parity tests' gates, and the seconds that check took;
 10. (catalog) Depth Anything V2-Large (random weights from seed 0, 518^2,
     bf16, fast head) through the fused 1080p Full-SBS render (32 frames,
     chunks of 16; fps, device time, busy share, K1-K4 launches gated per
     frame); V2-Base and V2-Large through the depth route with the K7
     opt-in (16 frames, batch 8: 12 and 24 K7 launches per model call); one
     518^2 frame through V2-Large in float32 on the CPU and on the card
     (TF32 off), the route's u8 depth within a mean of 1 u8;
 11. (families) the other feed-forward families at their published widths
     (random weights from seed 0, bf16, fast head where the family has one)
     through the fused 1080p Full-SBS render, each at the first of its
     recommended sizes: DPT-Large at 384^2 (16 frames, two timed runs: fps,
     device time per frame, events, busy share, peak memory), then 16 frames
     each of DPT-BEiT-Large-512 at 512^2, DPT-Hybrid at 384^2, ZoeDepth NYU
     and NYU+KITTI at 384^2 and MiDaS v2.1-small at 384^2 (K1-K4 launches
     gated per frame, no K7, the output's shape, its halves differing);
     DPT-Large and DPT-Hybrid through the depth route with the K7 opt-in
     (16 frames, batch 8: 24 and 12 K7 launches per model call at N = 577);
     one frame of each of the six in float32 on the CPU and on the card
     (TF32 off), the route's u8 depth within a mean of 1 u8 and not flat;
 12. (routes) the models whose depth routes are ported last, at their
     published widths (random weights from seed 0, bf16): Depth Pro at
     1536^2 through the fused 1080p Full-SBS render (16 frames, chunks of
     16; fps, device time per frame, events, busy share, peak memory; K1-K4
     gated per frame, no K7) and through the depth route with the K7
     opt-in (8 frames, batch 8: 72 K7 launches, 24 layers of each of the
     three ViTs); VDA-Small at 518^2 through its depth route over a
     56-frame 1080p clip (two 32-frame windows) with SDPA and with K7 (12
     launches a window); Marigold (SD2 UNet, SD VAE) through its depth
     route over a 4-frame 1080p clip, batch 2, 4 DDIM steps, ensemble 1
     (a 135-row latent), with SDPA and with K7 (5 launches a UNet call, at
     the 34 x 60 level), with the SDPA backend of the VAE's [2, 32400, 1,
     512] mid attention; then one frame of each model in float32 on the
     CPU (plain versions) and on the card (TF32 off), the route's u8 depth
     within a mean of 1 u8 (Marigold with the same noise on both sides);
 13. (dcrafter) DepthCrafter at its published widths (random weights from
     seed 0, bf16: the ST-UNet 320/640/1280/1280, the SD VAE, CLIP ViT-H/14)
     through its depth route over a 60-frame 1080p clip (window 24, overlap
     6, segments of 42: two segments, three windows; 2 Euler steps), with
     SDPA and with K7 (5 launches a UNet call, at the 34 x 60 level: 30),
     the output's frame count and fps, s and device ms per frame, busy share,
     peak memory and the kernels with the most device time, then
     F.group_norm timed at the route's shapes; one reduced clip (256x144, 8 frames, window 6, overlap
     2) in float32 on the CPU and on the card with the same noise, mean |d|
     <= 1 u8 and SSIM >= 0.99; then a small ONNX depth net (written with
     write_onnx_graph) through the depth route as onnx: over a 16-frame
     1080p clip, whole and tiled, on the card (fps, no kernel launched),
     and its first 4 frames on the CPU and on the card within a mean of 1
     u8;
 14. (cli) the CLI once per subcommand: python -m visiondepth3d_tpu_torch
     render (also with --dof_strength 2, --format "Red-Cyan Anaglyph",
     --preset best3d --dry-run, and --control FILE with 'cancel' written
     once frames come out) / depth / tools ...
 15. (product) the product surface, in this process (the launch counts see
     it): DA-V2-Small's seeded random weights written as model.safetensors,
     `convert`ed through cli.main into a native local: folder (its tensors
     equal to the file's bit for bit), then 16 1080p frames rendered
     Full-SBS bf16 from the folder and from the file (state dicts equal,
     outputs byte-identical or within the run-to-run spread of the same
     render, K1-K4 16/16/32/48 in each), `convert --depth-in/--depth-out`
     round-tripping a .vd16 bit for bit; image-folder depth over 16 1080p
     PNGs (DA-V2-Small 518^2 bf16, batch 8) with the K7 opt-in (24 launches
     at [8, 1370, 6, 64]), with SDPA and with float32 SDPA (K7 no further
     from float32 than SDPA + 0.25 u8; images/s); `verify-checkpoints`
     over that file and a seeded Real-ESRGAN x4plus (both pass, the rest
     missing, K5 launched); `frames --extract/--assemble`, `scenes --split`
     (3 scenes), `--lang fr` and `dynamic_batch_size` on the card's memory;
     whether Pillow and matplotlib are installed;
 16. (serve) preview and serve, the surfaces users drive: render_preview
     in its ten modes on one 1080p frame on the card and on the CPU (float32,
     TF32 off; mean |d| <= 1 u8 and SSIM >= 0.99 per mode, K1-K4 1/1/2/3
     launches a render, ms per render cold and warm); serve_preview(port=0,
     max_renders=3) with two POST /update edits; then the job server on the
     card (run_in_thread) driven over HTTP: a fused 16-frame 1080p Full-SBS
     render from DA-V2-Small's seed-0 model.safetensors (byte-identical to
     `vd3d-torch render` of the same file and flags, K1-K4 16/16/32/48), the
     same with dof_strength 2 (K6 16), a depth job (518^2, bf16, batch 8,
     the K7 opt-in: 24 launches at [8, 1370, 6, 64]), a tools job (seeded
     full-width Real-ESRGAN x4plus and practical-RIFE .safetensors, bf16,
     960x540: K5), a scenes job, an audio job (done with ffmpeg, an error
     naming ffmpeg without it), and a 48-frame render paused and resumed
     beside a second one cancelled mid-clip (its .partial output holds as
     many frames as its progress says). Its launch counts go on their own
     `PHASE serve launches` line.
 17. (mesh) the mesh routes over [cuda:0, cuda:0] (one card twice, so the
     figures are the mesh's overhead, not its scaling): render_stereo_video
     with mesh="dp=2" in the render configuration over 32 1080p frames
     (each segment two whole chunks), byte-identical to the two segments
     rendered alone and concatenated, K1-K4 32/32/64/96, fps and device
     time per frame; mesh="pp=2" over 16 frames, byte-identical to the
     fused render, K1-K4 16/16/32/48; the depth route at dp=2 (16 frames,
     batch 8 split 4 + 4, the K7 opt-in: 48 launches at [4, 1370, 6, 64]),
     byte-identical to one device at batch 4 and within a mean of 1 u8 and
     SSIM 0.99 of one device at batch 8; frame tools at dp=2 (4 frames of
     960x540, bf16, chunks of 4 pairs, 2 per device), byte-identical to
     one device at chunks of 2 pairs, K5 launched;
     DepthCrafter's run_raw_parallel (phase dcrafter's pipeline, else built
     at the published widths; bf16, 2 steps) over 50 frames of 512x288 (3
     windows) at dp=2 against dp=1, min-max u8 within a mean of 1; then
     the row- and tensor-sharded meshes (mesh_sharded), each against its
     one-device twin: sp=2 (16 frames; the model on 8 frames a device, the
     stereo step in two row bands: K1, K2 once per band per frame, K3's
     and K4's band forms and finishes), with depth of field (K6 per band),
     dp=2,sp=2 (32 frames), pp=2,dp=2 (16), sp=2 at 3840x2160 (8 frames),
     byte for byte; the tp=2 depth route (K7 opt-in at [8, 1370, 3, 64])
     and the tp=2 render within their gates; then the depth route with the
     model row-sharded (mesh_sp_depth): sp=2 (16 frames, batch 8; SDPA and
     the K7 opt-in, whose query-band form launches 48 times at [8, 667 |
     703, 6, 64] against 1370 keys; bf16 and float32), dp=2,sp=2 and sp=2 at
     924^2 (4 frames, the peak memory), each within its gates of one device;
     and sp where the model is not row-sharded: DPT-Large 384^2 at sp=2
     (16 frames, K7 opt-in; the model on the group's first device) byte for
     byte against one device with the same K7 launches, DA-V2-S --tiled at
     sp=2 (8 frames, the tiles over two sub-groups, K7) in bf16 and float32
     within sp's gates of one device, DA-V2-S sp=2,tp=2 over the card four
     times (16 frames, K7) byte for byte against tp=2, and DepthCrafter's
     route at dp=2,sp=2 over the windows above byte for byte against dp=2;
 18. (train) the depth trainer: DA-V2-Small at 518^2, batch 4, float32, 5
     AdamW steps on one synthetic batch (the loss finite and descending,
     steps/s, peak GiB, no K7 launch; with the K7 opt-in the step raises);
     one step at 140^2, batch 2, TF32 off, on the card against the CPU
     (loss within 1e-4 relative, gradient within 1e-4 x max |g|); two DDP
     ranks (gloo, both on cuda:0, spawned), 2 steps of 2 + 2 frames,
     against one process on the 4 (losses within 1e-5 relative; the first
     gradient within 1e-6 x max |g| of the mean of the two halves'
     gradients taken in one process, and within 2e-5 x max |g| of the
     whole batch's; the weights' mean |d| within 1e-2 x lr); 5 steps at
     tp=2 over [cuda:0, cuda:0] (the ViT split Megatron-style) against 5
     on one device from the same weights, TF32 off: the first loss within
     1e-5 relative, the first gradient within 1e-5 x max |g|.

Optional, run only when named: (k2shapes) K2 built at other strip widths,
rows per step and CTAs per SM, each checked and timed against the default
at the render's shapes; (rifebatch) RIFE's in-betweens of the tools path
at 4 pairs per call against 2, whole and op by op on the same inputs.

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
import threading
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
# K3's and K4's band forms (the row-sharded renders): (band entry, finish entry)
BAND_ENTRIES = {"quantile_pair": ("quantile_hist_band", "quantile_pair_finish"),
                "subject_stats": ("subject_hist_band", "subject_stats_finish")}
DOF_KERNELS = ("dof_grade",)
DEPTH_KERNELS = ("vmem_attention",)
TOOLS_KERNELS = ("conv3x3",)
ALL_PHASES = ("card", "build", "kernels", "render", "dof", "depth", "tools", "surface",
              "catalog", "families", "routes", "dcrafter", "parity", "cli", "product", "serve",
              "mesh", "train")
OPTIONAL_PHASES = ("k2shapes", "rifebatch")  # run only when named
H, W = 1080, 1920

# H100 SXM peaks (NVIDIA data sheet; at the 700 W power limit): HBM bytes/s,
# dense bf16 tensor-core and float32 CUDA-core FLOP/s, and dense TF32
# tensor-core FLOP/s: K5's and K7's float32 bodies take each product as
# three TF32 products (split TF32), so their float32 peak is a third of it
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_TF32 = 495e12


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
                "conv3x3_tf32_kernel", "dof_grade_kernel", "attention_wgmma_kernel",
                "attention_tf32_kernel")

_PREDICTORS: dict = {}


def da_predictor(device: str = "cuda", dtype: str = "bfloat16",
                 model: str = "depth-anything-v2-small", size: int = 518):
    """A catalog model (Depth Anything V2-Small unless named) at size^2
    (518 unless given), fast head where the family has one, random weights
    from seed 0: one instance per (model, device, dtype, size), shared by
    the phases."""
    key = (model, device, dtype, size)
    if key not in _PREDICTORS:
        from visiondepth3d_tpu_torch.depth.registry import CATALOG, load_predictor

        expect(model in CATALOG, f"{model} is not in the port's catalog")
        _PREDICTORS[key] = load_predictor(model, None, inference_size=size, seed=0,
                                          dtype=dtype, device=device, fast_head=True)
    return _PREDICTORS[key]


def drop_predictors(model: str):
    """Free a model's predictors (the catalog phase's large ones)."""
    import torch

    for key in [k for k in _PREDICTORS if k[0] == model]:
        del _PREDICTORS[key]
    torch.cuda.empty_cache()


def bound(flops: float, nbytes: float, dtype: str,
          split_tf32: bool = False) -> tuple[float, str]:
    """The least time (ms) the card could take: the larger of the bytes over
    the memory rate and the operations over the peak rate of their type;
    with split_tf32 (K5's and K7's float32 bodies) three TF32 products per
    product at the TF32 rate."""
    t_bytes = nbytes / PEAK_BYTES
    t_ops = flops * 3 / PEAK_TF32 if split_tf32 else flops / PEAK_FLOPS[dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def bound_label(bound_by: str, split_tf32: bool) -> str:
    """How a bound is printed: "operations, split TF32" where the float32
    operations bound is the split-TF32 one."""
    return bound_by + (", split TF32" if split_tf32 and bound_by == "operations" else "")


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
    by_name: dict = {}
    for s, e, n in ivs:
        by_name[n] = by_name.get(n, 0.0) + (e - s) / 1e3
    return {"device_ms": sum(e - s for s, e, _ in ivs) / 1e3,
            "top": sorted(by_name.items(), key=lambda kv: -kv[1])[:8],
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


def warp_grid_inputs(frame, depth, shift):
    """K1's inputs laid out for F.grid_sample: the frame's RGB and the
    depth stacked as one NCHW image per eye ([2, 4, H, W]: the NHWC -> NCHW
    copy) and each eye's sampling grid ([2, H, W, 2] in align_corners=True
    coordinates: x = 2c / (W - 1) - 1 + shift for the left eye and - shift
    for the right, which is column c +- shift (W - 1) / 2; y on the row
    centres), in the frame's type."""
    import torch

    h, w = shift.shape
    stack = torch.cat([frame, depth[..., None]], dim=-1).permute(2, 0, 1)
    stack = stack[None].expand(2, -1, -1, -1).contiguous()
    col = torch.arange(w, device=shift.device, dtype=torch.float32) * (2.0 / (w - 1)) - 1.0
    row = torch.arange(h, device=shift.device, dtype=torch.float32) * (2.0 / (h - 1)) - 1.0
    gx = col[None, None, :] + torch.stack([shift, -shift]).float()
    grid = torch.stack([gx, row[None, :, None].expand(2, h, w)], dim=-1)
    return stack, grid.to(frame.dtype)


def warp_grid_sample(stack, grid):
    """K1's library yardstick: one F.grid_sample over both eyes (bilinear,
    border padding: the warp's clamp of the source column). Returns
    [2, 4, H, W]: the left and the right eye, RGB then depth."""
    import torch.nn.functional as F

    return F.grid_sample(stack, grid, mode="bilinear", padding_mode="border",
                         align_corners=True)


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
    # Library: one F.grid_sample over both eyes (warp_grid_sample) on the
    # NCHW stack of RGB and depth; its layout copy and grid build
    # (warp_grid_inputs) are timed apart from the call. Its grid is in the
    # image type, so in bf16 the source column is rounded to 8 bits.
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
        stack, grid = warp_grid_inputs(f, d, shift)
        lib_out = warp_grid_sample(stack, grid)
        lib_eyes = (lib_out[0, :3].permute(1, 2, 0), lib_out[1, :3].permute(1, 2, 0),
                    lib_out[0, 3], lib_out[1, 3])
        lib_err = max((a.float() - b.float()).abs().max().item() for a, b in zip(lib_eyes, ref))
        lib_ms = graph_ms(lambda: warp_grid_sample(stack, grid))
        layout_ms = graph_ms(lambda: warp_grid_inputs(f, d, shift))
        s = f.element_size()
        line = record("stereo_warp", dt, err, times, plain, 38 * H * W, H * W * (12 * s + 4),
                      library_ms=lib_ms)
        say(f"PHASE kernels stereo_warp {dt} max_abs_err={err:.3e} (tol {tol}) {line}; "
            f"library F.grid_sample [2, 4, {H}, {W}] max |d| from the plain version "
            f"{lib_err:.3e}, its NHWC -> NCHW copy and grid build {layout_ms:.4f} ms apart "
            f"(graph replay)")
        expect(err <= tol, f"stereo_warp {dt}: max |err| {err} > {tol}")
        del stack, grid, lib_out, lib_eyes

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
    band_kernels(card, depth, results, floor_note)
    del frame, depth, shift, base, left, right, dl, dr, args, got, ref, diff, crops, crop
    phase_conv_kernel(card, results)
    phase_dof_kernel(card, results)
    phase_attention_kernel(card, results)
    attention_band_kernel(card, results)
    return results


def band_kernels(card: str, depth, results: dict, floor_note: str):
    """K3's and K4's band forms, the statistics of a frame held as row bands
    (the sp and pp=2,dp>1 renders): the 1080p map cut into 2 and 3 bands
    (the 3-way cuts at rows 360 and 720 fall inside K4's crop, rows 216 to
    864), each band counted into its device's buffer, the buffers summed
    and finished; held bit for bit against the one-shot kernels and the
    plain band forms (the buffers too). Times by graph replay: a band
    kernel on the first of 2 bands (540 rows), a finish on the summed
    counts; plain versions by the host loop. Bound (bytes): a band reads
    its values once and writes its counts once (4097 or 4161 int32); a
    finish reads the counts and writes 2 or 66 float32. Stored under the
    K3 and K4 rows as their "band" entries."""
    import torch

    from visiondepth3d_tpu_torch.kernels import stats

    r0, r1, c0, c1 = H // 5, H * 4 // 5, W // 5, W * 4 // 5
    one_q = stats.quantile_pair_cuda(depth, 0.02, 0.98)
    one_s = stats.subject_stats_cuda(depth[r0:r1, c0:c1])
    host = depth.cpu()
    for cuts in ((0, 540, H), (0, 360, 720, H)):
        bands = list(zip(cuts[:-1], cuts[1:]))
        hist, hist_p, buf, buf_p = None, None, None, None
        for a, b in bands:
            hist = stats.quantile_hist_band_cuda(depth[a:b], hist if hist is not None else
                                                 torch.zeros(stats.QHIST_BINS, dtype=torch.int32,
                                                             device=depth.device))
            hist_p = stats.quantile_hist_band(host[a:b], hist_p)
            lo, hi = max(a, r0), min(b, r1)
            buf = stats.subject_hist_band(depth[lo:hi, c0:c1], buf)
            buf_p = stats.subject_hist_band(host[lo:hi, c0:c1], buf_p)
        q = stats.quantile_pair_finish_cuda(hist, H * W, 0.02, 0.98)
        subj = stats.subject_stats_finish_cuda(buf)
        plain_q = stats.quantile_pair_finish_torch(hist_p, H * W, 0.02, 0.98)
        plain_s = stats.subject_stats_finish_torch(buf_p)
        expect(torch.equal(hist.cpu(), hist_p) and torch.equal(buf.cpu(), buf_p),
               f"band counts over {cuts} differ from the plain band forms")
        expect(torch.equal(q, one_q) and torch.equal(q.cpu(), plain_q),
               f"quantile pair over bands {cuts}: {q.tolist()}, one-shot {one_q.tolist()}, "
               f"plain {plain_q.tolist()}")
        for part, a, b, c in zip(("hist", "count", "median"), subj, one_s, plain_s):
            expect(torch.equal(a, b) and torch.equal(a.cpu(), c),
                   f"subject stats over bands {cuts}: {part} {a} vs {b} vs {c}")
    band, crop_band = depth[:540], depth[r0:540, c0:c1]
    zq = torch.zeros(stats.QHIST_BINS, dtype=torch.int32, device=depth.device)
    zs = torch.zeros(stats.SUBJECT_BAND, dtype=torch.int32, device=depth.device)
    entries = {
        "quantile_pair": (
            lambda: stats.quantile_hist_band_cuda(band, zq),
            lambda: stats.quantile_hist_band_torch(band, torch.zeros_like(zq)),
            lambda: stats.quantile_pair_finish_cuda(hist, H * W, 0.02, 0.98),
            lambda: stats.quantile_pair_finish_torch(hist, H * W, 0.02, 0.98),
            4 * band.numel() + 4 * stats.QHIST_BINS, 4 * stats.QHIST_BINS + 8),
        "subject_stats": (
            lambda: stats.subject_hist_band_cuda(crop_band, zs),
            lambda: stats.subject_hist_band_torch(crop_band, torch.zeros_like(zs)),
            lambda: stats.subject_stats_finish_cuda(buf),
            lambda: stats.subject_stats_finish_torch(buf),
            4 * crop_band.numel() + 4 * stats.SUBJECT_BAND, 4 * stats.SUBJECT_BAND + 4 * 66),
    }
    for name, (band_fn, band_plain, fin_fn, fin_plain, band_bytes, fin_bytes) in entries.items():
        bt, ft = kernel_times(band_fn, runs=100), kernel_times(fin_fn, runs=100)
        entry = {"band_ms": bt["ms"], "band_bound_ms": bound(0, band_bytes, "float32")[0],
                 "plain_band_ms": time_ms(band_plain), "finish_ms": ft["ms"],
                 "finish_bound_ms": bound(0, fin_bytes, "float32")[0],
                 "plain_finish_ms": time_ms(fin_plain)}
        results[(name, torch.float32)]["band"] = entry
        rows = (f"{band.shape[0]} rows" if name == "quantile_pair"
                else f"rows {r0}-540 x {crop_band.shape[1]} of the crop")
        say(f"PHASE kernels {name} band forms bit-exact over 2 and 3 bands (against the one-shot "
            f"kernel and the plain band forms); band ({rows}): {fmt_times(bt)} plain "
            f"{entry['plain_band_ms']:.4f} ms bound {entry['band_bound_ms']:.6f} ms (bytes); "
            f"finish: {fmt_times(ft)} plain {entry['plain_finish_ms']:.4f} ms bound "
            f"{entry['finish_bound_ms']:.6f} ms (bytes); {floor_note} [{card}]")
        expect(bt["events"] == 1 and ft["events"] == 1,
               f"{name} band forms: {bt['events']} and {ft['events']} device operations a call")


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
            cmd = [_lib.find_nvcc(), *_lib.NVCC_FLAGS, "-shared", f"-DVD3D_K2_TW_BF16={tw}",
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


def phase_rife_batch(card: str, tmp: Path):
    """Whether RIFE's in-betweens depend on how many pairs share a call.
    The tools path's first 5 frames (ESRGAN x4 + blend at 960x540, the
    tools phase's seeded weights) as 4 pairs: the full IFNet at 4 pairs
    against 2 pairs (the first two) and against a second call of 4; then
    each op of the 4-pair call (every conv, PReLU, resize and flow warp) is
    called again on its own inputs cut to the first 2 pairs and repeated
    at 4, so an op's difference is its own and not one carried in from an
    earlier op. bf16 (the tools path's type) and f32."""
    import torch

    from visiondepth3d_tpu_torch.enhance import esrgan as esr_mod
    from visiondepth3d_tpu_torch.enhance import rife as rife_mod
    from visiondepth3d_tpu_torch.enhance.pipeline import _rife_model, make_enhance_fn

    dev = torch.device("cuda")
    clip = tmp / "rifebatch.y4m"
    write_clip(clip, TOOLS_W, TOOLS_H, 5)
    frames = torch.from_numpy(read_clip(clip)[2])
    for dtype, dt in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
        cfg, ep, rp = tools_models(dtype)
        up = make_enhance_fn(dataclasses.replace(cfg, use_rife=False), ep, None,
                             (TOOLS_H, TOOLS_W), dev)(frames.to(dev))
        x = up.to(dt) / 255.0
        model, state = _rife_model(cfg, rp)
        model.load_state_dict(state)
        model = model.to(device=dev, dtype=dt).eval()
        img0, img1 = x[:-1], x[1:]
        records = []  # (op, batch diff, repeat diff, max |output|)
        active = [False]

        def check(op, call, args, out):
            if not active[0] or out.shape[0] != 4:
                return
            active[0] = False
            try:
                half = call(*(a[:2] if torch.is_tensor(a) and a.shape[0] == 4 else a
                              for a in args))
                again = call(*args)
            finally:
                active[0] = True
            records.append((op, (out[:2].float() - half.float()).abs().max().item(),
                            (out.float() - again.float()).abs().max().item(),
                            out.float().abs().max().item()))

        def hook(mod, args, out, name=""):
            check(name, mod, args, out)

        handles = [m.register_forward_hook(lambda mod, a, o, n=n: hook(mod, a, o, n))
                   for n, m in model.named_modules()
                   if isinstance(m, (esr_mod.Conv3x3, rife_mod.StridedConv,
                                     rife_mod.TransposeConv, rife_mod.PReLU))]
        orig_resize, orig_warp = rife_mod._resize, rife_mod.flow_warp_batch

        def resize(t, hw):
            out = orig_resize(t, hw)
            check(f"resize {tuple(t.shape[1:3])}->{tuple(hw)}", orig_resize, (t, hw), out)
            return out

        def warp(t, flow):
            out = orig_warp(t, flow)
            check(f"flow_warp (max |flow| {flow.float().abs().max().item():.1f} px)",
                  orig_warp, (t, flow), out)
            return out

        rife_mod._resize, rife_mod.flow_warp_batch = resize, warp
        try:
            with torch.inference_mode():
                full = model(img0, img1, 0.5)
                active[0] = True
                model(img0, img1, 0.5)
                active[0] = False
                full2 = model(img0, img1, 0.5)
                half = model(img0[:2], img1[:2], 0.5)
                single = torch.cat([model(img0[i:i + 1], img1[i:i + 1], 0.5) for i in range(2)])
        finally:
            rife_mod._resize, rife_mod.flow_warp_batch = orig_resize, orig_warp
            for h in handles:
                h.remove()

        def dmax(a, b):
            return (a.float() - b.float()).abs().max().item()

        say(f"PHASE rifebatch {dtype}: IFNet at {TOOLS_W}x{TOOLS_H}, 4 pairs vs the first 2: "
            f"max |d| {dmax(full[:2], half):.6f}; vs 1 pair per call {dmax(full[:2], single):.6f}; "
            f"2 pairs vs 1 per call {dmax(half, single):.6f}; 4 pairs twice {dmax(full, full2):.6f}"
            f" [{card}]")
        moved = [r for r in records if r[1] > 0 or r[2] > 0]
        say(f"PHASE rifebatch {dtype}: {len(records)} op calls checked, {len(moved)} differ "
            f"between 4 and 2 pairs on the same inputs or between two calls of 4")
        for op, bd, rd, top in records:
            if bd > 0 or rd > 0:
                say(f"  {op}: 4 vs 2 pairs max |d| {bd:.6g}, 4 twice {rd:.6g}, max |out| {top:.4g}")
        for op, bd, rd, top in records:
            if op.startswith("flow_warp"):
                say(f"  {op}: 4 vs 2 pairs max |d| {bd:.6g}, max |out| {top:.4g}")


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
# ViT-L; [2, 270, 3, 64] pads 270 keys to whole 64-key tiles; N 577 is
# DPT-Large's (16 heads) and DPT-Hybrid's (12) 384^2, whose last query and
# key tile holds one valid row. The routes phase's: Depth Pro's patch
# encoder over 8 frames at 1536^2 (35 windows of 577 tokens each), VDA's
# 32-frame window at 518^2, Marigold's UNet level 2 (34 x 60 latents, 20
# heads) at 1080p with batch 2.
ATTN_SHAPES = (((16, 1370, 6, 64), "bfloat16"), ((8, 1370, 6, 64), "bfloat16"),
               ((8, 1370, 6, 64), "float32"),
               ((8, 1370, 12, 64), "bfloat16"), ((8, 1370, 16, 64), "bfloat16"),
               ((2, 1370, 6, 64), "float32"), ((2, 270, 3, 64), "bfloat16"),
               ((2, 270, 3, 64), "float32"), ((8, 577, 16, 64), "bfloat16"),
               ((8, 577, 12, 64), "bfloat16"), ((2, 577, 16, 64), "float32"),
               ((280, 577, 16, 64), "bfloat16"), ((32, 1370, 6, 64), "bfloat16"),
               ((2, 2040, 20, 64), "bfloat16"), ((24, 2040, 20, 64), "bfloat16"),
               ((24, 2040, 20, 64), "float32"))


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
            split = dt == torch.float32
            bound_ms, bound_by = bound(flops, nbytes, tname, split)
            if dt == torch.float32:
                ok, gate = err <= 1e-5, f"need max <= 1e-5: margin {1e-5 / max(err, 1e-12):.1f}x"
            else:
                ok, gate = err <= 1.6e-2 and mean <= 1e-3, "need max <= 1.6e-2, mean <= 1e-3"
            if shape in ((8, 1370, 6, 64), (2, 1370, 6, 64)):
                results[("vmem_attention", dt)] = dict(err=err, ms=ms, plain=plain,
                                                       bound_ms=bound_ms, bound_by=bound_by,
                                                       library_ms=library)
            say(f"PHASE kernels vmem_attention {list(shape)} {tname} max_abs_err={err:.3e} "
                f"mean_abs_err={mean:.3e} ({gate}) {fmt_times(times)} plain {plain:.4f} ms "
                f"library {library:.4f} ms (SDPA, graph replay) bound {bound_ms:.4f} ms "
                f"({bound_label(bound_by, split)}; {flops / ms / 1e9:.1f} TFLOP/s, "
                f"{100 * bound_ms / ms:.1f} % of the bound) [{card}]")
            expect(ok, f"vmem_attention {list(shape)} {tname}: max |err| {err}, mean {mean}")
            del q, k, v, qt, kt, vt
            torch.cuda.empty_cache()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


# K7's query-band form at the sp=2 depth route's bands (518^2, batch 8):
# band 0 is the cls token and patch rows 0-17 (667 tokens), band 1 rows
# 18-36 (703), each against the whole sequence's 1370 keys
ATTN_BAND = (8, 1370, 6, 64)
ATTN_BANDS = ((0, 667), (667, 1370))


def attention_band_kernel(card: str, results: dict):
    """K7's query-band form (q [B, Nq, H, D] against k, v [B, Nk, H, D]) at
    the sp=2 depth route's bands, bf16 and f32 (TF32 off): against its plain
    version at K7's gates, and against the same rows of the whole-sequence
    kernel (reported bit for bit, gated at K7's gates); times by graph
    replay, SDPA on the same band as the library call, and the bound:
    4 B H Nq Nk D operations, Q and O of the band and K, V of the whole
    sequence moved once. The JSON line carries band 1 ([8, 703, 6, 64]
    against 1370) in bf16 as K7's "band"."""
    import torch
    import torch.nn.functional as F

    from visiondepth3d_tpu_torch.kernels import attention as kattn

    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(8)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for tname in ("bfloat16", "float32"):
            dt = getattr(torch, tname)
            q, k, v = (torch.randn(ATTN_BAND, generator=gen, device=dev).to(dt)
                       for _ in range(3))
            whole = kattn.vmem_attention_cuda(q, k, v)
            for a, b in ATTN_BANDS:
                qb = q[:, a:b].contiguous()
                got = kattn.vmem_attention_cuda(qb, k, v)
                errs = {}
                for name, ref in (("plain", kattn.vmem_attention_torch(qb, k, v)),
                                  ("whole", whole[:, a:b])):
                    diff = (got.float() - ref.float()).abs()
                    errs[name] = (diff.max().item(), diff.mean().item())
                bitwise = bool(torch.equal(got, whole[:, a:b]))
                times = kernel_times(lambda: kattn.vmem_attention_cuda(qb, k, v))
                plain = time_ms(lambda: kattn.vmem_attention_torch(qb, k, v), warmup=1, runs=5)
                qt, kt, vt = qb.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
                library = graph_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt))
                bsz, nk, h, d = ATTN_BAND
                nq = b - a
                flops = 4.0 * bsz * h * nq * nk * d
                nbytes = 2 * bsz * (nq + nk) * h * d * q.element_size()
                split = dt == torch.float32
                bound_ms, bound_by = bound(flops, nbytes, tname, split)
                if dt == torch.float32:
                    ok = all(e[0] <= 1e-5 for e in errs.values())
                    gate = (f"need max <= 1e-5: margin {1e-5 / max(errs['plain'][0], 1e-12):.1f}x"
                            f"; bit for bit")
                else:
                    ok = all(e[0] <= 1.6e-2 and e[1] <= 1e-3 for e in errs.values())
                    gate = "need max <= 1.6e-2, mean <= 1e-3; bit for bit"
                if (a, b) == ATTN_BANDS[1]:
                    results[("vmem_attention_band", dt)] = dict(
                        shape=[bsz, nq, h, d], nk=nk, err=errs["plain"][0], ms=times["ms"],
                        plain=plain, bound_ms=bound_ms, bound_by=bound_by,
                        library_ms=library, bitwise=bitwise)
                say(f"PHASE kernels vmem_attention band {[bsz, nq, h, d]} against Nk {nk} "
                    f"(rows [{a}, {b})) {tname}: against its plain version max_abs_err="
                    f"{errs['plain'][0]:.3e} mean {errs['plain'][1]:.3e}, against rows "
                    f"[{a}, {b}) of the whole-sequence kernel max {errs['whole'][0]:.3e} "
                    f"mean {errs['whole'][1]:.3e}, bit for bit {bitwise} ({gate}) "
                    f"{fmt_times(times)} plain {plain:.4f} ms library {library:.4f} ms "
                    f"(SDPA on the band, graph replay) bound {bound_ms:.4f} ms "
                    f"({bound_label(bound_by, split)}; {flops / times['ms'] / 1e9:.1f} TFLOP/s, "
                    f"{100 * bound_ms / times['ms']:.1f} % of the bound) [{card}]")
                expect(ok and bitwise, f"vmem_attention band [{a}, {b}) {tname}: {errs}, "
                                       f"bit for bit {bitwise}")
                del qb, got, qt, kt, vt
            del q, k, v, whole
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
            tot = dict(err=0.0, ms=0.0, plain=0.0, library=0.0, flops=0.0, bytes=0.0,
                       bounds=0.0)
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
                split = dt == torch.float32
                bound_ms, bound_by = bound(flops, nbytes, tname, split)
                if dt == torch.float32:
                    ok = err <= 1e-4 * scale
                    gate = (f"need max <= 1e-4 * {scale:.3f}: margin "
                            f"{1e-4 * scale / max(err, 1e-12):.1f}x")
                else:
                    ok = err <= 8e-3 * scale and mean <= 1e-3 * scale
                    gate = f"need max <= 8e-3 and mean <= 1e-3 of {scale:.3f}"
                say(f"PHASE kernels conv3x3 {name} {list(shape)}->{o} {act} {dt} "
                    f"max_abs_err={err:.3e} mean_abs_err={mean:.3e} ({gate}) {fmt_times(times)} "
                    f"plain {plain:.4f} ms library {library:.4f} ms (graph replay) bound "
                    f"{bound_ms:.4f} ms ({bound_label(bound_by, split)}; "
                    f"{flops / ms / 1e9:.1f} TFLOP/s, {100 * bound_ms / ms:.1f} % of the bound) "
                    f"[{card}]")
                expect(ok, f"conv3x3 {name} {dt}: max |err| {err}, mean {mean}, max |ref| {scale}")
                for k, v in (("err", err), ("ms", ms), ("plain", plain), ("library", library),
                             ("flops", flops), ("bytes", nbytes), ("bounds", bound_ms)):
                    tot[k] = max(tot[k], v) if k == "err" else tot[k] + v
                del x, w, b, packed, xc, wc, bc
                torch.cuda.empty_cache()
            split = dt == torch.float32
            bound_ms, bound_by = bound(tot["flops"], tot["bytes"], tname, split)
            results[("conv3x3", dt)] = dict(err=tot["err"], ms=tot["ms"], plain=tot["plain"],
                                            bound_ms=bound_ms, bound_by=bound_by,
                                            library_ms=tot["library"])
            say(f"PHASE kernels conv3x3 {dt} five shapes: kernel {tot['ms']:.4f} ms plain "
                f"{tot['plain']:.4f} ms library {tot['library']:.4f} ms bound {bound_ms:.4f} ms "
                f"({bound_label(bound_by, split)}; the five calls' work summed), "
                f"{tot['bounds']:.4f} ms (each call's bound, summed) [{card}]")
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
    trackers = init_trackers(H, W, device=dev)
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
    run; one run in float32 (the CLI's default type) with K5's share of the
    device time; the card's time per layer of one bf16 chunk from
    torch.profiler."""
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

    # the CLI's default type (`tools --dtype float32`; K5's split-TF32 body):
    # one warm-up and one counted run, fps out, and K5's share of the device
    # time in one more run under the profiler
    cfg32, ep32, rp32 = tools_models("float32")
    run_merged_pipeline(clip, tmp / "tools_warm32.y4m", cfg32, ep32, rp32, device=dev)
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    n32 = run_merged_pipeline(clip, tmp / "tools_out32.y4m", cfg32, ep32, rp32, device=dev)
    torch.cuda.synchronize()
    wall32 = time.perf_counter() - t0
    k5_32 = launch_counts["conv3x3"]
    expect(n32 == n_out and k5_32 == want_k5,
           f"float32 tools wrote {n32} frames (want {n_out}) with {k5_32} K5 launches "
           f"(want {want_k5})")
    spread32 = float(read_clip(tmp / "tools_out32.y4m")[2].astype(float).std())
    expect(spread32 > 1.0, f"float32 tools output is flat (std {spread32:.3f})")
    prof32 = device_profile(lambda: run_merged_pipeline(clip, tmp / "tools_prof32.y4m", cfg32,
                                                        ep32, rp32, device=dev))
    share = ("K5 share not measured (the profiler saw no device event)" if prof32 is None
             else f"K5 {prof32['hand_ms']:.3f} ms of {prof32['device_ms']:.3f} ms device time "
                  f"= {100 * prof32['hand_ms'] / prof32['device_ms']:.1f} %")
    say(f"PHASE tools float32 (the CLI's default type): {TOOLS_FRAMES} frames -> {n32}, "
        f"{n32 / wall32:.3f} fps out ({TOOLS_FRAMES / wall32:.3f} fps in), K5 launches "
        f"{k5_32} (want {want_k5}); {share}; under the profiler "
        f"{fmt_profile(prof32, 1e3 * wall32)} [{card}]")
    del cfg32, ep32, rp32

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
    surface_functions(card)


def surface_functions(card: str):
    """The functions that complete the JAX package's surface, on cuda:0
    against the same call on the CPU: the ops at 1080p, RIFE and ESRGAN at
    toy widths (float32, TF32 off), within the CPU parity tests' gates."""
    import numpy as np
    import torch

    from visiondepth3d_tpu_torch.depth.model import init_random_fan_in_
    from visiondepth3d_tpu_torch.enhance.esrgan import ESRGANConfig, esrgan_apply
    from visiondepth3d_tpu_torch.enhance.rife import IFNetConfig, rife_apply
    from visiondepth3d_tpu_torch.ops import convert, depth_shaping, filters, quantiles, tiling
    from visiondepth3d_tpu_torch.stereo.params import (StereoParams,
                                                       pop_controls_locked_to_defaults)

    t0 = time.perf_counter()
    gen = torch.Generator().manual_seed(5)
    frame = smooth_frame(gen, H, W, "cpu")
    depth = frame.mean(-1)
    u8 = (frame * 255).round().to(torch.uint8)
    # values well inside their bins of 2048: the histogram is the same on both sides
    inside = (torch.randint(0, 2048, (H, W), generator=gen)
              + 0.1 + 0.8 * torch.rand(H, W, generator=gen)) / 2048
    small = smooth_frame(gen, 64, 96, "cpu")
    rife_cfg = IFNetConfig(cs=(32, 16), scales=(2, 1), n_res=2)
    esr_cfg = ESRGANConfig(nf=16, nb=1, gc=8, scale=4)
    rife_state = init_random_fan_in_(rife_cfg.build(), gen).state_dict()
    esr_state = init_random_fan_in_(esr_cfg.build(), gen).state_dict()
    tiles, starts = tiling.extract_tiles(frame, (518, 518), 64)
    cases = {  # name -> (fn of a device, tolerance; 0 = bit for bit)
        "rgb_to_gray": (lambda d: convert.rgb_to_gray(frame.to(d)), 1e-6),
        "bgr_to_rgb": (lambda d: convert.bgr_to_rgb(frame.to(d)), 1e-6),
        "depth_frame_to_01": (lambda d: convert.depth_frame_to_01(u8.to(d)), 0.0),
        "midtone_shape": (lambda d: depth_shaping.midtone_shape(depth.to(d)), 1e-6),
        "bilateral_smooth_depth": (lambda d: filters.bilateral_smooth_depth(depth.to(d)),
                                   1e-5),
        "hist_quantile": (lambda d: quantiles.hist_quantile(
            inside.to(d), [0.02, 0.05, 0.5, 0.95, 0.98]), 1e-6),
        "extract_tiles": (lambda d: tiling.extract_tiles(frame.to(d), (518, 518), 64)[0],
                          1e-6),
        "blend_tiles": (lambda d: tiling.blend_tiles(tiles.to(d), starts, (H, W)), 1e-6),
        "tiled_apply": (lambda d: tiling.tiled_apply(lambda t: t.mean(-1), frame.to(d),
                                                     (518, 518), 64), 1e-6),
        "rife_apply": (lambda d: rife_apply((rife_state, rife_cfg), small.to(d),
                                            small.flip(1).to(d), 0.5), 1e-5),
        "esrgan_apply": (lambda d: esrgan_apply(esr_state, small[:32, :48].to(d),
                                                cfg=esr_cfg), 1e-5),
    }
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    errs = {}
    try:
        for name, (fn, tol) in cases.items():
            want, got = fn("cpu"), fn("cuda:0")
            expect(got.device.type == "cuda" and got.shape == want.shape
                   and bool(torch.isfinite(got).all()),
                   f"surface {name}: {got.device} {tuple(got.shape)} against "
                   f"{tuple(want.shape)} on the CPU, or not finite")
            err = (got.double().cpu() - want.double()).abs().max().item()
            expect(err <= tol, f"surface {name}: card vs CPU max |d| {err:.3g} > {tol:g}")
            errs[name] = err
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    moved = StereoParams(depth_pop_gamma=1.4, fg_pop_multiplier=2.0)
    expect(pop_controls_locked_to_defaults(moved) == pop_controls_locked_to_defaults(
        StereoParams()), "pop_controls_locked_to_defaults kept a moved pop control")
    seconds = time.perf_counter() - t0
    say(f"PHASE surface functions: {len(cases)} on cuda:0 against the CPU, max |d| "
        f"{json.dumps({k: float(np.float32(v)) for k, v in errs.items()})}; "
        f"pop_controls_locked_to_defaults field for field [{card}]")
    say(f"PHASE surface functions took {seconds:.1f} s")


def k7_depth_route(card: str, tmp: Path, phase: str, model: str, size: int,
                   n_depth: int = 16, per_call: int | None = None):
    """A catalog model (bf16, fast head, random weights from seed 0) at
    size^2 through the depth route with the K7 opt-in over an n_depth-frame
    1080p clip, batch 8: K7 launched ``per_call`` times per model call (once
    per ViT layer unless given), no other kernel; the output's shape checked
    and not flat."""
    import torch

    from visiondepth3d_tpu_torch.kernels import launch_counts, reset_launch_counts
    from visiondepth3d_tpu_torch.ops import attention as attn_ops
    from visiondepth3d_tpu_torch.pipeline.depth_pipeline import (DepthConfig,
                                                                 render_depth_video_file)

    dclip = tmp / f"k7_depth_{n_depth}_1080p.y4m"
    if not dclip.exists():
        write_clip(dclip, W, H, n_depth)
    dcfg = DepthConfig(batch_size=8, dtype="bfloat16", device="cuda")
    dpred = da_predictor("cuda", "bfloat16", model, size)
    if per_call is None:
        bb = dpred.cfg.backbone
        per_call = bb.num_layers
        what = f"{bb.num_heads} heads, N = {(size // bb.patch_size) ** 2 + 1}"
    else:
        what = f"{per_call} launches per model call"
    try:
        attn_ops.USE_VMEM_KERNEL = True
        render_depth_video_file(warm_clip(tmp), tmp / "k7_depth_warm.y4m", dcfg,
                                predictor=dpred)
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        got = render_depth_video_file(dclip, tmp / "k7_depth.y4m", dcfg, predictor=dpred)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        attn_ops.USE_VMEM_KERNEL = False
    counts = dict(launch_counts)
    calls = -(-n_depth // dcfg.batch_size)
    want = {k: (per_call * calls if k == "vmem_attention" else 0) for k in counts}
    expect(got == n_depth and counts == want,
           f"{model} depth route: {got} frames, launches {counts}, want {want}")
    ow, oh, dout = read_clip(tmp / "k7_depth.y4m")
    expect((ow, oh) == (W, H) and float(dout[..., 0].std()) > 1.0,
           f"{model} depth output {ow}x{oh} flat or misshapen")
    say(f"PHASE {phase} depth {model}: {n_depth} frames 1920x1080, {size}^2 bf16 fast "
        f"head, batch 8, K7 opt-in ({what}): {n_depth / wall:.2f} fps, K7 launches "
        f"{counts['vmem_attention']} ({per_call} per model call x {calls}) [{card}]")


def float32_parity(card: str, phase: str, label: str, model: str, size: int):
    """One size^2 frame through a catalog model in float32 (TF32 off) on the
    CPU and on the card: the depth route's u8 depth within a mean of 1 u8,
    and not flat. Frees the model's predictors."""
    import numpy as np
    import torch

    from visiondepth3d_tpu_torch.pipeline.depth_pipeline import DepthConfig, make_depth_batch_fn

    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        frame = (smooth_frame(torch.Generator().manual_seed(11), size, size, "cpu") * 255
                 ).round().to(torch.uint8)[None]
        depth = {}
        for device in ("cpu", "cuda"):
            fpred = da_predictor(device, "float32", model, size)
            fn = make_depth_batch_fn(fpred, DepthConfig(device=device), (size, size))
            depth[device] = fn(frame.to(device)).cpu().numpy().astype(np.int16)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
        drop_predictors(model)
    d = float(np.abs(depth["cpu"] - depth["cuda"]).mean())
    std = float(depth["cpu"].std())
    expect(std > 1.0 and d <= 1.0,
           f"{label} float32 depth: CPU vs card mean |d| {d:.4f} u8 (need <= 1), depth std "
           f"{std:.2f} u8 (need > 1: not flat)")
    say(f"PHASE {phase} parity {label}: {size}^2 float32 (TF32 off), one frame, CPU vs "
        f"card after the depth route's u8 rounding: mean |d| {d:.4f} u8 (need <= 1), max "
        f"{int(np.abs(depth['cpu'] - depth['cuda']).max())}, depth std {std:.2f} u8 [{card}]")


def phase_catalog(card: str, tmp: Path):
    """Depth Anything V2-Large through the fused 1080p render; V2-Base and
    V2-Large through the depth route with the K7 opt-in; V2-Large in float32
    on the CPU against the card."""
    import torch

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
    for model in ("depth-anything-v2-base", large):
        k7_depth_route(card, tmp, "catalog", model, 518)
        drop_predictors(model)
    # one 518^2 frame through V2-Large in float32: CPU against the card
    float32_parity(card, "catalog", "DA-V2-Large", large, 518)


# the families phase: catalog name, inference size (the first of the
# family's recommended sizes), frames of its fused render
FAMILY_RENDERS = (("dpt-large", 384, 16), ("dpt-beit-large-512", 512, 16),
                  ("midas-v3-hybrid", 384, 16), ("zoedepth-nyu", 384, 16),
                  ("zoedepth-nyu-kitti", 384, 16), ("midas-v2", 384, 16))
# the families whose ViT runs K7 under the opt-in, at 384^2 (N = 577)
FAMILY_K7 = ("dpt-large", "midas-v3-hybrid")


def family_render(card: str, tmp: Path, model: str, size: int, n: int, runs: int,
                  halves_gate: bool = True, phase: str = "families") -> dict:
    """One family's predictor (bf16, random weights from seed 0) through the
    fused 1080p Full-SBS render: a warm-up chunk, `runs` timed runs and one
    profiled run, K1-K4 gated per frame and no other kernel (no K7) in each;
    the output's shape and its two halves checked (with ``halves_gate``
    off, the depth of the clip's first frame instead: finite, not flat)."""
    import torch

    from visiondepth3d_tpu_torch.pipeline.stereo_pipeline import RenderConfig
    from visiondepth3d_tpu_torch.stereo.params import StereoParams

    pred = da_predictor("cuda", "bfloat16", model, size)
    params = StereoParams(enable_healing=True, image_dtype="bfloat16")
    cfg = RenderConfig(output_format="Full-SBS", output_height=1080, chunk_size=16,
                       device="cuda")
    clip = tmp / f"families_{n}_1080p.y4m"
    if not clip.exists():
        write_clip(clip, W, H, n)
    counted_render(warm_clip(tmp), tmp / "families_warm.y4m", params, cfg, pred, 16,
                   f"{model} warm-up")
    torch.cuda.reset_peak_memory_stats()
    walls = [counted_render(clip, tmp / "families_sbs.y4m", params, cfg, pred, n,
                            f"{model} render")[0] for _ in range(runs)]
    peak = torch.cuda.max_memory_allocated()
    ow, oh, out = read_clip(tmp / "families_sbs.y4m")
    expect((ow, oh) == (2 * W, H) and out.shape[0] == n,
           f"{model} render: output {ow}x{oh} with {out.shape[0]} frames, want "
           f"{2 * W}x{H} x {n}")
    halves = float(abs(out[:, :, :W].astype(int) - out[:, :, W:].astype(int)).mean())
    if halves_gate:
        expect(halves > 0.1, f"{model} render: identical halves (mean |L-R| {halves})")
    else:
        first = read_clip(clip)[2][:1]
        d01 = pred.predict_01(torch.from_numpy(first).cuda().float() / 255.0, out_hw=(H, W))
        std = float(d01.std())
        expect(bool(torch.isfinite(d01).all()) and std > 1e-2,
               f"{model} depth of the first frame: std {std} (need > 1e-2), finite")
        say(f"PHASE {phase} render {model}: the first frame's depth in [0, 1] std {std:.4f} "
            f"(need > 1e-2), row-mean std {float(d01[0].mean(1).std()):.4f}, column-mean "
            f"std {float(d01[0].mean(0).std()):.4f}; mean |L-R| {halves:.3f} u8 not gated "
            f"[{card}]")
    del out
    prof = device_profile(lambda: counted_render(clip, tmp / "families_prof.y4m", params,
                                                 cfg, pred, n, f"{model} profiled"))
    per_frame = "not measured" if prof is None else f"{prof['device_ms'] / n:.3f} ms"
    say(f"PHASE {phase} render {model}: {size}^2 (snapped {pred._size[0]}x{pred._size[1]}) "
        f"bf16 fast head, {n} frames 1920x1080 -> {ow}x{oh} Full-SBS, chunks of 16, "
        f"{runs} run(s): {', '.join(f'{n / w:.2f}' for w in walls)} fps end to end, device "
        f"time per frame {per_frame}, launches per frame {json.dumps(PER_FRAME)} (no K7), "
        f"mean |L-R| {halves:.2f}, peak allocated {peak / 2**30:.3f} GiB; profiled run: "
        f"{fmt_profile(prof, 1e3 * min(walls))} [{card}]")
    return {"walls": walls, "prof": prof}


def phase_families(card: str, tmp: Path):
    """The feed-forward families at their published widths: each through the
    fused 1080p render; DPT-Large and DPT-Hybrid through the depth route with
    the K7 opt-in (every ViT layer at N = 577); one float32 frame of each on
    the CPU against the card."""
    for model, size, n in FAMILY_RENDERS:
        family_render(card, tmp, model, size, n, runs=2 if model == "dpt-large" else 1)
        if model in FAMILY_K7:
            k7_depth_route(card, tmp, "families", model, size)
        drop_predictors(model)
    for model, size, _ in FAMILY_RENDERS:
        float32_parity(card, "families", model, model, size)


class no_tf32:
    """TF32 off for matmuls and convolutions inside the block."""

    def __enter__(self):
        import torch

        self.saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        import torch

        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.saved


def timed_route(card: str, what: str, run, want_k7: int, n: int, out: Path, out_hw,
                per: str = "fps", phase: str = "routes", profile: str = "after") -> dict:
    """One depth route run with the launch counts zeroed just before it and
    read just after (K7 gated at ``want_k7``, no other kernel) and its peak
    memory; ``profile``: "after" profiles one more run (its busy share over
    the unprofiled run's wall), "inline" times the run under the profiler
    (for a device-bound route whose host the profiler does not slow: its
    busy share over its own wall), "no" profiles nothing. The output's
    shape checked, not flat."""
    import torch

    from visiondepth3d_tpu_torch.kernels import launch_counts, reset_launch_counts

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    result = {}

    def timed():
        t0 = time.perf_counter()
        result["got"] = run()
        torch.cuda.synchronize()
        result["wall"] = time.perf_counter() - t0
    prof = device_profile(timed) if profile == "inline" else timed()
    got, wall = result["got"], result["wall"]
    counts = dict(launch_counts)
    peak = torch.cuda.max_memory_allocated()
    want = {k: (want_k7 if k == "vmem_attention" else 0) for k in counts}
    expect(got == n and counts == want, f"{what}: {got} frames, launches {counts}, want {want}")
    ow, oh, frames = read_clip(out)
    expect((oh, ow) == tuple(out_hw) and frames.shape[0] == n and float(frames.std()) > 1.0,
           f"{what}: output {ow}x{oh} with {frames.shape[0]} frames, flat or misshapen")
    if profile == "after":
        prof = device_profile(run)
    rate = f"{n / wall:.2f} fps" if per == "fps" else f"{wall / n:.3f} s per frame"
    dev = "not measured" if prof is None else f"{prof['device_ms'] / n:.3f} ms"
    label = {"after": "profiled run", "inline": "this run under the profiler",
             "no": "profiled run"}[profile]
    trace = "not profiled" if profile == "no" else fmt_profile(prof, 1e3 * wall)
    say(f"PHASE {phase} {what}: {n} frames -> {ow}x{oh}, {rate} end to end, device time per "
        f"frame {dev}, K7 launches {counts['vmem_attention']}, peak allocated "
        f"{peak / 2**30:.3f} GiB; {label}: {trace} [{card}]")
    return {"wall": wall, "prof": prof, "out": frames[..., 0]}


def route_parity(card: str, label: str, run_on) -> None:
    """The same one-frame route in float32 on the CPU (plain versions) and
    on the card (TF32 off): ``run_on(device)`` returns the route's u8 depth;
    mean |d| <= 1 u8, not flat."""
    import numpy as np

    with no_tf32():
        depth = {dev: run_on(dev).astype(np.int16) for dev in ("cpu", "cuda")}
    d = float(np.abs(depth["cpu"] - depth["cuda"]).mean())
    std = float(depth["cpu"].std())
    expect(std > 1.0 and d <= 1.0, f"{label} float32 route: CPU vs card mean |d| {d:.4f} u8 "
                                   f"(need <= 1), depth std {std:.2f} u8 (need > 1)")
    say(f"PHASE routes parity {label}: float32 (TF32 off), one frame, CPU vs card after the "
        f"route's u8 rounding: mean |d| {d:.4f} u8 (need <= 1), max "
        f"{int(np.abs(depth['cpu'] - depth['cuda']).max())}, depth std {std:.2f} u8 [{card}]")


def unet_k7_per_call(cfg, latent_hw) -> int:
    """Self-attentions the K7 opt-in takes in one UNet call: every spatial
    transformer at a level whose token count is in [512, 4096) (down
    ``layers_per_block``, up ``layers_per_block + 1``; the mid block at the
    deepest level)."""
    h, w = latent_hw
    total, last = 0, len(cfg.block_out_channels) - 1
    for level in range(last + 1):
        n = h * w
        if 512 <= n < 4096:
            if cfg.with_attn[level]:
                total += 2 * cfg.layers_per_block + 1
            if level == last:
                total += 1  # the mid block's
        h, w = -(-h // 2), -(-w // 2)  # the stride-2 conv (padding 1)
    return total


def phase_routes(card: str, tmp: Path):
    """Depth Pro (render and K7 depth route), VDA-Small and Marigold (their
    depth routes with SDPA and with K7) at the published widths, then one
    float32 frame of each on the CPU against the card."""
    import copy

    import numpy as np
    import torch

    from visiondepth3d_tpu_torch.depth.diffusion import build_random_marigold
    from visiondepth3d_tpu_torch.depth.model import STANDARD_MEAN as STANDARD
    from visiondepth3d_tpu_torch.depth.registry import CATALOG, load_predictor
    from visiondepth3d_tpu_torch.ops import attention as attn_ops
    from visiondepth3d_tpu_torch.pipeline.depth_pipeline import (DepthConfig,
                                                                 make_depth_batch_fn,
                                                                 render_depth_video_file)

    # Depth Pro: the fused render (K1-K4, no K7), then the depth route on K7
    dp = "depth-pro"
    # its random depth has little large-scale structure, so the eyes barely
    # differ (0.01 u8 on the CPU as on the card): the depth is gated instead
    family_render(card, tmp, dp, 1536, 16, runs=1, halves_gate=False, phase="routes")
    vits = [da_predictor("cuda", "bfloat16", dp, 1536).cfg.patch_model.num_layers] * 3
    k7_depth_route(card, tmp, "routes", dp, 1536, n_depth=8, per_call=sum(vits))
    drop_predictors(dp)

    # float32 on the CPU against the card: the published widths with 12 of
    # each ViT's 24 layers (the hooks 11 and 5 kept; the full depth costs
    # the CPU about a minute), one model moved to the card
    from visiondepth3d_tpu_torch.depth.model import DepthPredictor

    full = CATALOG[dp].config
    vit = dataclasses.replace(full.patch_model, num_layers=12)
    cut = dataclasses.replace(full, patch_model=vit, image_model=vit, fov_model=vit)
    dp_cpu = load_predictor(dp, None, inference_size=1536, seed=0, device="cpu", config=cut)
    dp_card = DepthPredictor(copy.deepcopy(dp_cpu.model), 1536, device="cuda",
                             mean=STANDARD, std=STANDARD, select=0, snap_multiple=1536)

    def depth_pro_one_frame(dev):
        frame = (smooth_frame(torch.Generator().manual_seed(11), 1536, 1536, "cpu") * 255
                 ).round().to(torch.uint8)[None]
        fn = make_depth_batch_fn(dp_cpu if dev == "cpu" else dp_card, DepthConfig(device=dev),
                                 (1536, 1536))
        return fn(frame.to(dev)).cpu().numpy()[0]

    route_parity(card, "Depth Pro (12 of 24 layers)", depth_pro_one_frame)
    del dp_cpu, dp_card
    torch.cuda.empty_cache()

    # VDA-Small: two 32-frame windows (32, then 8 carried + 24)
    vda = "video-depth-anything"
    n = 56
    clip = tmp / "vda_1080p.y4m"
    write_clip(clip, W, H, n)
    pred = load_predictor(vda, None, inference_size=518, seed=0, dtype="bfloat16",
                          device="cuda")
    cfg = DepthConfig(model=vda, inference_size=518, dtype="bfloat16", device="cuda")
    windows = 2
    k7_per_window = pred.cfg.base.backbone.num_layers  # every ViT layer at N = 1370
    outs = {}
    try:
        for mode in ("sdpa", "K7"):
            attn_ops.USE_VMEM_KERNEL = mode == "K7"
            render_depth_video_file(warm_clip(tmp), tmp / "vda_warm.y4m", cfg, predictor=pred)
            out = tmp / f"vda_{mode}.y4m"
            res = timed_route(card, f"VDA-Small 518^2 bf16 {mode}", lambda: render_depth_video_file(
                clip, out, cfg, predictor=pred), windows * k7_per_window if mode == "K7" else 0,
                n, out, (H, W))
            outs[mode] = res["out"]
    finally:
        attn_ops.USE_VMEM_KERNEL = False
    d = float(np.abs(outs["sdpa"].astype(np.int16) - outs["K7"].astype(np.int16)).mean())
    say(f"PHASE routes VDA-Small: bf16 outputs SDPA vs K7 mean |d| {d:.4f} u8 [{card}]")
    del pred, outs
    torch.cuda.empty_cache()

    def vda_one_frame(dev):
        one = tmp / "vda_one.y4m"
        if not one.exists():
            write_clip(one, 960, 540, 1)
        p = load_predictor(vda, None, inference_size=518, seed=0, device=dev)
        out = tmp / f"vda_one_{dev}.y4m"
        render_depth_video_file(one, out, DepthConfig(model=vda, inference_size=518, device=dev),
                                predictor=p)
        return read_clip(out)[2][..., 0]

    route_parity(card, "VDA-Small", vda_one_frame)

    # Marigold: 4 frames, batch 2, 4 DDIM steps: a 135 x 240 latent at 1080p
    mg = "marigold"
    n, steps, batch = 4, 4, 2
    clip = tmp / "marigold_1080p.y4m"
    write_clip(clip, W, H, n)
    warm = tmp / "marigold_warm.y4m"
    write_clip(warm, W, H, batch)
    pipe = build_random_marigold(0, steps=steps, dtype="bfloat16", device="cuda")
    cfg = DepthConfig(model=mg, batch_size=batch, dtype="bfloat16", device="cuda", steps=steps)
    per_call = unet_k7_per_call(pipe.unet_cfg, (H // 8, W // 8))
    want_k7 = per_call * steps * -(-n // batch)
    outs = {}
    try:
        for mode in ("sdpa", "K7"):
            attn_ops.USE_VMEM_KERNEL = mode == "K7"
            render_depth_video_file(warm, tmp / "marigold_warm_out.y4m", cfg, predictor=pipe)
            out = tmp / f"marigold_{mode}.y4m"
            res = timed_route(card, f"Marigold 1080p bf16 {steps} steps {mode}",
                              lambda: render_depth_video_file(clip, out, cfg, predictor=pipe),
                              want_k7 if mode == "K7" else 0, n, out, (H, W), per="s")
            outs[mode] = res["out"]
    finally:
        attn_ops.USE_VMEM_KERNEL = False
    d = float(np.abs(outs["sdpa"].astype(np.int16) - outs["K7"].astype(np.int16)).mean())
    say(f"PHASE routes Marigold: K7 {per_call} launches per UNet call x {steps} steps x "
        f"{-(-n // batch)} batches; bf16 outputs SDPA vs K7 mean |d| {d:.4f} u8 [{card}]")
    sdpa_backend_of_vae_mid(card)
    del pipe, outs
    torch.cuda.empty_cache()

    cpu_pipe = build_random_marigold(0, steps=steps, device="cpu")
    card_pipe = type(cpu_pipe)(copy.deepcopy(cpu_pipe.unet), copy.deepcopy(cpu_pipe.vae),
                               cpu_pipe.ctx.numpy(), num_steps=steps, device="cuda")
    noise = torch.randn(1, 256 // 8, 256 // 8, 4, generator=torch.Generator().manual_seed(5))

    def marigold_one_frame(dev):
        one = tmp / "marigold_one.y4m"
        if not one.exists():
            write_clip(one, 256, 256, 1)
        p = cpu_pipe if dev == "cpu" else card_pipe
        orig = p._run
        p._run = lambda rgb, _noise: orig(rgb, noise)  # the same noise on both sides
        out = tmp / f"marigold_one_{dev}.y4m"
        try:
            render_depth_video_file(one, out, DepthConfig(model=mg, batch_size=1, device=dev,
                                                          steps=steps), predictor=p)
        finally:
            del p._run
        return read_clip(out)[2][..., 0]

    route_parity(card, "Marigold 256^2", marigold_one_frame)
    del cpu_pipe, card_pipe
    torch.cuda.empty_cache()


def dcrafter_windows(pipe, n: int, seg: int) -> int:
    """Windows DepthCrafter's route denoises over n frames: segments of
    ``seg`` frames, each after the first carrying ``overlap`` frames."""
    total, carry, left = 0, 0, n
    while left > 0:
        take = min(seg - carry, left)
        total += len(pipe._windows(carry + take))
        left -= take
        if carry + take < seg:
            break
        carry = pipe.overlap
    return total


def onnx_depth_graph(path: Path, seed: int = 0) -> Path:
    """A small depth net written with write_onnx_graph: a conv encoder (16
    and 32 channels, the second at stride 2), a decoder that resizes back
    up (bilinear) and concatenates the skip, a 1x1 conv and a Sigmoid;
    [B, 3, H, W] -> [B, H, W]."""
    import numpy as np

    from visiondepth3d_tpu_torch.utils.onnx_reader import write_onnx_graph

    rng = np.random.default_rng(seed)

    def node(op, inputs, outputs, **attrs):
        return {"op": op, "inputs": inputs, "outputs": outputs, "attrs": attrs}

    def w(*shape):
        return (rng.standard_normal(shape) / np.sqrt(np.prod(shape[1:]))).astype(np.float32)

    inits = {"w1": w(16, 3, 3, 3), "b1": w(16), "w2": w(32, 16, 3, 3), "b2": w(32),
             "w3": w(16, 48, 3, 3), "w4": w(1, 16, 1, 1),
             "scales": np.asarray([1.0, 1.0, 2.0, 2.0], np.float32)}
    write_onnx_graph(str(path), inputs=[("input", [None, 3, None, None])],
                     outputs=[("depth", None)], initializers=inits, nodes=[
        node("Conv", ["input", "w1", "b1"], ["e1"], pads=[1, 1, 1, 1]),
        node("Relu", ["e1"], ["e1r"]),
        node("Conv", ["e1r", "w2", "b2"], ["e2"], strides=[2, 2], pads=[1, 1, 1, 1]),
        node("Relu", ["e2"], ["e2r"]),
        node("Resize", ["e2r", "", "scales"], ["up"], mode=b"linear"),
        node("Concat", ["up", "e1r"], ["cat"], axis=1),
        node("Conv", ["cat", "w3"], ["d1"], pads=[1, 1, 1, 1]),
        node("Relu", ["d1"], ["d1r"]),
        node("Conv", ["d1r", "w4"], ["d2"]),
        node("Sigmoid", ["d2"], ["d3"]),
        node("Squeeze", ["d3"], ["depth"], axes=[1])])
    return path


def groupnorm_shapes(card: str):
    """F.group_norm (32 groups, bf16) at the shapes DepthCrafter's 1080p route
    gives it: the ST-UNet's level-0 spatial norm over a 24-frame window, its
    temporal resnet's norm (positions folded into the batch, T = 24), and
    the VAE's full-resolution norm for one decoded frame and for an encoded
    chunk of 8; each timed by graph replay beside its bytes bound (read the
    input twice, moments and normalize, write once)."""
    import torch
    import torch.nn.functional as F

    for shape in ((24, 320, 135, 240), (32400, 320, 24), (1, 128, 1080, 1920),
                  (8, 128, 1080, 1920)):
        x = torch.randn(shape, device="cuda", dtype=torch.bfloat16)
        w = torch.ones(shape[1], device="cuda", dtype=torch.bfloat16)
        ms = graph_ms(lambda: F.group_norm(x, 32, w, w), warmup=2, runs=5)
        bound_ms, _ = bound(0.0, 3 * x.numel() * 2, "bfloat16")
        say(f"PHASE dcrafter group_norm {list(shape)} bf16: {ms:.3f} ms (graph replay), bytes "
            f"bound {bound_ms:.3f} ms [{card}]")
        del x, w
    torch.cuda.empty_cache()


def phase_dcrafter(card: str, tmp: Path):
    """DepthCrafter at its published widths through its depth route (bf16,
    SDPA and K7), the float32 CPU-vs-card parity on a reduced clip, and the
    ONNX route (whole and tiled) on the card and on the CPU."""
    import copy

    import numpy as np
    import torch

    from visiondepth3d_tpu_torch.depth.diffusion import (DepthCrafterPipeline,
                                                         build_random_depthcrafter)
    from visiondepth3d_tpu_torch.io import Y4MReader
    from visiondepth3d_tpu_torch.kernels import launch_counts, reset_launch_counts
    from visiondepth3d_tpu_torch.ops import attention as attn_ops
    from visiondepth3d_tpu_torch.pipeline.depth_pipeline import (DepthConfig,
                                                                 render_depth_video_file)

    t0 = time.perf_counter()
    base = build_random_depthcrafter(0, device="cpu")  # float32 on the host: every copy's source
    sizes = {name: sum(p.numel() for p in getattr(base, name).parameters())
             for name in ("unet", "vae", "clip")}
    say(f"PHASE dcrafter built DepthCrafter at the published widths (seed 0, float32 on the "
        f"host): UNet {sizes['unet'] / 1e9:.3f} B, VAE {sizes['vae'] / 1e9:.3f} B, CLIP "
        f"{sizes['clip'] / 1e9:.3f} B parameters ({sum(sizes.values()) / 1e9:.3f} B) in "
        f"{time.perf_counter() - t0:.1f} s")

    def on_card(dtype, **kw):
        return DepthCrafterPipeline(copy.deepcopy(base.unet), copy.deepcopy(base.vae),
                                    copy.deepcopy(base.clip), dtype=dtype, device="cuda", **kw)

    # bf16 over a 60-frame 1080p clip: segments of 42 sharing 6, windows of 24
    n, steps, window, overlap, seg = 60, 2, 24, 6, 42
    clip, warm = tmp / "dcrafter_1080p.y4m", tmp / "dcrafter_warm.y4m"
    write_clip(clip, W, H, n)
    write_clip(warm, W, H, window)
    pipe = on_card("bfloat16", num_steps=steps, window_size=window, overlap=overlap)
    cfg = DepthConfig(model="depthcrafter", dtype="bfloat16", device="cuda", steps=steps,
                      window_size=window, overlap=overlap, max_segment_frames=seg,
                      target_fps=24.0)
    windows = dcrafter_windows(pipe, n, seg)
    per_call = unet_k7_per_call(pipe.unet_cfg, (H // 8, W // 8))
    want_k7 = per_call * steps * windows
    outs = {}
    try:
        # one warm-up window (24 frames): K7 is built, SDPA's and cuDNN's plans are set
        render_depth_video_file(warm, tmp / "dcrafter_warm_out.y4m", cfg, predictor=pipe)
        for mode in ("sdpa", "K7"):
            attn_ops.USE_VMEM_KERNEL = mode == "K7"
            out = tmp / f"dcrafter_{mode}.y4m"
            res = timed_route(card, f"DepthCrafter 1080p bf16 {steps} steps {mode}",
                              lambda: render_depth_video_file(clip, out, cfg, predictor=pipe),
                              want_k7 if mode == "K7" else 0, n, out, (H, W), per="s",
                              phase="dcrafter", profile="inline" if mode == "K7" else "no")
            with Y4MReader(str(out)) as rd:
                expect(rd.fps == 24.0, f"DepthCrafter {mode}: output at {rd.fps} fps, want 24")
            expect(np.isfinite(res["out"]).all(), f"DepthCrafter {mode}: non-finite depth")
            outs[mode] = res["out"]
            if res["prof"] is not None:
                say(f"PHASE dcrafter DepthCrafter {mode} profiled run, the 8 device kernels with "
                    f"the most time (ms per frame): " + "; ".join(
                        f"{name[:90]} {ms / n:.2f}" for name, ms in res["prof"]["top"]))
    finally:
        attn_ops.USE_VMEM_KERNEL = False
    d = float(np.abs(outs["sdpa"].astype(np.int16) - outs["K7"].astype(np.int16)).mean())
    say(f"PHASE dcrafter DepthCrafter: {windows} windows over {n} frames (segments of {seg} "
        f"sharing {overlap}), K7 {per_call} launches per UNet call x {steps} steps x "
        f"{windows} windows = {want_k7}; bf16 outputs SDPA vs K7 mean |d| {d:.4f} u8 [{card}]")
    SHARED["dcrafter"] = pipe  # phase mesh's window-parallel check reuses it
    del pipe, outs
    torch.cuda.empty_cache()
    groupnorm_shapes(card)

    # float32 parity: one reduced clip on the CPU and on the card, the same noise
    small = tmp / "dcrafter_small.y4m"
    write_clip(small, 256, 144, 8)
    rng = np.random.default_rng(5)
    noise = {4: rng.standard_normal((8, 144, 256, 3)).astype(np.float32),
             5: rng.standard_normal((1, 6, 18, 32, 4)).astype(np.float32)}
    kw = dict(num_steps=steps, window_size=6, overlap=2)
    pipes = {"cpu": DepthCrafterPipeline(base.unet, base.vae, base.clip, device="cpu", **kw),
             "cuda": on_card("float32", **kw)}
    depth, secs = {}, {}
    with no_tf32():
        for dev, p in pipes.items():
            p._draw = lambda shape, gen: torch.from_numpy(noise[len(shape)])
            out = tmp / f"dcrafter_small_{dev}.y4m"
            t0 = time.perf_counter()
            render_depth_video_file(small, out, DepthConfig(
                model="depthcrafter", device=dev, steps=steps, window_size=6, overlap=2,
                target_fps=24.0), predictor=p)
            secs[dev] = time.perf_counter() - t0
            depth[dev] = read_clip(out)[2][..., 0]
    a, b = depth["cpu"].astype(np.int16), depth["cuda"].astype(np.int16)
    dm, std = float(np.abs(a - b).mean()), float(a.std())
    ssim = min(ssim_gray(x, y) for x, y in zip(depth["cpu"], depth["cuda"]))
    say(f"PHASE dcrafter parity DepthCrafter float32 (TF32 off, full widths and depth): 8 "
        f"frames 256x144, window 6, overlap 2, the same noise; CPU {secs['cpu']:.1f} s, card "
        f"{secs['cuda']:.1f} s; mean |d| {dm:.4f} u8 (need <= 1), max {int(np.abs(a - b).max())}"
        f", min SSIM {ssim:.5f} (need >= 0.99), depth std {std:.2f} u8 [{card}]")
    expect(a.shape == (8, 144, 256) and std > 1.0 and dm <= 1.0 and ssim >= 0.99,
           f"DepthCrafter float32 CPU vs card: mean |d| {dm:.4f}, SSIM {ssim:.5f}, std {std:.2f}")
    del pipes, base
    torch.cuda.empty_cache()

    # the ONNX route: a small depth net as onnx:, whole and tiled; fps over 16
    # 1080p frames on the card, the CPU against the card on the first 4
    graph = onnx_depth_graph(tmp / "depth_net.onnx")
    n = 16
    oclip, pclip = tmp / "onnx_1080p.y4m", tmp / "onnx_1080p_4.y4m"
    write_clip(oclip, W, H, n)
    write_clip(pclip, W, H, 4)
    for tiled in (False, True):
        label = "tiled (512 tiles over 1080 x 1920, overlap 64)" if tiled else "512^2"
        ocfg = dict(model=f"onnx:{graph}", inference_size=1080 if tiled else 512,
                    tiled=tiled, tile_size=512, tile_overlap=64, batch_size=8)
        with no_tf32():
            out = tmp / f"onnx_{tiled}.y4m"
            render_depth_video_file(oclip, out, DepthConfig(device="cuda", **ocfg))  # warm-up
            torch.cuda.synchronize()
            reset_launch_counts()
            t0 = time.perf_counter()
            got_n = render_depth_video_file(oclip, out, DepthConfig(device="cuda", **ocfg))
            torch.cuda.synchronize()
            fps = n / (time.perf_counter() - t0)
            launched = {k: v for k, v in launch_counts.items() if v}
            expect(got_n == n and not launched,
                   f"ONNX route {label}: {got_n} frames (want {n}), kernels launched {launched}")
            ow, oh, _ = read_clip(out)
            expect((ow, oh) == (W, H), f"ONNX route {label}: output {ow}x{oh}")
            got = {}
            for dev in ("cuda", "cpu"):
                pout = tmp / f"onnx_{tiled}_{dev}_4.y4m"
                render_depth_video_file(pclip, pout, DepthConfig(device=dev, **ocfg))
                got[dev] = read_clip(pout)[2][..., 0].astype(np.int16)
        dm = float(np.abs(got["cpu"] - got["cuda"]).mean())
        std = float(got["cpu"].std())
        say(f"PHASE dcrafter ONNX route {label}: {n} frames 1920x1080 float32 (TF32 off), batch "
            f"8: {fps:.2f} fps on the card, no kernel launched; 4 frames on the CPU vs the card "
            f"mean |d| {dm:.4f} u8 (need <= 1), max {int(np.abs(got['cpu'] - got['cuda']).max())}"
            f", depth std {std:.2f} u8 [{card}]")
        expect(std > 1.0 and dm <= 1.0,
               f"ONNX route {label}: CPU vs card mean |d| {dm:.4f} u8, std {std:.2f}")


def sdpa_backend_of_vae_mid(card: str):
    """Which SDPA backend takes the VAE's mid-block attention at 1080p
    ([2, 32400, 1, 512] BNHD): each backend tried alone, and the kernels of
    the default call as the profiler names them."""
    import torch
    import torch.nn.functional as F
    from torch.autograd import DeviceType
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from torch.profiler import ProfilerActivity, profile

    q = torch.randn(2, 1, 32400, 512, device="cuda", dtype=torch.bfloat16)
    accepts = []
    names = ("FLASH_ATTENTION", "EFFICIENT_ATTENTION", "CUDNN_ATTENTION", "MATH")
    for backend in (getattr(SDPBackend, n) for n in names if hasattr(SDPBackend, n)):
        try:
            with sdpa_kernel([backend]):
                F.scaled_dot_product_attention(q, q, q)
            accepts.append(backend.name)
        except RuntimeError:
            pass
    order = [SDPBackend(int(b)).name for b in torch._C._get_sdp_priority_order()]
    chosen = next((b for b in order if b in accepts), None)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        F.scaled_dot_product_attention(q, q, q)
        torch.cuda.synchronize()
    names = sorted({e.name for e in prof.events() if e.device_type == DeviceType.CUDA})
    say(f"PHASE routes Marigold VAE mid attention [2, 32400, 1, 512] bf16: backends that take "
        f"it alone {accepts}, the dispatcher's priority order {order}: it takes {chosen}; the "
        f"default call's device kernels "
        f"{[n[:80] for n in names] or 'not measured (the profiler saw no device event)'} "
        f"[{card}]")
    del q
    torch.cuda.empty_cache()


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


PRODUCT_FRAMES = 16


def synthetic_frames(w, h, n):
    """The frames of write_clip, as [n, h, w, 3] uint8."""
    import numpy as np

    yy, xx = np.mgrid[0:h, 0:w]
    out = np.empty((n, h, w, 3), np.uint8)
    for i in range(n):
        f = out[i]
        f[..., 0] = (xx * 255 // max(w - 1, 1) + 4 * i) % 256
        f[..., 1] = yy * 255 // max(h - 1, 1)
        f[..., 2] = 100
        x0 = w // 8 + (w // 64) * i % (w // 2)
        f[h // 4: h // 2, x0: x0 + w // 6] = (240, 50, 50)
    return out


def cli_run(argv) -> tuple[int, str]:
    """vd3d-torch in this process (so that the launch counts see it): its
    exit code and what it printed."""
    import contextlib
    import io

    from visiondepth3d_tpu_torch.cli.main import main as cli_main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli_main([str(a) for a in argv])
    return rc, buf.getvalue()


def product_convert(card: str, tmp: Path):
    """convert -> local: folder -> the fused render, against the same
    checkpoint's render; convert --depth-in/--depth-out."""
    import numpy as np
    import torch

    from visiondepth3d_tpu_torch.depth.convert import (from_jax_tree, load_safetensors,
                                                       save_safetensors)
    from visiondepth3d_tpu_torch.depth.registry import (CATALOG, load_local_params,
                                                        load_predictor)
    from visiondepth3d_tpu_torch.io.depth_io import Depth16Reader, Depth16Writer
    from visiondepth3d_tpu_torch.pipeline.stereo_pipeline import (RenderConfig,
                                                                  render_stereo_video)
    from visiondepth3d_tpu_torch.stereo.params import StereoParams

    name = "depth-anything-v2-small"
    ckpt, folder = tmp / "da_small.safetensors", tmp / "da_small_local"
    cpu = load_predictor(name, None, inference_size=518, seed=0, device="cpu")
    state = cpu.model.state_dict()
    save_safetensors(ckpt, state)
    del cpu
    rc, out = cli_run(["convert", "--model", name, "--checkpoint", ckpt, "--output", folder])
    expect(rc == 0 and f"local:{folder}" in out, f"convert rc={rc}: {out[-500:]}")
    meta = json.loads((folder / "vd3d.json").read_text())
    expect(meta == {"base": name, "format": "native"}, f"vd3d.json {meta}")
    tree, native = load_local_params(str(folder))
    back = from_jax_tree("dpt_dinov2", tree, CATALOG[name].config)
    file_state = load_safetensors(ckpt)
    expect(native and set(back) == set(state) == set(file_state),
           "the folder's tensors are not the checkpoint's")
    diff = [k for k in back if not torch.equal(back[k], file_state[k])]
    expect(not diff, f"the folder's tensors differ from the checkpoint's: {diff[:5]}")

    params = StereoParams(enable_healing=True, image_dtype="bfloat16")
    cfg = RenderConfig(output_format="Full-SBS", output_height=1080, chunk_size=16,
                       device="cuda")
    clip = tmp / "product_1080p.y4m"
    write_clip(clip, W, H, PRODUCT_FRAMES)
    preds = {what: load_predictor(model, ck, inference_size=518, dtype="bfloat16",
                                  device="cuda", fast_head=True)
             for what, model, ck in (("local", f"local:{folder}", None),
                                     ("checkpoint", name, str(ckpt)))}
    sa, sb = (p.model.state_dict() for p in preds.values())
    expect(set(sa) == set(sb) and all(torch.equal(sa[k], sb[k]) for k in sa),
           "the local: model's state dict differs from the --checkpoint model's")
    render_stereo_video(warm_clip(tmp), None, tmp / "product_warm.y4m", params, cfg,
                        predictor=preds["local"])  # the first render's one-time set-up
    walls = {}
    for what, pred in preds.items():
        walls[what], _ = counted_render(clip, tmp / f"product_{what}.y4m", params, cfg, pred,
                                        PRODUCT_FRAMES, f"product {what} render")
    same = filecmp.cmp(tmp / "product_local.y4m", tmp / "product_checkpoint.y4m",
                       shallow=False)
    if not same:  # the run-to-run spread of the same render bounds the local: one
        counted_render(clip, tmp / "product_again.y4m", params, cfg, preds["checkpoint"],
                       PRODUCT_FRAMES, "product checkpoint render again")
        a, b, c = (read_planes(tmp / f"product_{w}.y4m")[0].astype(np.int16)
                   for w in ("local", "checkpoint", "again"))
        d_local, d_again = int(np.abs(a - b).max()), int(np.abs(c - b).max())
        expect(d_local <= d_again, f"the local: render is {d_local} u8 from the "
               f"--checkpoint render, two --checkpoint renders {d_again} apart")
        say(f"PHASE product convert: the renders differ run to run (max {d_again} u8 in Y); "
            f"the local: render is {d_local} u8 from the --checkpoint render")
    from visiondepth3d_tpu_torch.io import Y4MReader

    with Y4MReader(str(tmp / "product_local.y4m")) as rd:
        ow, oh = rd.width, rd.height
    expect((ow, oh) == (2 * W, H), f"product render {ow}x{oh}")
    del preds
    torch.cuda.empty_cache()
    say(f"PHASE product convert: DA-V2-Small (published widths, seed 0) -> {folder.name}/ "
        f"(native, {len(back)} tensors equal to the checkpoint's bit for bit); "
        f"{PRODUCT_FRAMES} frames 1920x1080 -> {ow}x{oh} Full-SBS bf16 with --model local: and "
        f"with --checkpoint: state dicts equal, outputs "
        f"{'byte-identical' if same else 'within the run-to-run spread'}, K1-K4 "
        f"{[PER_FRAME[k] * PRODUCT_FRAMES for k in RENDER_KERNELS]} launches in each; "
        f"{PRODUCT_FRAMES / walls['local']:.2f} and {PRODUCT_FRAMES / walls['checkpoint']:.2f} "
        f"fps [{card}]")

    src, dst = tmp / "product_in.vd16", tmp / "product_out.vd16"
    gen = np.random.default_rng(0)
    with Depth16Writer(src, 640, 360, 24.0) as wr:
        for _ in range(4):
            wr.write(gen.integers(0, 65536, (360, 640)).astype(np.uint16))
    rc, out = cli_run(["convert", "--depth-in", src, "--depth-out", dst])
    expect(rc == 0 and dst.read_bytes() == src.read_bytes(),
           f"convert --depth-in/--depth-out rc={rc}: not bit for bit")
    with Depth16Reader(dst) as rd:
        n = len(list(rd))
    say(f"PHASE product convert --depth-in/--depth-out: {n} frames 640x360 .vd16 round trip "
        f"bit for bit")


def product_images(card: str, tmp: Path):
    """Image-folder depth: 16 1080p PNGs, DA-V2-Small 518 bf16, batch 8, with
    the K7 opt-in (24 launches at [8, 1370, 6, 64]), then with SDPA, then
    SDPA float32 as the reference."""
    import numpy as np
    import torch

    from PIL import Image

    from visiondepth3d_tpu_torch.kernels import attention as kattn
    from visiondepth3d_tpu_torch.kernels import launch_counts, reset_launch_counts
    from visiondepth3d_tpu_torch.ops import attention as attn_ops
    from visiondepth3d_tpu_torch.pipeline.image_pipeline import process_images_in_folder

    src = tmp / "product_images"
    src.mkdir()
    for i, f in enumerate(synthetic_frames(W, H, PRODUCT_FRAMES)):
        Image.fromarray(f).save(src / f"img_{i}.png")  # Pillow's adaptive row filters
    pred = da_predictor()
    shapes, orig = [], kattn.vmem_attention

    def spy(q, k, v):
        shapes.append(tuple(q.shape))
        return orig(q, k, v)

    walls, outs = {}, {}
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    try:
        kattn.vmem_attention = spy
        for mode in ("K7", "sdpa", "f32"):
            attn_ops.USE_VMEM_KERNEL = mode == "K7"
            if mode == "f32":
                torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
            p = da_predictor("cuda", "float32") if mode == "f32" else pred
            shapes.clear()
            reset_launch_counts()
            t0 = time.perf_counter()
            n = process_images_in_folder(src, tmp / f"product_depth_{mode}", p, batch_size=8)
            torch.cuda.synchronize()
            walls[mode] = time.perf_counter() - t0
            counts = dict(launch_counts)
            want = {k: (24 if mode == "K7" and k == "vmem_attention" else 0) for k in counts}
            expect(n == PRODUCT_FRAMES and counts == want,
                   f"image folder {mode}: {n} images, launches {counts}, want {want}")
            expect(mode != "K7" or set(shapes) == {(8, 1370, 6, 64)},
                   f"K7 shapes {sorted(set(shapes))}, want [8, 1370, 6, 64]")
            outs[mode] = np.stack([
                np.asarray(Image.open(tmp / f"product_depth_{mode}" / f"img_{i}_depth.png"))
                for i in range(PRODUCT_FRAMES)]).astype(np.int16)
            expect(outs[mode].shape == (PRODUCT_FRAMES, H, W) and outs[mode].std() > 1.0,
                   f"image folder {mode}: depth images {outs[mode].shape}, flat or misshapen")
    finally:
        kattn.vmem_attention = orig
        attn_ops.USE_VMEM_KERNEL = False
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    d_k7 = float(np.abs(outs["K7"] - outs["f32"]).mean())
    d_sdpa = float(np.abs(outs["sdpa"] - outs["f32"]).mean())
    expect(d_k7 <= d_sdpa + 0.25, f"image folder: K7 {d_k7:.4f} u8 from float32, SDPA "
           f"{d_sdpa:.4f} (need K7 <= SDPA + 0.25)")
    say(f"PHASE product images: {PRODUCT_FRAMES} PNGs 1920x1080 -> 8-bit depth PNGs, "
        f"DA-V2-S 518 bf16 fast head, batch 8: K7 opt-in {PRODUCT_FRAMES / walls['K7']:.2f} "
        f"images/s (24 K7 launches at [8, 1370, 6, 64]), SDPA "
        f"{PRODUCT_FRAMES / walls['sdpa']:.2f} images/s, float32 SDPA "
        f"{PRODUCT_FRAMES / walls['f32']:.2f} images/s; mean |d| from float32: K7 {d_k7:.4f} "
        f"u8, SDPA {d_sdpa:.4f} u8 (need K7 <= SDPA + 0.25) [{card}]")


def product_verify(card: str, tmp: Path):
    """verify-checkpoints over a folder of two seeded random checkpoints."""
    import shutil

    from visiondepth3d_tpu_torch.depth.convert import save_safetensors
    from visiondepth3d_tpu_torch.enhance import EnhanceConfig, init_enhance_params
    from visiondepth3d_tpu_torch.kernels import launch_counts, reset_launch_counts

    wdir = tmp / "product_weights"
    wdir.mkdir()
    shutil.copy(tmp / "da_small.safetensors", wdir / "depth-anything-v2-small.safetensors")
    esrgan, _ = init_enhance_params(EnhanceConfig(use_esrgan=True, use_rife=False), seed=0)
    save_safetensors(wdir / "esrgan-x4.safetensors", esrgan)
    reset_launch_counts()
    t0 = time.perf_counter()
    rc, out = cli_run(["verify-checkpoints", wdir])
    wall = time.perf_counter() - t0
    counts = dict(launch_counts)
    report = json.loads((wdir / "vd3d_verify.json").read_text())
    status = {k: v["status"] for k, v in report["results"].items()}
    passed = sorted(k for k, v in status.items() if v == "pass")
    others = {v for k, v in status.items() if k not in passed}
    expect(rc == 0 and passed == ["depth-anything-v2-small", "esrgan-x4"]
           and others == {"missing"} and report["failed"] == 0,
           f"verify-checkpoints rc={rc}: {status}")
    expect(counts["conv3x3"] > 0, f"verify-checkpoints launched no K5: {counts}")
    res = report["results"]
    say(f"PHASE product verify-checkpoints: {passed} pass ({res['depth-anything-v2-small']}; "
        f"{res['esrgan-x4']['cfg']}), {report['missing']} missing, 0 failed in {wall:.1f} s; "
        f"launches {json.dumps({k: v for k, v in counts.items() if v})} [{card}]")


def write_scene_clip(path):
    """A 256x144 clip of 48 frames in three scenes (cuts at 16 and 32)."""
    import numpy as np

    from visiondepth3d_tpu_torch.io import Y4MWriter

    gen = np.random.default_rng(0)
    with Y4MWriter(str(path), 256, 144, 24.0) as wr:
        for i in range(48):
            base = gen.integers(0, 256, 3) if i in (0, 16, 32) else base
            f = np.empty((144, 256, 3), np.uint8)
            f[:] = (base + np.arange(256)[None, :, None] * (1 + i // 16) + i) % 256
            wr.write(f)


def product_host_tools(card: str, tmp: Path):
    """frames --extract / --assemble, scenes --split, --lang fr, and
    dynamic_batch_size on the card."""
    import importlib.util

    import numpy as np
    import torch

    from visiondepth3d_tpu_torch.config.i18n import catalog, set_language
    from PIL import Image

    from visiondepth3d_tpu_torch.utils.memory import device_memory_bytes, dynamic_batch_size

    clip = tmp / "product_small.y4m"
    write_clip(clip, 256, 144, 8)
    _, _, frames = read_clip(clip)
    rc, _ = cli_run(["frames", "--extract", clip, "--output", tmp / "product_frames"])
    pngs = sorted((tmp / "product_frames").iterdir())
    expect(rc == 0 and len(pngs) == 8, f"frames --extract rc={rc}, {len(pngs)} files")
    expect(all(np.array_equal(np.asarray(Image.open(p)), f) for p, f in zip(pngs, frames)),
           "the extracted PNGs are not the clip's frames")
    rc, _ = cli_run(["frames", "--assemble", tmp / "product_frames", "--output",
                     tmp / "product_assembled.y4m"])
    expect(rc == 0, f"frames --assemble rc={rc}")
    w, h, back = read_clip(tmp / "product_assembled.y4m")
    expect((w, h) == (256, 144) and back.shape == frames.shape, f"assembled {w}x{h}")
    planes = [p.astype(np.int16) for p in (read_planes(clip)[0],
                                            read_planes(tmp / "product_assembled.y4m")[0])]
    d_y = int(np.abs(planes[0] - planes[1]).max())
    expect(d_y <= 1, f"assembled Y plane {d_y} u8 from the clip's")

    scene_clip = tmp / "product_scenes.y4m"
    write_scene_clip(scene_clip)
    rc, out = cli_run(["scenes", "--input", scene_clip, "--split", "--output",
                       tmp / "product_scene_clips"])
    clips = sorted(os.listdir(tmp / "product_scene_clips"))
    expect(rc == 0 and out.startswith("3 scenes") and len(clips) == 3,
           f"scenes --split rc={rc}: {out[:200]!r}, {clips}")

    rc, out = cli_run(["--lang", "fr", "convert", "--depth-in", tmp / "product_in.vd16",
                       "--depth-out", tmp / "product_fr.vd16"])
    set_language("en")
    want = catalog("fr")["convert.depth_done"].format(count=4, output=tmp / "product_fr.vd16")
    expect(rc == 0 and out.strip() == want, f"--lang fr printed {out!r}, want {want!r}")

    total = device_memory_bytes("cuda")
    n = dynamic_batch_size((H, W), 518)
    props = torch.cuda.get_device_properties(0).total_memory
    expect(abs(total - props) <= 0.01 * props and n >= 1,
           f"device memory {total} (the device's properties: {props}), batch {n}")
    pil = importlib.util.find_spec("PIL") is not None
    mpl = importlib.util.find_spec("matplotlib") is not None
    say(f"PHASE product host tools: frames --extract/--assemble 8 frames 256x144 (PNGs equal "
        f"to the decoded frames, Y plane within {d_y} u8), scenes --split -> {len(clips)} "
        f"clips, --lang fr: {out.strip()!r}; dynamic_batch_size(1080p, 518) = {n} from "
        f"{total / 2**30:.2f} GiB of device memory [{card}]; Pillow "
        f"{'present' if pil else 'absent'}, matplotlib {'present' if mpl else 'absent'}")


def phase_product(card: str, tmp: Path):
    """The product surface: convert and local: folders, image-folder depth,
    verify-checkpoints, and the host tools."""
    for fn in (product_convert, product_images, product_verify, product_host_tools):
        t0 = time.perf_counter()
        fn(card, tmp)
        say(f"PHASE product {fn.__name__.split('_', 1)[1]} took "
            f"{time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------- serve

SERVE_FRAMES = 16
SERVE_LONG_FRAMES = 48  # the pause/resume and cancel renders


def http_json(url: str, body=None) -> dict:
    """GET url (or POST body as JSON) and parse the JSON answer."""
    import urllib.request

    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data, {"Content-Type": "application/json"},
                                 method="GET" if body is None else "POST")
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read() or b"{}")


def job_state(base: str, job_id: int) -> dict:
    return next(j for j in http_json(f"{base}/api/jobs") if j["id"] == job_id)


def wait_job(base: str, job_id: int, until=("done", "error", "cancelled"),
             timeout: float = 600.0, what: str = "") -> dict:
    """Poll /api/jobs until the job's status is one of ``until``."""
    t0 = time.perf_counter()
    while True:
        j = job_state(base, job_id)
        if j["status"] in until:
            return j
        expect(time.perf_counter() - t0 < timeout,
               f"serve {what}: job {job_id} still {j['status']} after {timeout} s")
        time.sleep(0.01)


def served_job(base: str, kind: str, params: dict, what: str) -> tuple[dict, float, dict]:
    """Submit a job over HTTP with the launch counts zeroed, wait for it to
    end, and fail the phase unless it ends done. Returns (the job, its wall
    from submit to done, the launch counts)."""
    from visiondepth3d_tpu_torch.kernels import launch_counts, reset_launch_counts

    reset_launch_counts()
    t0 = time.perf_counter()
    job = http_json(f"{base}/api/jobs", {"kind": kind, "params": params})
    j = wait_job(base, job["id"], what=what)
    wall = time.perf_counter() - t0
    counts = dict(launch_counts)
    expect(j["status"] == "done", f"serve {what}: job ended {j['status']}: {j['error']}\n"
           f"{j['progress'].get('traceback', '')}")
    return j, wall, counts


def serve_preview_run(card: str, tmp: Path, frame, depth):
    """preview's render surface in this process: the served watch loop on
    the main thread, two edits posted to it from another."""
    import urllib.request

    import numpy as np

    from visiondepth3d_tpu_torch.io import Y4MWriter
    from visiondepth3d_tpu_torch.io.depth_io import Depth16Writer
    from visiondepth3d_tpu_torch.preview import serve_preview

    clip, dep, out = tmp / "preview_clip.y4m", tmp / "preview_depth.vd16", tmp / "preview_ui"
    with Y4MWriter(str(clip), W, H, 24.0) as wr, Depth16Writer(dep, W, H, 24.0) as dw:
        for i in range(2):
            wr.write(np.roll(frame, 8 * i, axis=1))
            dw.write(np.round(np.roll(depth, 8 * i, axis=1) * 65535).astype(np.uint16))
    started, seen, errors = threading.Event(), {}, []

    def edit():
        try:
            expect(started.wait(60), "serve_preview never started")
            base = f"http://127.0.0.1:{seen['port']}"
            with urllib.request.urlopen(base + "/", timeout=30) as page:
                expect(b"vd3d preview" in page.read(), "the preview page")
            for n, patch in ((1, {"fg_shift": 9.0}), (2, {"mode": "anaglyph", "frame": 1})):
                t0 = time.perf_counter()
                while http_json(base + "/state")["renders"] < n:
                    expect(time.perf_counter() - t0 < 120, f"preview render {n} never came")
                    time.sleep(0.02)
                http_json(base + "/update", patch)
        except Exception as e:  # reported by the main thread
            errors.append(e)

    def on_start(port):
        seen["port"] = port
        started.set()

    helper = threading.Thread(target=edit, daemon=True)
    helper.start()
    t0 = time.perf_counter()
    n = serve_preview(clip, dep, out, port=0, max_renders=3, server_started=on_start,
                      device="cuda")
    wall = time.perf_counter() - t0
    helper.join(60)
    expect(not errors and not helper.is_alive(), f"serve_preview edits: {errors}")
    pngs = sorted(p.name for p in out.glob("*.png"))
    want = ["preview_anaglyph.png", "preview_depth.png", "preview_input.png", "preview_sbs.png"]
    expect(n == 3 and pngs == want, f"serve_preview: {n} renders, {pngs}")
    sess = json.loads((out / "session.json").read_text())
    expect((sess["fg_shift"], sess["mode"], sess["frame"]) == (9.0, "anaglyph", 1),
           f"serve_preview session {sess}")
    say(f"PHASE serve preview page: serve_preview(port=0, max_renders=3) on the card: 3 "
        f"renders of a 1920x1080 clip, two POST /update edits (fg_shift, then mode anaglyph "
        f"at frame 1) re-rendered, PNG set {pngs}; {wall:.2f} s [{card}]")


def serve_preview_modes(card: str, frame, depth) -> dict:
    """render_preview in every mode on the card and on the CPU (float32,
    TF32 off); returns the launch counts of one render."""
    import numpy as np
    import torch

    from visiondepth3d_tpu_torch.kernels import launch_counts, reset_launch_counts
    from visiondepth3d_tpu_torch.preview import PREVIEW_MODES, render_preview

    lines, counts, cold = [], None, None
    with no_tf32():
        for mode in PREVIEW_MODES:
            reset_launch_counts()
            t0 = time.perf_counter()
            got = render_preview(frame, depth, mode=mode, device="cuda")
            ms = 1e3 * (time.perf_counter() - t0)
            cold = ms if cold is None else cold
            counts = dict(launch_counts)
            want = {k: PER_FRAME.get(k, 0) for k in counts}  # one frame
            expect(counts == want, f"preview {mode}: launches {counts}, want {want}")
            ref = render_preview(frame, depth, mode=mode, device="cpu")
            expect(got.shape == ref.shape, f"preview {mode}: {got.shape} vs {ref.shape}")
            mean = float(np.abs(got.astype(np.int16) - ref.astype(np.int16)).mean())
            ssim = ssim_gray(got, ref)
            lines.append(f"{mode} {mean:.4f}/{ssim:.5f}")
            expect(mean <= 1.0 and ssim >= 0.99,
                   f"preview {mode}: card vs CPU mean |d| {mean} u8, SSIM {ssim}")
        warm = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            render_preview(frame, depth, mode="sbs", device="cuda")
            warm.append(1e3 * (time.perf_counter() - t0))
    say(f"PHASE serve preview: render_preview in {len(PREVIEW_MODES)} modes, 1920x1080 f32, "
        f"card vs CPU plain (TF32 off) mean |d| u8 / SSIM: {', '.join(lines)} (need <= 1 and "
        f">= 0.99); K1-K4 {[PER_FRAME[k] for k in RENDER_KERNELS]} launches per "
        f"render; {cold:.1f} ms cold (first render), {statistics.median(warm):.1f} ms warm "
        f"(median of 5, sbs; frame to the card and the PNG-ready u8 back) [{card}]")
    return counts


def serve_checkpoint(tmp: Path) -> Path:
    """DA-V2-Small's seed-0 random weights as an HF model.safetensors (the
    product phase's file when it ran)."""
    from visiondepth3d_tpu_torch.depth.convert import save_safetensors
    from visiondepth3d_tpu_torch.depth.registry import load_predictor

    ckpt = tmp / "da_small.safetensors"
    if not ckpt.exists():
        cpu = load_predictor("depth-anything-v2-small", None, inference_size=518, seed=0,
                             device="cpu")
        save_safetensors(ckpt, cpu.model.state_dict())
    return ckpt


def serve_jobs(card: str, tmp: Path, base: str) -> dict:
    """The five runners over HTTP on the card; returns each job's launches."""
    from visiondepth3d_tpu_torch.depth.convert import save_safetensors
    from visiondepth3d_tpu_torch.io.ffmpeg import have_ffmpeg
    from visiondepth3d_tpu_torch.kernels import attention as kattn
    from visiondepth3d_tpu_torch.ops import attention as attn_ops

    meta = http_json(f"{base}/api/meta")
    names = {s["name"] for s in meta["render"]["config"]}
    expect("device" not in names and {"output_format", "chunk_size"} <= names,
           f"/api/meta render fields {sorted(names)}")
    ckpt = serve_checkpoint(tmp)
    clip = tmp / "serve_1080p.y4m"
    write_clip(clip, W, H, SERVE_FRAMES)
    flags = {"format": "Full-SBS", "chunk-size": "16", "image_dtype": "bfloat16",
             "enable_healing": "true"}
    render = {"input": str(clip), "model": "depth-anything-v2-small", "checkpoint": str(ckpt),
              "output_format": "Full-SBS", "chunk_size": "16", "image_dtype": "bfloat16",
              "enable_healing": "true"}
    launches, lines = {}, []
    per_render = {k: PER_FRAME[k] * SERVE_FRAMES for k in RENDER_KERNELS}

    # 1. the fused render, against `vd3d-torch render` of the same file and flags
    served = tmp / "serve_render.y4m"
    j, wall, counts = served_job(base, "render", dict(render, output=str(served)), "render")
    want = {k: per_render.get(k, 0) for k in counts}
    expect(counts == want, f"served render launches {counts}, want {want}")
    expect(j["output"] == str(served) and j["progress"]["frames"] == SERVE_FRAMES,
           f"served render {j['output']}, {j['progress']}")
    launches["render"] = counts
    cli_out = tmp / "serve_cli.y4m"
    argv = ["render", "--input", clip, "--model", "depth-anything-v2-small", "--checkpoint",
            ckpt, "--output", cli_out] + [x for k, v in flags.items() for x in (f"--{k}", v)]
    t0 = time.perf_counter()
    rc, out = cli_run(argv)
    cli_wall = time.perf_counter() - t0
    expect(rc == 0, f"vd3d-torch render rc={rc}: {out[-500:]}")
    expect(filecmp.cmp(served, cli_out, shallow=False), "the served render differs from `vd3d-torch render` of the same flags")
    ow, oh, _ = clip_info(served)
    lines.append(f"render {SERVE_FRAMES} frames -> {ow}x{oh} Full-SBS (DA-V2-S f32 518, bf16 "
                 f"image plane) {j['progress']['fps']:.2f} fps ({wall:.2f} s from submit, "
                 f"model load included; the CLI {cli_wall:.2f} s), byte-identical to "
                 f"`vd3d-torch render`")

    # 2. the same render with depth of field: K6 once a frame
    j, wall, counts = served_job(base, "render", dict(render, output=str(tmp / "serve_dof.y4m"),
                                                      dof_strength="2.0"), "dof render")
    want = {k: per_render.get(k, 0) + (SERVE_FRAMES if k == "dof_grade" else 0)
            for k in counts}
    expect(counts == want, f"served DOF render launches {counts}, want {want}")
    launches["dof"] = counts
    lines.append(f"dof render {j['progress']['fps']:.2f} fps")

    # 3. the depth job with the K7 opt-in: 12 layers x 2 batches of 8
    shapes, orig = [], kattn.vmem_attention

    def spy(q, k, v):
        shapes.append(tuple(q.shape))
        return orig(q, k, v)

    try:
        kattn.vmem_attention, attn_ops.USE_VMEM_KERNEL = spy, True
        j, wall, counts = served_job(base, "depth", {
            "input": str(clip), "output": str(tmp / "serve_depth.y4m"),
            "model": "depth-anything-v2-small", "checkpoint": str(ckpt), "batch_size": "8",
            "inference_size": "518", "dtype": "bfloat16"}, "depth")
    finally:
        kattn.vmem_attention, attn_ops.USE_VMEM_KERNEL = orig, False
    want = {k: (24 if k == "vmem_attention" else 0) for k in counts}
    expect(counts == want and set(shapes) == {(8, 1370, 6, 64)},
           f"served depth launches {counts} at {sorted(set(shapes))}, want 24 at "
           f"[8, 1370, 6, 64]")
    expect(j["progress"]["frames"] == SERVE_FRAMES, f"served depth {j['progress']}")
    launches["depth"] = counts
    lines.append(f"depth (bf16, K7) {j['progress']['fps']:.2f} fps")

    # 4. the tools job: full-width Real-ESRGAN x4plus and practical-RIFE
    # weights from a seed, as .safetensors files, bf16
    _, ep, (rsd, _) = tools_models("bfloat16")
    save_safetensors(tmp / "serve_esrgan.safetensors", ep)
    save_safetensors(tmp / "serve_rife.safetensors", rsd)
    tclip = tmp / "serve_540p.y4m"
    write_clip(tclip, 960, 540, 3)
    j, wall, counts = served_job(base, "tools", {
        "input": str(tclip), "output": str(tmp / "serve_tools.y4m"),
        "esrgan_weights": str(tmp / "serve_esrgan.safetensors"),
        "rife_weights": str(tmp / "serve_rife.safetensors"), "use_esrgan": "true",
        "use_rife": "true", "dtype": "bfloat16"}, "tools")
    tools_out = clip_info(tmp / "serve_tools.y4m")
    expect(counts["conv3x3"] > 0 and tools_out == (960, 540, 5),
           f"served tools: launches {counts}, output (w, h, frames) {tools_out}")
    launches["tools"] = {k: v for k, v in counts.items() if v}
    lines.append(f"tools 3 -> 5 frames 960x540 {j['progress']['fps']:.2f} fps "
                 f"({counts['conv3x3']} K5 launches)")

    # 5. the scenes job
    write_scene_clip(tmp / "serve_scenes.y4m")
    j, _, _ = served_job(base, "scenes", {"input": str(tmp / "serve_scenes.y4m"),
                                          "split": "true",
                                          "output": str(tmp / "serve_scene_clips")}, "scenes")
    clips = sorted(os.listdir(tmp / "serve_scene_clips"))
    expect(j["progress"]["scenes"] == 3 and len(clips) == 3, f"served scenes {j}, {clips}")
    lines.append(f"scenes --split -> {len(clips)} clips")

    # 6. the audio job: ffmpeg only
    if have_ffmpeg():
        src = tmp / "serve_audio_src.mkv"
        subprocess.run(["ffmpeg", "-v", "error", "-y", "-f", "lavfi", "-i",
                        "sine=frequency=440:duration=1", "-f", "lavfi", "-i",
                        "testsrc=size=64x48:duration=1", "-shortest", str(src)], check=True)
        j, _, _ = served_job(base, "audio", {"input": str(src),
                                             "output": str(tmp / "serve_audio.m4a"),
                                             "codec": "aac"}, "audio")
        lines.append("audio rip done (ffmpeg present)")
    else:
        job = http_json(f"{base}/api/jobs", {"kind": "audio", "params": {
            "input": str(clip), "output": str(tmp / "serve_audio.m4a")}})
        j = wait_job(base, job["id"], what="audio")
        expect(j["status"] == "error" and "ffmpeg" in (j["error"] or ""),
               f"served audio without ffmpeg: {j['status']} {j['error']}")
        lines.append(f"audio without ffmpeg: error {j['error']!r}")

    # 7. pause and resume one render, cancel a second one mid-clip (paused
    # first, so that it cannot end before the cancel)
    long_clip = tmp / "serve_long.y4m"
    write_clip(long_clip, W, H, SERVE_LONG_FRAMES)
    ctl = dict(render, input=str(long_clip), chunk_size="8")
    a = http_json(f"{base}/api/jobs", {"kind": "render", "params": dict(
        ctl, output=str(tmp / "serve_paused.y4m"))})
    b = http_json(f"{base}/api/jobs", {"kind": "render", "params": dict(
        ctl, output=str(tmp / "serve_cancelled.y4m"))})
    statuses = {a["id"]: [], b["id"]: []}

    def pause_at(job_id, frames):
        t0 = time.perf_counter()
        while job_state(base, job_id)["progress"].get("frames", 0) < frames:
            expect(time.perf_counter() - t0 < 300, f"job {job_id} never reached {frames} "
                   f"frames: {job_state(base, job_id)}")
            time.sleep(0.005)
        http_json(f"{base}/api/jobs/{job_id}/control", {"action": "pause"})
        j = wait_job(base, job_id, until=("paused", "done", "error", "cancelled"),
                     what="pause")
        statuses[job_id].append(j["status"])
        expect(j["status"] == "paused", f"job {job_id} did not pause: {j['status']}")
        n = j["progress"]["frames"]
        time.sleep(0.5)
        j = job_state(base, job_id)
        expect(j["status"] == "paused" and j["progress"]["frames"] == n,
               f"paused job {job_id} moved: {j['status']}, {n} -> {j['progress']['frames']}")
        return n

    paused_at = pause_at(a["id"], 8)
    http_json(f"{base}/api/jobs/{a['id']}/control", {"action": "resume"})
    statuses[a["id"]].append(job_state(base, a["id"])["status"])
    ja = wait_job(base, a["id"], what="resumed render")
    statuses[a["id"]].append(ja["status"])
    expect(statuses[a["id"]] == ["paused", "running", "done"] and
           ja["progress"]["frames"] == SERVE_LONG_FRAMES, f"paused and resumed: {statuses[a['id']]}, {ja}")
    cancelled_at = pause_at(b["id"], 16)
    http_json(f"{base}/api/jobs/{b['id']}/control", {"action": "cancel"})
    jb = wait_job(base, b["id"], what="cancelled render")
    statuses[b["id"]].append(jb["status"])
    _, _, n_kept = clip_info(jb["output"])
    expect(jb["status"] == "cancelled" and n_kept == jb["progress"]["frames"] < SERVE_LONG_FRAMES
           and jb["output"].endswith(".partial.y4m")
           and not (tmp / "serve_cancelled.y4m").exists(),
           f"cancelled: {jb['status']}, {n_kept} frames in {jb['output']}, progress "
           f"{jb['progress']}")
    lines.append(f"pause/resume: paused at {paused_at} frames, statuses "
                 f"{statuses[a['id']]}, {SERVE_LONG_FRAMES} frames; cancel: paused at {cancelled_at} frames, "
                 f"then cancelled, {n_kept} frames in {Path(jb['output']).name} (progress "
                 f"{jb['progress']['frames']})")
    say(f"PHASE serve jobs over HTTP [{card}]: " + "; ".join(lines))
    return launches


def clip_info(path) -> tuple[int, int, int | None]:
    """A y4m's width, height and frame count (from its size, not decoded)."""
    from visiondepth3d_tpu_torch.io import Y4MReader

    with Y4MReader(str(path)) as rd:
        return rd.width, rd.height, rd.count()


def phase_serve(card: str, tmp: Path):
    """Preview and serve, the surfaces users drive: render_preview in its ten
    modes on a 1080p frame (card against CPU), serve_preview's page with two
    edits, then the job server on the card with its five runners over HTTP."""
    import numpy as np
    import torch

    from visiondepth3d_tpu_torch.serve import run_in_thread

    frame = synthetic_frames(W, H, 1)[0].astype(np.float32) / 255.0
    depth = smooth_depth(torch.Generator().manual_seed(0), H, W, "cpu").numpy()
    launches = {}
    t0 = time.perf_counter()
    launches["preview"] = {k: v for k, v in serve_preview_modes(card, frame, depth).items() if v}
    serve_preview_run(card, tmp, frame, depth)
    t_preview = time.perf_counter() - t0
    httpd, manager, port = run_in_thread(device="cuda")
    try:
        launches.update(serve_jobs(card, tmp, f"http://127.0.0.1:{port}"))
        final = {j["status"] for j in manager.snapshot()}
        expect(final <= {"done", "error", "cancelled"}, f"jobs not final: {final}")
    finally:
        manager.shutdown()
        httpd.shutdown()
        httpd.server_close()
    say(f"PHASE serve launches {json.dumps(launches)}")
    say(f"PHASE serve preview part {t_preview:.1f} s, jobs part "
        f"{time.perf_counter() - t0 - t_preview:.1f} s")


# ---------------------------------------------------------------- mesh, train

MESH_FRAMES = 32  # the dp render: two segments of two whole 16-frame chunks
SHARED: dict = {}  # the DepthCrafter pipeline of phase dcrafter, reused by phase mesh


def render_params():
    """The render configuration's stereo parameters (phase render's)."""
    from visiondepth3d_tpu_torch.stereo.params import StereoParams

    return StereoParams(enable_healing=True, image_dtype="bfloat16")


def split_y4m(src: Path, bounds, paths) -> None:
    """Frames [a, b) of a fixed-record y4m, each span into its own file with
    the source's header."""
    from visiondepth3d_tpu_torch.io import Y4MReader

    with Y4MReader(str(src)) as rd:
        total = rd.count()
    with open(src, "rb") as f:
        header = f.readline()
        body = f.read()
    rec = len(body) // total
    for (a, b), path in zip(bounds, paths):
        Path(path).write_bytes(header + body[a * rec: b * rec])


def y4m_body(path) -> bytes:
    """A y4m's frame records (the bytes after its header line)."""
    with open(path, "rb") as f:
        f.readline()
        return f.read()


def counted(fn):
    """(fn()'s result, wall s, launch counts): the counts zeroed just before
    the call and read just after it."""
    import torch

    from visiondepth3d_tpu_torch.kernels import launch_counts, reset_launch_counts

    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, dict(launch_counts)


def phase_mesh(card: str, tmp: Path) -> dict:
    """The mesh routes over [cuda:0, cuda:0] (one card twice: what dp=2 costs
    over one device, not how it scales): the dp=2 render against its
    per-segment twin, the pp=2 render against the fused render, the dp=2
    depth route (K7 opt-in) against one device at the per-device batch and
    at the whole batch, dp=2 frame tools against one device, and
    DepthCrafter's window-parallel denoise at dp=2 against dp=1."""
    import numpy as np
    import torch

    from visiondepth3d_tpu_torch.enhance.pipeline import run_merged_pipeline
    from visiondepth3d_tpu_torch.ops import attention as attn_ops
    from visiondepth3d_tpu_torch.parallel import make_mesh, segment_bounds
    from visiondepth3d_tpu_torch.pipeline.depth_pipeline import (DepthConfig,
                                                                 render_depth_video_file)
    from visiondepth3d_tpu_torch.pipeline.stereo_pipeline import (RenderConfig,
                                                                  render_stereo_video)

    dev = torch.device("cuda", 0)
    devices = [dev, dev]
    where = f"devices {[str(d) for d in devices]}"
    pred = da_predictor()
    params = render_params()
    base = RenderConfig(output_format="Full-SBS", output_height=1080, chunk_size=16,
                        device="cuda")
    launches = {}

    # 1. dp=2 render, 32 frames: each segment two whole chunks, nothing padded
    clip = tmp / "mesh_1080p.y4m"
    write_clip(clip, W, H, MESH_FRAMES)
    render_stereo_video(warm_clip(tmp), None, tmp / "mesh_warm.y4m", params,
                        dataclasses.replace(base, mesh="dp=2"), predictor=pred, devices=devices)
    dp_cfg = dataclasses.replace(base, mesh="dp=2")
    out = tmp / "mesh_dp.y4m"
    prog, wall, counts = counted(lambda: render_stereo_video(
        clip, None, out, params, dp_cfg, predictor=pred, devices=devices))
    want = {k: PER_FRAME.get(k, 0) * MESH_FRAMES for k in counts}
    expect(counts == want, f"dp render launches {counts}, want {want}")
    expect(prog.frames_done == MESH_FRAMES, f"dp render: {prog.frames_done} frames")
    launches["dp render"] = {k: v for k, v in counts.items() if v}
    bounds = segment_bounds(MESH_FRAMES, 2)
    segs = [tmp / f"mesh_seg{g}.y4m" for g in range(2)]
    split_y4m(clip, bounds, segs)
    one = dataclasses.replace(base, mesh="off")
    for g, seg in enumerate(segs):
        render_stereo_video(seg, None, tmp / f"mesh_seg{g}_out.y4m", params, one, predictor=pred)
    twin = b"".join(y4m_body(tmp / f"mesh_seg{g}_out.y4m") for g in range(2))
    same = y4m_body(out) == twin
    prof = device_profile(lambda: render_stereo_video(clip, None, tmp / "mesh_dp_prof.y4m",
                                                      params, dp_cfg, predictor=pred,
                                                      devices=devices))
    dev_ms = "not measured" if prof is None else f"{prof['device_ms'] / MESH_FRAMES:.3f} ms"
    _, wall1, _ = counted(lambda: render_stereo_video(clip, None, tmp / "mesh_one.y4m", params,
                                                      one, predictor=pred))
    say(f"PHASE mesh dp render: dp=2 over {where}, {MESH_FRAMES} frames 1920x1080 -> Full-SBS "
        f"(DA-V2-S 518 bf16 fast head, chunks of 16; segments {bounds}): "
        f"{MESH_FRAMES / wall:.2f} fps (one device, same clip: {MESH_FRAMES / wall1:.2f} fps), "
        f"device time per frame {dev_ms}; byte-identical to the two segments rendered alone "
        f"and concatenated: {same}; launches {json.dumps(launches['dp render'])} [{card}]")
    expect(same, "the dp=2 render differs from its per-segment twin")

    # 2. pp=2 render, 16 frames, against the fused render
    pp_clip = warm_clip(tmp)
    pp_cfg = dataclasses.replace(base, mesh="pp=2")
    prog, wall, counts = counted(lambda: render_stereo_video(
        pp_clip, None, tmp / "mesh_pp.y4m", params, pp_cfg, predictor=pred, devices=devices))
    want = {k: PER_FRAME.get(k, 0) * 16 for k in counts}
    expect(counts == want, f"pp render launches {counts}, want {want}")
    launches["pp render"] = {k: v for k, v in counts.items() if v}
    render_stereo_video(pp_clip, None, tmp / "mesh_pp_one.y4m", params, one, predictor=pred)
    same = (tmp / "mesh_pp.y4m").read_bytes() == (tmp / "mesh_pp_one.y4m").read_bytes()
    say(f"PHASE mesh pp render: pp=2 over {where}, 16 frames -> Full-SBS: {16 / wall:.2f} fps; "
        f"byte-identical to the single-device fused render: {same}; launches "
        f"{json.dumps(launches['pp render'])} [{card}]")
    expect(same, "the pp=2 render differs from the fused render")

    # 3. dp=2 depth route, K7 opt-in: 16 frames, batch 8 split 4 + 4
    dclip = tmp / "mesh_depth.y4m"
    write_clip(dclip, W, H, 16)
    dcfg = DepthConfig(batch_size=8, dtype="bfloat16", device="cuda")
    layers = pred.cfg.backbone.num_layers
    try:
        attn_ops.USE_VMEM_KERNEL = True
        render_depth_video_file(dclip, tmp / "mesh_depth_warm.y4m",
                                dataclasses.replace(dcfg, mesh="dp=2"), predictor=pred,
                                devices=devices)
        n, wall, counts = counted(lambda: render_depth_video_file(
            dclip, tmp / "mesh_depth_dp.y4m", dataclasses.replace(dcfg, mesh="dp=2"),
            predictor=pred, devices=devices))
        want = {k: (layers * 4 if k == "vmem_attention" else 0) for k in counts}
        expect(n == 16 and counts == want, f"dp depth: {n} frames, launches {counts}, "
                                           f"want {want}")
        launches["dp depth"] = {k: v for k, v in counts.items() if v}
        for b in (4, 8):
            render_depth_video_file(dclip, tmp / f"mesh_depth_b{b}.y4m",
                                    dataclasses.replace(dcfg, batch_size=b, mesh="off"),
                                    predictor=pred)
    finally:
        attn_ops.USE_VMEM_KERNEL = False
    same = y4m_body(tmp / "mesh_depth_dp.y4m") == y4m_body(tmp / "mesh_depth_b4.y4m")
    got, whole = (read_clip(tmp / p)[2][..., 0] for p in ("mesh_depth_dp.y4m",
                                                          "mesh_depth_b8.y4m"))
    dm = float(np.abs(got.astype(np.int16) - whole.astype(np.int16)).mean())
    ssim = min(ssim_gray(a, b) for a, b in zip(got[::8], whole[::8]))
    say(f"PHASE mesh dp depth: dp=2 over {where}, 16 frames 1080p, batch 8 (4 + 4), K7 opt-in: "
        f"{16 / wall:.2f} fps; byte-identical to one device at batch 4: {same}; against one "
        f"device at batch 8 mean |d| {dm:.4f} u8 (need <= 1), min SSIM {ssim:.5f} (need >= "
        f"0.99); K7 launches {counts['vmem_attention']} at [4, 1370, 6, 64] (want "
        f"{layers * 4}) [{card}]")
    expect(same and dm <= 1.0 and ssim >= 0.99,
           f"dp depth: identical {same}, mean |d| {dm:.4f}, SSIM {ssim:.5f}")

    # 4. dp=2 frame tools: 4 frames of 960x540, bf16, chunks of 4 pairs, each
    # device 2; the twin is one device at chunks of 2 pairs (the same pairs
    # in each call: the library convs are not batch-invariant, phase rifebatch)
    tcfg, ep, rp = tools_models("bfloat16")
    tclip = tmp / "mesh_tools.y4m"
    write_clip(tclip, TOOLS_W, TOOLS_H, 4)
    run_merged_pipeline(tclip, tmp / "mesh_tools_one.y4m",
                        dataclasses.replace(tcfg, chunk_size=tcfg.chunk_size // 2), ep, rp,
                        device=dev)
    n, wall, counts = counted(lambda: run_merged_pipeline(
        tclip, tmp / "mesh_tools_dp.y4m", tcfg, ep, rp, mesh_axes={"dp": 2}, device=dev,
        devices=devices))
    launches["dp tools"] = {k: v for k, v in counts.items() if v}
    same = (tmp / "mesh_tools_dp.y4m").read_bytes() == (tmp / "mesh_tools_one.y4m").read_bytes()
    say(f"PHASE mesh dp tools: dp=2 over {where}, 4 frames 960x540 -> {n} (ESRGAN x4 + RIFE "
        f"x2, bf16, chunks of {tcfg.chunk_size} pairs): {n / wall:.3f} fps out; byte-identical "
        f"to one device at chunks of {tcfg.chunk_size // 2}: {same}; launches "
        f"{json.dumps(launches['dp tools'])} [{card}]")
    expect(same and counts["conv3x3"] > 0, f"dp tools: identical {same}, launches {counts}")

    # 5. DepthCrafter window-parallel: 3 windows at 512x288, 2 steps, bf16
    from visiondepth3d_tpu_torch.depth.diffusion import build_random_depthcrafter

    pipe = SHARED.pop("dcrafter", None)  # freed when this phase ends
    built = pipe is None
    if built:
        pipe = build_random_depthcrafter(0, dtype="bfloat16", device="cuda")
    t_frames = 50  # windows at 0, 18 and 26 (window 24, overlap 6)
    g = torch.Generator().manual_seed(7)
    frames = torch.rand(t_frames, 288, 512, 3, generator=g).to(dev)
    mesh = make_mesh(dp=2, devices=devices)
    outs, walls = {}, {}
    try:
        attn_ops.USE_VMEM_KERNEL = True
        pipe.run_raw_parallel(frames, seed=0, mesh=mesh)  # warm-up: K7 and cuDNN's plans
        for name, m in (("dp=1", None), ("dp=2", mesh)):
            d, walls[name], counts = counted(lambda: pipe.run_raw_parallel(frames, seed=0,
                                                                          mesh=m))
            outs[name] = d
    finally:
        attn_ops.USE_VMEM_KERNEL = False
    launches["dcrafter windows"] = {k: v for k, v in counts.items() if v}

    def u8(d):
        d = (d - d.min()) / (d.max() - d.min()).clamp(min=1e-9)
        return (d * 255.0 + 0.5).clamp(0, 255).to(torch.uint8).cpu().numpy().astype(np.int16)

    dm = float(np.abs(u8(outs["dp=2"]) - u8(outs["dp=1"])).mean())
    finite = bool(torch.isfinite(outs["dp=2"]).all())
    source = "built in this phase" if built else "phase dcrafter's pipeline"
    say(f"PHASE mesh DepthCrafter window-parallel ({source}, published widths, bf16, 2 "
        f"steps): {t_frames} frames 512x288, "
        f"{len(pipe._windows(t_frames))} windows; dp=1 {walls['dp=1']:.2f} s, dp=2 over {where} "
        f"{walls['dp=2']:.2f} s; min-max u8 mean |d| dp=2 vs dp=1 {dm:.4f} (need <= 1), finite "
        f"{finite}; K7 launches at dp=2 {counts['vmem_attention']} [{card}]")
    expect(finite and dm <= 1.0, f"DepthCrafter dp=2 vs dp=1: mean |d| {dm:.4f} u8")
    mesh_sharded(card, tmp, pred, params, base, launches, dcrafter=(pipe, frames))
    say(f"PHASE mesh launches {json.dumps(launches)}")
    return launches


def band_launches(frames: int, bands: int, dof: bool = False) -> dict:
    """The kernel launches of a render whose stereo step runs in row bands:
    K1, K2 (and K6) once per band per frame; K3's band form twice and K4's
    three times per band per frame, each finish once per use per frame."""
    want = {"stereo_warp": frames * bands, "feather_heal": frames * bands,
            "quantile_hist_band": 2 * frames * bands, "quantile_pair_finish": 2 * frames,
            "subject_hist_band": 3 * frames * bands, "subject_stats_finish": 3 * frames}
    if dof:
        want["dof_grade"] = frames * bands
    return want


def gray_diff(a_path, b_path, every: int = 8) -> tuple[float, float]:
    """(mean |d| in u8 over the first channel of every frame, min SSIM over
    every `every`-th frame) of two y4m clips."""
    import numpy as np

    a, b = (read_clip(p)[2][..., 0] for p in (a_path, b_path))
    expect(a.shape == b.shape, f"clip shapes {a.shape} and {b.shape}")
    dm = float(np.abs(a.astype(np.int16) - b.astype(np.int16)).mean())
    return dm, min(ssim_gray(x, y) for x, y in zip(a[::every], b[::every]))


def mesh_sharded(card: str, tmp: Path, pred, params, base, launches: dict, dcrafter=None):
    """The row- and tensor-sharded meshes on cuda:0 repeated (their
    overhead, not their scaling), each against its one-device twin:
    sp=2 fused render (16 frames of 1080p, the model on each device's 8
    frames, the stereo step in two row bands), byte for byte against one
    device at chunks of 8 (the model's batch per device), and within mean
    |d| <= 1 u8 and SSIM >= 0.99 of one device at chunks of 16; sp=2 with
    depth of field; dp=2,sp=2 (32 frames) against the segments alone;
    pp=2,dp=2 (16 frames) against one device at chunks of 8; sp=2 at
    3840x2160 (8 frames, the size sp exists for) against one device at
    chunks of 4; the tp=2 depth route (K7 opt-in, batch 8: K7 at [8, 1370,
    3, 64] twice a layer), in bf16 no further from the float32 one-device
    route than one device in bf16 (+ 0.25 u8) and within SSIM 0.99 of it,
    in float32 within mean |d| <= 0.5 u8 and SSIM >= 0.995 of one device;
    the tp=2 fused render within mean |d| <= 1 u8 and SSIM >= 0.99 of one
    device. Launches counted on each. ``dcrafter``: (the mesh phase's
    DepthCrafter pipeline, its 50 frames) for ``mesh_sp_depth``."""
    import torch

    from visiondepth3d_tpu_torch.ops import attention as attn_ops
    from visiondepth3d_tpu_torch.pipeline.depth_pipeline import (DepthConfig,
                                                                 render_depth_video_file)
    from visiondepth3d_tpu_torch.pipeline.stereo_pipeline import render_stereo_video

    dev = torch.device("cuda", 0)
    clip = warm_clip(tmp)
    one8 = dataclasses.replace(base, mesh="off", chunk_size=8)
    one16 = dataclasses.replace(base, mesh="off")

    def render(src, out, cfg, n_dev, p=params, **kw):
        return counted(lambda: render_stereo_video(src, None, tmp / out, p, cfg, predictor=pred,
                                                   devices=[dev] * n_dev, **kw))

    def check(counts, want, what):
        got = {k: v for k, v in counts.items() if v}
        expect(got == want, f"{what} launches {got}, want {want}")
        launches[what] = got

    # 1. sp=2 fused render, 16 frames
    sp_cfg = dataclasses.replace(base, mesh="sp=2")
    render(clip, "sp_warm.y4m", sp_cfg, 2)
    _, wall, counts = render(clip, "sp.y4m", sp_cfg, 2)
    check(counts, band_launches(16, 2), "sp render")
    render(clip, "sp_one8.y4m", one8, 1)
    _, wall1, _ = render(clip, "sp_one16.y4m", one16, 1)
    same = y4m_body(tmp / "sp.y4m") == y4m_body(tmp / "sp_one8.y4m")
    dm, ssim = gray_diff(tmp / "sp.y4m", tmp / "sp_one16.y4m")
    prof = device_profile(lambda: render_stereo_video(clip, None, tmp / "sp_prof.y4m", params,
                                                      sp_cfg, predictor=pred,
                                                      devices=[dev, dev]))
    prof1 = device_profile(lambda: render_stereo_video(clip, None, tmp / "one_prof.y4m",
                                                       params, one16, predictor=pred))

    def per_frame(p):
        return "not measured" if p is None else f"{p['device_ms'] / 16:.3f} ms"

    say(f"PHASE mesh sp render: sp=2 over [cuda:0, cuda:0], 16 frames 1920x1080 -> Full-SBS "
        f"(DA-V2-S 518 bf16, chunks of 16: 8 frames a device for the model, two row bands of "
        f"540 for the stereo step): {16 / wall:.2f} fps (one device {16 / wall1:.2f}), device "
        f"time per frame {per_frame(prof)} (one device {per_frame(prof1)}); byte-identical to "
        f"one device at chunks of 8: {same}; against chunks of 16 mean |d| {dm:.4f} u8 (need "
        f"<= 1), min SSIM {ssim:.5f} (need >= 0.99); launches "
        f"{json.dumps(launches['sp render'])} [{card}]")
    expect(same and dm <= 1.0 and ssim >= 0.99,
           f"sp render: identical {same}, mean |d| {dm:.4f}, SSIM {ssim:.5f}")

    # 2. sp=2 with depth of field
    dof = params.replace(dof_strength=2.0)
    _, wall, counts = render(clip, "sp_dof.y4m", sp_cfg, 2, p=dof)
    check(counts, band_launches(16, 2, dof=True), "sp DOF render")
    render(clip, "sp_dof_one8.y4m", one8, 1, p=dof)
    same = y4m_body(tmp / "sp_dof.y4m") == y4m_body(tmp / "sp_dof_one8.y4m")
    say(f"PHASE mesh sp DOF render: sp=2, dof_strength 2, 16 frames: {16 / wall:.2f} fps; "
        f"byte-identical to one device at chunks of 8: {same}; launches "
        f"{json.dumps(launches['sp DOF render'])} [{card}]")
    expect(same, "the sp=2 DOF render differs from one device")

    # 3. dp=2,sp=2 over the card 4 times: 32 frames, two segments of 16
    seg_cfg = dataclasses.replace(base, mesh="dp=2,sp=2")
    _, wall, counts = render(tmp / "mesh_1080p.y4m", "dpsp.y4m", seg_cfg, 4)
    check(counts, band_launches(MESH_FRAMES, 2), "dp x sp render")
    for g in range(2):
        render(tmp / f"mesh_seg{g}.y4m", f"dpsp_seg{g}.y4m", one8, 1)
    twin = b"".join(y4m_body(tmp / f"dpsp_seg{g}.y4m") for g in range(2))
    same = y4m_body(tmp / "dpsp.y4m") == twin
    say(f"PHASE mesh dp x sp render: dp=2,sp=2 over [cuda:0] * 4, {MESH_FRAMES} frames: "
        f"{MESH_FRAMES / wall:.2f} fps; byte-identical to the segments alone at chunks of 8: "
        f"{same}; launches {json.dumps(launches['dp x sp render'])} [{card}]")
    expect(same, "the dp=2,sp=2 render differs from its segments")

    # 4. pp=2,dp=2 over the card 4 times: 16 frames
    pp_cfg = dataclasses.replace(base, mesh="pp=2,dp=2")
    _, wall, counts = render(clip, "ppdp.y4m", pp_cfg, 4)
    check(counts, band_launches(16, 2), "pp x dp render")
    same = y4m_body(tmp / "ppdp.y4m") == y4m_body(tmp / "sp_one8.y4m")
    say(f"PHASE mesh pp x dp render: pp=2,dp=2 over [cuda:0] * 4 (slice A: the frames split "
        f"over 2, slice B: 2 row bands), 16 frames: {16 / wall:.2f} fps; byte-identical to "
        f"one device at chunks of 8: {same}; launches "
        f"{json.dumps(launches['pp x dp render'])} [{card}]")
    expect(same, "the pp=2,dp=2 render differs from one device")

    # 5. sp=2 at 3840x2160, 8 frames, the eye at the source size
    clip4k = tmp / "clip_2160p.y4m"
    write_clip(clip4k, 3840, 2160, 8)
    cfg4k = dataclasses.replace(base, preserve_original_aspect=True, chunk_size=8)
    sp4k = dataclasses.replace(cfg4k, mesh="sp=2")
    render(clip4k, "sp4k_warm.y4m", sp4k, 2)
    _, wall, counts = render(clip4k, "sp4k.y4m", sp4k, 2)
    check(counts, band_launches(8, 2), "sp 2160p render")
    render(clip4k, "sp4k_one4.y4m", dataclasses.replace(cfg4k, mesh="off", chunk_size=4), 1)
    _, wall1, _ = render(clip4k, "sp4k_one8.y4m", dataclasses.replace(cfg4k, mesh="off"), 1)
    same = y4m_body(tmp / "sp4k.y4m") == y4m_body(tmp / "sp4k_one4.y4m")
    say(f"PHASE mesh sp 2160p render: sp=2, 8 frames 3840x2160 -> 7680x2160 Full-SBS (two "
        f"row bands of 1080): {8 / wall:.2f} fps (one device {8 / wall1:.2f}); byte-identical "
        f"to one device at chunks of 4: {same} [{card}]")
    expect(same, "the 2160p sp=2 render differs from one device")

    # 6. tp=2 depth route, K7 opt-in: 16 frames, batch 8
    layers = pred.cfg.backbone.num_layers
    dcfg = DepthConfig(batch_size=8, dtype="bfloat16", device="cuda", mesh="tp=2")
    shapes = []
    spy_of = attn_ops.kattention.vmem_attention

    def spy(q, k, v):
        shapes.append(tuple(q.shape))
        return spy_of(q, k, v)

    try:
        attn_ops.USE_VMEM_KERNEL = True
        attn_ops.kattention.vmem_attention = spy
        render_depth_video_file(tmp / "mesh_depth.y4m", tmp / "tp_depth_warm.y4m", dcfg,
                                predictor=pred, devices=[dev, dev])
        shapes.clear()
        n, wall, counts = counted(lambda: render_depth_video_file(
            tmp / "mesh_depth.y4m", tmp / "tp_depth.y4m", dcfg, predictor=pred,
            devices=[dev, dev]))
    finally:
        attn_ops.USE_VMEM_KERNEL = False
        attn_ops.kattention.vmem_attention = spy_of
    check(counts, {"vmem_attention": layers * 2 * 2}, "tp depth")
    expect(n == 16 and set(shapes) == {(8, 1370, 3, 64)}, f"tp depth: {n} frames, K7 at "
                                                          f"{sorted(set(shapes))}")
    # The split sums each row-wise GEMM's float32 partials in another order
    # than one GEMM does, so about 0.02-0.08 % of a block's bf16 outputs
    # move by one ulp; the random-weight model amplifies such moves as it
    # amplifies bf16 against float32. So in bf16 the split is held, as K7 is
    # (phase depth), to be no further from the float32 one-device route than
    # one device in bf16 is (+ 0.25 u8), and within SSIM 0.99 of it; in
    # float32 (TF32 off, SDPA) the split is held within mean |d| <= 0.5 u8
    # and SSIM >= 0.995 of one device.
    f32 = da_predictor("cuda", "float32")
    fcfg = DepthConfig(batch_size=8, device="cuda", mesh="off")
    with no_tf32():
        render_depth_video_file(tmp / "mesh_depth.y4m", tmp / "tp_depth_f32_one.y4m", fcfg,
                                predictor=f32)
        render_depth_video_file(tmp / "mesh_depth.y4m", tmp / "tp_depth_f32.y4m",
                                dataclasses.replace(fcfg, mesh="tp=2"), predictor=f32,
                                devices=[dev, dev])
    dm, ssim = gray_diff(tmp / "tp_depth.y4m", tmp / "mesh_depth_b8.y4m", every=4)
    d_tp, _ = gray_diff(tmp / "tp_depth.y4m", tmp / "tp_depth_f32_one.y4m", every=16)
    d_one, _ = gray_diff(tmp / "mesh_depth_b8.y4m", tmp / "tp_depth_f32_one.y4m", every=16)
    dm32, ssim32 = gray_diff(tmp / "tp_depth_f32.y4m", tmp / "tp_depth_f32_one.y4m", every=4)
    say(f"PHASE mesh tp depth: tp=2 over [cuda:0, cuda:0], 16 frames 1080p, batch 8, K7 opt-in "
        f"(K7 at [8, 1370, 3, 64], {counts['vmem_attention']} launches): {16 / wall:.2f} fps; "
        f"bf16 against one device mean |d| {dm:.4f} u8, min SSIM {ssim:.5f} (need >= 0.99); "
        f"against the float32 one-device route tp=2 bf16 {d_tp:.4f} u8, one device bf16 "
        f"{d_one:.4f} u8 (need tp <= one device + 0.25); float32 (TF32 off) tp=2 against one "
        f"device mean |d| {dm32:.4f} u8 (need <= 0.5), min SSIM {ssim32:.5f} (need >= 0.995) "
        f"[{card}]")
    expect(ssim >= 0.99 and d_tp <= d_one + 0.25 and dm32 <= 0.5 and ssim32 >= 0.995,
           f"tp depth: bf16 mean |d| {dm:.4f}, SSIM {ssim:.5f}, {d_tp:.4f} vs {d_one:.4f} "
           f"from float32; float32 {dm32:.4f}, SSIM {ssim32:.5f}")

    # 7. tp=2 fused render, 16 frames
    tp_cfg = dataclasses.replace(base, mesh="tp=2")
    render(clip, "tp_warm.y4m", tp_cfg, 2)
    _, wall, counts = render(clip, "tp.y4m", tp_cfg, 2)
    check(counts, {k: v * 16 for k, v in PER_FRAME.items()}, "tp render")
    dm, ssim = gray_diff(tmp / "tp.y4m", tmp / "sp_one16.y4m")
    say(f"PHASE mesh tp render: tp=2 over [cuda:0, cuda:0], 16 frames: {16 / wall:.2f} fps; "
        f"against one device mean |d| {dm:.4f} u8 (need <= 1), min SSIM {ssim:.5f} (need >= "
        f"0.99); launches {json.dumps(launches['tp render'])} [{card}]")
    expect(dm <= 1.0 and ssim >= 0.99, f"tp render: mean |d| {dm:.4f}, SSIM {ssim:.5f}")

    # 8. the row-sharded depth route: sp=2, dp=2,sp=2, and sp=2 at 924^2
    t0 = time.perf_counter()
    mesh_sp_depth(card, tmp, pred, f32, launches, dcrafter)
    say(f"PHASE mesh sp depth cases took {time.perf_counter() - t0:.1f} s")


SP_DEPTH_BANDS = {(667, 1370), (703, 1370)}  # 518^2 over 2 bands: (Nq, Nk) of each


def mesh_sp_depth(card: str, tmp: Path, pred, f32, launches: dict, dcrafter=None):
    """The depth route with the model row-sharded (``parallel/sp.py``) on
    cuda:0 repeated (the mesh's overhead, not its scaling), each against
    one device: sp=2 over 16 1080p frames (DA-V2-S 518^2, batch 8) with
    SDPA and with the K7 opt-in (K7's query-band form, 12 layers x 2 bands
    x 2 batches = 48 launches at [8, 667, 6, 64] and [8, 703, 6, 64]
    against 1370 keys), in bf16 no further from the float32 one-device
    route than one device in bf16 (+ 0.25 u8) and within SSIM 0.99 of one
    device on the same attention, in float32 (TF32 off; SDPA and K7)
    within mean |d| <= 0.5 u8 and SSIM >= 0.995 of one device; fps and
    device time (and its concatenation kernels: the gathers) beside one
    device; dp=2,sp=2 over the card 4 times (K7: 96 launches at [4, 667|703,
    6, 64]) held as sp=2 against one device at batch 4; sp=2 at 924^2 (4
    frames; N = 4357, SDPA whatever the flags) held as the bf16 cases,
    with the peak memory of both. Then sp where the model is not
    row-sharded (``sp_lifted``)."""
    import torch

    from visiondepth3d_tpu_torch.ops import attention as attn_ops
    from visiondepth3d_tpu_torch.pipeline.depth_pipeline import (DepthConfig,
                                                                 render_depth_video_file)

    dev = torch.device("cuda", 0)
    clip = tmp / "mesh_depth.y4m"
    layers = pred.cfg.backbone.num_layers
    bf16 = DepthConfig(batch_size=8, dtype="bfloat16", device="cuda", mesh="sp=2")
    one = dataclasses.replace(bf16, mesh="off")
    shapes = []
    spy_of = attn_ops.kattention.vmem_attention

    def spy(q, k, v):
        shapes.append((q.shape[0], q.shape[1], k.shape[1]))
        return spy_of(q, k, v)

    def run(out, cfg, predictor, n_dev, k7, src=clip, profile=False):
        """(frames, wall s, launch counts) of one route run, or its device
        profile; K7's calls' (B, Nq, Nk) in ``shapes``."""
        attn_ops.USE_VMEM_KERNEL = k7
        attn_ops.kattention.vmem_attention = spy
        shapes.clear()
        try:
            call = lambda: render_depth_video_file(src, tmp / out, cfg, predictor=predictor,
                                                   devices=[dev] * n_dev)
            return device_profile(call) if profile else counted(call)
        finally:
            attn_ops.USE_VMEM_KERNEL = False
            attn_ops.kattention.vmem_attention = spy_of

    def nonzero(counts):
        return {k: v for k, v in counts.items() if v}

    def held(sp_path, one_path, f32_path, what):
        """bf16: sp no further from float32 than one device (+ 0.25 u8),
        SSIM >= 0.99 to one device."""
        d_sp, _ = gray_diff(tmp / sp_path, tmp / f32_path, every=16)
        d_one, _ = gray_diff(tmp / one_path, tmp / f32_path, every=16)
        dm, ssim = gray_diff(tmp / sp_path, tmp / one_path, every=4)
        expect(d_sp <= d_one + 0.25 and ssim >= 0.99,
               f"{what}: {d_sp:.4f} u8 from float32 against one device's {d_one:.4f}, SSIM "
               f"{ssim:.5f}")
        return (f"against one device mean |d| {dm:.4f} u8, min SSIM {ssim:.5f} (need >= 0.99); "
                f"from the float32 one-device route sp {d_sp:.4f} u8, one device {d_one:.4f} u8 "
                f"(need sp <= one device + 0.25)")

    # sp=2, K7 opt-in, bf16
    run("sp_depth_warm.y4m", bf16, pred, 2, True)
    n, wall, counts = run("sp_depth_k7.y4m", bf16, pred, 2, True)
    launches["sp depth"] = nonzero(counts)
    k7_at = sorted(set(shapes))
    expect(n == 16 and nonzero(counts) == {"vmem_attention": layers * 2 * 2}
           and k7_at == sorted((8, *b) for b in SP_DEPTH_BANDS),
           f"sp depth: {n} frames, launches {nonzero(counts)}, K7 at {k7_at}")
    _, wall1, _ = run("sp_depth_one_k7.y4m", one, pred, 1, True)
    prof, prof1 = (run(f"sp_depth_prof{i}.y4m", cfg, pred, nd, True, profile=True)
                   for i, (cfg, nd) in enumerate(((bf16, 2), (one, 1))))

    def dev_ms(p):
        return ("not measured" if p is None else
                f"{p['device_ms'] / 16:.3f} ms ({p['cat_ms'] / 16:.3f} in concatenation "
                f"kernels, {p['events']} events)")

    line = held("sp_depth_k7.y4m", "mesh_depth_b8.y4m", "tp_depth_f32_one.y4m", "sp depth K7")
    say(f"PHASE mesh sp depth: sp=2 over [cuda:0, cuda:0], 16 frames 1080p, DA-V2-S 518^2 "
        f"bf16 batch 8, K7 opt-in (K7's band form {counts['vmem_attention']} launches at "
        f"{k7_at} (B, Nq, Nk)): {16 / wall:.2f} fps (one device "
        f"{16 / wall1:.2f}), device time per frame {dev_ms(prof)} (one device "
        f"{dev_ms(prof1)}); {line} [{card}]")

    # sp=2, SDPA, bf16
    n, wall, counts = run("sp_depth_sdpa.y4m", bf16, pred, 2, False)
    expect(n == 16 and not nonzero(counts), f"sp depth SDPA: launches {nonzero(counts)}")
    _, wall1, _ = run("sp_depth_sdpa_one.y4m", one, pred, 1, False)
    line = held("sp_depth_sdpa.y4m", "sp_depth_sdpa_one.y4m", "tp_depth_f32_one.y4m",
                "sp depth SDPA")
    say(f"PHASE mesh sp depth SDPA: sp=2, 16 frames, bf16: {16 / wall:.2f} fps (one device "
        f"{16 / wall1:.2f}); {line} [{card}]")

    # sp=2 in float32, TF32 off, SDPA and K7
    fcfg = DepthConfig(batch_size=8, device="cuda", mesh="sp=2")
    with no_tf32():
        for k7 in (False, True):
            name = "K7" if k7 else "SDPA"
            n, wall, counts = run(f"sp_depth_f32_{name}.y4m", fcfg, f32, 2, k7)
            expect(nonzero(counts) == ({"vmem_attention": layers * 4} if k7 else {}),
                   f"sp depth f32 {name}: launches {nonzero(counts)}")
            dm, ssim = gray_diff(tmp / f"sp_depth_f32_{name}.y4m", tmp / "tp_depth_f32_one.y4m",
                                 every=4)
            say(f"PHASE mesh sp depth float32 {name}: sp=2, 16 frames, TF32 off: "
                f"{16 / wall:.2f} fps; against the float32 one-device route (SDPA) mean |d| "
                f"{dm:.4f} u8 (need <= 0.5), min SSIM {ssim:.5f} (need >= 0.995); launches "
                f"{json.dumps(nonzero(counts))} [{card}]")
            expect(dm <= 0.5 and ssim >= 0.995,
                   f"sp depth f32 {name}: mean |d| {dm:.4f}, SSIM {ssim:.5f}")

    # dp=2,sp=2 over the card 4 times: each dp run 4 frames of a batch in 2 bands
    n, wall, counts = run("dpsp_depth.y4m", dataclasses.replace(bf16, mesh="dp=2,sp=2"), pred,
                          4, True)
    launches["dp x sp depth"] = nonzero(counts)
    expect(n == 16 and nonzero(counts) == {"vmem_attention": layers * 2 * 2 * 2}
           and set(shapes) == {(4, *b) for b in SP_DEPTH_BANDS},
           f"dp x sp depth: launches {nonzero(counts)}, K7 at {sorted(set(shapes))}")
    line = held("dpsp_depth.y4m", "mesh_depth_b4.y4m", "tp_depth_f32_one.y4m", "dp x sp depth")
    say(f"PHASE mesh dp x sp depth: dp=2,sp=2 over [cuda:0] * 4, 16 frames, batch 8 (4 + 4, "
        f"each in 2 bands), K7 opt-in ({counts['vmem_attention']} launches): {16 / wall:.2f} "
        f"fps; against one device at batch 4: {line} [{card}]")

    # sp=2 at 924^2: N = 66 x 66 + 1 = 4357 tokens, SDPA whatever the flags
    big = tmp / "depth_924.y4m"
    write_clip(big, W, H, 4)
    p924, f924 = (da_predictor("cuda", t, size=924) for t in ("bfloat16", "float32"))
    peaks = {}
    for name, cfg, nd in (("one", one, 1), ("sp", bf16, 2)):
        run(f"d924_{name}_warm.y4m", cfg, p924, nd, True, src=big)
        torch.cuda.reset_peak_memory_stats()
        n, wall, counts = run(f"d924_{name}.y4m", cfg, p924, nd, True, src=big)
        peaks[name] = (torch.cuda.max_memory_allocated() / 2**30, 4 / wall)
        expect(n == 4 and not nonzero(counts), f"924^2 {name}: launches {nonzero(counts)}")
    with no_tf32():
        run("d924_f32.y4m", dataclasses.replace(one, dtype="float32"), f924, 1, False, src=big)
    line = held("d924_sp.y4m", "d924_one.y4m", "d924_f32.y4m", "sp depth 924")
    say(f"PHASE mesh sp depth 924: sp=2 over [cuda:0, cuda:0], 4 frames 1080p at 924^2 "
        f"(4357 tokens: SDPA with the K7 opt-in set), bf16 batch 8: {peaks['sp'][1]:.2f} fps "
        f"(one device {peaks['one'][1]:.2f}), peak memory {peaks['sp'][0]:.3f} GiB with both "
        f"bands on the one card (one device {peaks['one'][0]:.3f} GiB); {line} [{card}]")
    for key in [k for k in _PREDICTORS if k[3] == 924]:
        del _PREDICTORS[key]
    del p924, f924
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    sp_lifted(card, tmp, run, held, pred, f32, launches, dcrafter)
    say(f"PHASE mesh sp lifted cases took {time.perf_counter() - t0:.1f} s")


def sp_lifted(card: str, tmp: Path, run, held, pred, f32, launches: dict, dcrafter):
    """``depth --mesh sp`` where the model is not row-sharded, on cuda:0
    repeated, each case's fps and device ms beside its twin's (``run``
    and ``held`` are ``mesh_sp_depth``'s):
    - DPT-Large 384^2 (bf16, K7 opt-in: 24 layers at N = 577) at sp=2 over
      16 frames: the model on the group's first device, byte for byte
      against one device with the same K7 launches;
    - DA-V2-S --tiled at sp=2 (518 tiles, 2 a 1080p frame, 8 frames: 16
      tiles a call, 8 on each sub-group; K7 at [8, 1370, 6, 64] against
      one device's [16, 1370, 6, 64]): bf16 held as the sp cases (from the
      float32 one-device tiled route within one device's distance + 0.25
      u8, SSIM 0.99), float32 (TF32 off) within 0.5 u8 and SSIM 0.995;
    - DA-V2-S sp=2,tp=2 over the card four times (16 frames, K7): the tp=2
      split on the first sub-group, byte for byte against tp=2;
    - DepthCrafter's route (bf16, 2 steps, the K7 opt-in) over the mesh
      phase's 50 frames of 512x288 (3 windows) at dp=2,sp=2, byte for byte
      against dp=2."""
    import torch

    from visiondepth3d_tpu_torch.io import Y4MWriter
    from visiondepth3d_tpu_torch.pipeline.depth_pipeline import DepthConfig

    clip = tmp / "mesh_depth.y4m"

    def nonzero(counts):
        return {k: v for k, v in counts.items() if v}

    def dev_ms(p, n):
        return "not measured" if p is None else f"{p['device_ms'] / n:.3f} ms"

    def pair(name, cfg, twin_cfg, predictor, nd, twin_nd, n, k7=True, src=clip):
        """The case and its twin: (counts, twin's counts, line of fps and
        device ms a frame beside the twin's)."""
        _, wall, counts = run(f"{name}.y4m", cfg, predictor, nd, k7, src=src)
        _, wall1, counts1 = run(f"{name}_twin.y4m", twin_cfg, predictor, twin_nd, k7, src=src)
        prof = run(f"{name}_prof.y4m", cfg, predictor, nd, k7, src=src, profile=True)
        prof1 = run(f"{name}_twin_prof.y4m", twin_cfg, predictor, twin_nd, k7, src=src,
                    profile=True)
        return nonzero(counts), nonzero(counts1), (
            f"{n / wall:.2f} fps (twin {n / wall1:.2f}), device time a frame "
            f"{dev_ms(prof, n)} (twin {dev_ms(prof1, n)})")

    # DPT-Large at sp=2: the model on the group's first device
    dptl = da_predictor("cuda", "bfloat16", "dpt-large", 384)
    cfg = DepthConfig(model="dpt-large", batch_size=8, dtype="bfloat16", device="cuda",
                      mesh="sp=2")
    run("lift_dptl_warm.y4m", cfg, dptl, 2, True, src=warm_clip(tmp))
    counts, counts1, line = pair("lift_dptl", cfg, dataclasses.replace(cfg, mesh="off"), dptl,
                                 2, 1, 16)
    same = y4m_body(tmp / "lift_dptl.y4m") == y4m_body(tmp / "lift_dptl_twin.y4m")
    launches["sp depth DPT-Large"] = counts
    layers = dptl.cfg.backbone.num_layers
    say(f"PHASE mesh sp depth DPT-Large: sp=2 over [cuda:0, cuda:0], 16 frames 1080p, 384^2 "
        f"bf16, K7 opt-in (N = 577): {line}; byte-identical to one device: {same}; launches "
        f"{json.dumps(counts)} (one device {json.dumps(counts1)}) [{card}]")
    expect(same and counts == counts1 == {"vmem_attention": layers * 2},
           f"sp depth DPT-Large: identical {same}, launches {counts} against {counts1}")
    drop_predictors("dpt-large")

    # DA-V2-S --tiled at sp=2: 16 tiles a call, 8 on each sub-group
    tclip = tmp / "lift_tiled_8.y4m"
    write_clip(tclip, W, H, 8)
    tcfg = DepthConfig(batch_size=8, dtype="bfloat16", device="cuda", mesh="sp=2", tiled=True,
                       tile_size=518, inference_size=518)
    tone = dataclasses.replace(tcfg, mesh="off")
    counts, counts1, line = pair("lift_tiled", tcfg, tone, pred, 2, 1, 8, src=tclip)
    layers = pred.cfg.backbone.num_layers
    launches["sp depth tiled"] = counts
    f32cfg = dataclasses.replace(tcfg, dtype="float32")
    with no_tf32():
        for name, c, nd in (("lift_tiled_f32_one.y4m", dataclasses.replace(f32cfg, mesh="off"),
                             1), ("lift_tiled_f32.y4m", f32cfg, 2)):
            _, _, c32 = run(name, c, f32, nd, True, src=tclip)
    gate = held("lift_tiled.y4m", "lift_tiled_twin.y4m", "lift_tiled_f32_one.y4m",
                "sp depth tiled")
    dm32, ssim32 = gray_diff(tmp / "lift_tiled_f32.y4m", tmp / "lift_tiled_f32_one.y4m", every=1)
    say(f"PHASE mesh sp depth tiled: sp=2 over [cuda:0, cuda:0], 8 frames 1080p, DA-V2-S "
        f"518 tiles (2 a frame) bf16, K7 opt-in: {line}; {gate}; float32 (TF32 off) against "
        f"one device mean |d| {dm32:.4f} u8 (need <= 0.5), min SSIM {ssim32:.5f} (need >= "
        f"0.995); launches {json.dumps(counts)} (one device {json.dumps(counts1)}) [{card}]")
    expect(counts == {"vmem_attention": layers * 2} and counts1 == {"vmem_attention": layers}
           and nonzero(c32) == {"vmem_attention": layers * 2},
           f"sp depth tiled: launches {counts} against {counts1}, float32 {nonzero(c32)}")
    expect(dm32 <= 0.5 and ssim32 >= 0.995,
           f"sp depth tiled float32: mean |d| {dm32:.4f}, SSIM {ssim32:.5f}")

    # DA-V2-S sp=2,tp=2 on the card four times against tp=2
    scfg = DepthConfig(batch_size=8, dtype="bfloat16", device="cuda", mesh="sp=2,tp=2")
    counts, counts1, line = pair("lift_sptp", scfg, dataclasses.replace(scfg, mesh="tp=2"),
                                 pred, 4, 2, 16)
    same = y4m_body(tmp / "lift_sptp.y4m") == y4m_body(tmp / "lift_sptp_twin.y4m")
    launches["sp x tp depth"] = counts
    say(f"PHASE mesh sp x tp depth: sp=2,tp=2 over [cuda:0] * 4, 16 frames 1080p, DA-V2-S "
        f"bf16, K7 opt-in: {line}; byte-identical to tp=2: {same}; launches "
        f"{json.dumps(counts)} (tp=2 {json.dumps(counts1)}) [{card}]")
    expect(same and counts == counts1 == {"vmem_attention": layers * 2 * 2},
           f"sp x tp depth: identical {same}, launches {counts} against {counts1}")

    # DepthCrafter's route at dp=2,sp=2 against dp=2 over the mesh phase's windows
    if dcrafter is None:
        expect(False, "sp lifted: the mesh phase's DepthCrafter pipeline was not passed")
        return
    pipe, frames = dcrafter
    dclip = tmp / "lift_dcrafter_clip.y4m"
    u8 = (frames * 255.0 + 0.5).clamp(0, 255).to(torch.uint8).cpu().numpy()
    with Y4MWriter(str(dclip), u8.shape[2], u8.shape[1], 24.0) as wr:
        for f in u8:
            wr.write(f)
    n = len(u8)
    dcfg = DepthConfig(model="depthcrafter", dtype="bfloat16", device="cuda", steps=2,
                       window_size=24, overlap=6, target_fps=24.0, mesh="dp=2,sp=2")
    counts, counts1, line = pair("lift_dcrafter", dcfg, dataclasses.replace(dcfg, mesh="dp=2"),
                                 pipe, 4, 2, n, src=dclip)
    # in turns (case, twin, twin, case): all four byte for byte
    run("lift_dcrafter_twin2.y4m", dataclasses.replace(dcfg, mesh="dp=2"), pipe, 2, True,
        src=dclip)
    run("lift_dcrafter2.y4m", dcfg, pipe, 4, True, src=dclip)
    names = ("lift_dcrafter", "lift_dcrafter_twin", "lift_dcrafter_twin2", "lift_dcrafter2")
    bodies = [y4m_body(tmp / f"{x}.y4m") for x in names]
    same = all(b == bodies[0] for b in bodies)
    launches["dp x sp DepthCrafter"] = counts
    say(f"PHASE mesh dp x sp DepthCrafter: dp=2,sp=2 over [cuda:0] * 4, the route over {n} "
        f"frames 512x288 ({len(pipe._windows(n))} windows, 2 steps, bf16, K7 opt-in): {line}; "
        f"byte-identical to dp=2 (case, twin, twin, case): {same}; launches "
        f"{json.dumps(counts)} (dp=2 "
        f"{json.dumps(counts1)}) [{card}]")
    expect(same and counts == counts1 and counts.get("vmem_attention", 0) > 0,
           f"dp x sp DepthCrafter: identical {same}, launches {counts} against {counts1}")


TRAIN_SIZE, TRAIN_BATCH, TRAIN_LR = 518, 4, 1e-4


def _train_batch(n: int, size: int, seed: int):
    """Synthetic smooth targets [n, size, size] in [0, 1] and
    ImageNet-normalized frames [n, size, size, 3] that show them (gray
    levels plus noise), from a numpy seed."""
    import numpy as np

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size] / size
    targets = np.stack([0.5 + 0.4 * np.sin(6 * xx + i) * np.cos(4 * yy - i)
                        for i in range(n)]).astype(np.float32)
    frames = ((targets[..., None] - 0.45) / 0.225
              + 0.1 * rng.standard_normal((n, size, size, 3))).astype(np.float32)
    return frames, targets


def _flat(tensors: dict):
    import torch

    return torch.cat([t.detach().float().reshape(-1).cpu() for t in tensors.values()])


def _ddp_rank(rank: int, port: int, out_dir: str):
    """One rank of the DDP check: gloo, cuda:0, 2 steps of its 2 of 4 frames;
    rank 0 saves its losses, first gradient and final weights."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT))
    from visiondepth3d_tpu_torch.depth.configs import DA_V2_SMALL
    from visiondepth3d_tpu_torch.train import Trainer

    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=2)
    try:
        frames, targets = _train_batch(4, 140, 11)
        t = Trainer(DA_V2_SMALL, learning_rate=TRAIN_LR, device="cuda:0").init(
            torch.Generator().manual_seed(0))
        losses = []
        for i in range(2):
            losses.append(t.step(frames, targets))
            if i == 0:
                grad = _flat({k: p.grad for k, p in t.module.named_parameters()})
        if rank == 0:
            torch.save({"losses": losses, "grad": grad,
                        "params": _flat(dict(t.module.named_parameters()))},
                       Path(out_dir) / "ddp_rank0.pt")
    finally:
        dist.destroy_process_group()


def phase_train(card: str, tmp: Path):
    """The depth trainer: DA-V2-Small at 518^2, batch 4, float32, 5 AdamW
    steps on one batch (the loss descends, no K7; the K7 opt-in raises); one
    step at 140^2 on the card against the CPU; two DDP ranks (gloo, both on
    cuda:0) against one process on the whole batch."""
    import multiprocessing as mp
    import socket

    import numpy as np
    import torch

    from visiondepth3d_tpu_torch.depth.configs import DA_V2_SMALL
    from visiondepth3d_tpu_torch.ops import attention as attn_ops
    from visiondepth3d_tpu_torch.train import Trainer

    # 1. full width
    frames, targets = _train_batch(TRAIN_BATCH, TRAIN_SIZE, 10)
    torch.cuda.reset_peak_memory_stats()
    trainer = Trainer(DA_V2_SMALL, learning_rate=TRAIN_LR, device="cuda").init(
        torch.Generator().manual_seed(0))
    losses, times = [], []
    for _ in range(5):
        loss, wall, counts = counted(lambda: trainer.step(frames, targets))
        losses.append(loss)
        times.append(wall)
        expect(counts["vmem_attention"] == 0, f"a training step launched K7: {counts}")
    peak = torch.cuda.max_memory_allocated()
    expect(all(np.isfinite(losses)) and losses[-1] < losses[0],
           f"the training loss does not descend: {losses}")
    try:
        attn_ops.USE_VMEM_KERNEL = True
        try:
            trainer.step(frames, targets)
            raised = False
        except RuntimeError as e:
            raised = "no backward" in str(e)
    finally:
        attn_ops.USE_VMEM_KERNEL = False
    expect(raised, "with the K7 opt-in a training step did not raise")
    say(f"PHASE train: DA-V2-Small {TRAIN_SIZE}^2, batch {TRAIN_BATCH}, float32, AdamW lr "
        f"{TRAIN_LR}, 5 steps on one batch: losses {', '.join(f'{x:.6f}' for x in losses)}; "
        f"{1 / statistics.median(times[1:]):.3f} steps/s (median of steps 2-5; first "
        f"{times[0]:.2f} s), peak allocated {peak / 2**30:.3f} GiB; K7 launches 0; with the "
        f"K7 opt-in the step raises [{card}]")
    del trainer
    torch.cuda.empty_cache()

    # 1b. tp=2 over [cuda:0, cuda:0] against one device: the same 5 steps
    # from the same weights, the ViT's attention and MLP blocks split
    # Megatron-style; TF32 off on both (TF32 convolutions round the neck's
    # inputs to 10 bits, which turns the split's float32 summation order
    # into differences of 1e-4 x max |g|)
    from visiondepth3d_tpu_torch.parallel import make_mesh
    from visiondepth3d_tpu_torch.parallel.tp import full_state_dict

    dev = torch.device("cuda", 0)
    runs = {}
    with no_tf32():
        for name, mesh in (("one", None), ("tp", make_mesh(dp=1, tp=2, devices=[dev, dev]))):
            t = Trainer(DA_V2_SMALL, learning_rate=TRAIN_LR, device="cuda").init(
                torch.Generator().manual_seed(0), mesh=mesh)
            run_losses, run_times = [], []
            for i in range(5):
                loss, wall, _ = counted(lambda: t.step(frames, targets))
                run_losses.append(loss)
                run_times.append(wall)
                if i == 0:
                    grad = full_state_dict(t.module, grads=True)
            runs[name] = (run_losses, run_times, grad)
            del t
            torch.cuda.empty_cache()
    (one_l, one_t, one_g), (tp_l, tp_t, tp_g) = runs["one"], runs["tp"]
    expect(set(tp_g) == set(one_g), "tp=2 gradients under other names")
    top = max(float(g.abs().max()) for g in one_g.values())
    gerr = max(float((tp_g[k] - g).abs().max()) for k, g in one_g.items()) / top
    lrel = [abs(a - b) / abs(b) for a, b in zip(tp_l, one_l)]
    say(f"PHASE train tp: tp=2 over [cuda:0, cuda:0] against one device, DA-V2-Small "
        f"{TRAIN_SIZE}^2, batch {TRAIN_BATCH}, TF32 off, 5 steps from the same weights: losses "
        f"{', '.join(f'{x:.6f}' for x in tp_l)} (one device "
        f"{', '.join(f'{x:.6f}' for x in one_l)}), relative "
        f"{', '.join(f'{x:.2e}' for x in lrel)} (need the first <= 1e-5); first gradient max "
        f"|d| / max |g| {gerr:.2e} (need <= 1e-5); {1 / statistics.median(tp_t[1:]):.3f} "
        f"steps/s (one device {1 / statistics.median(one_t[1:]):.3f}) [{card}]")
    expect(lrel[0] <= 1e-5 and gerr <= 1e-5, f"tp=2 train: loss rel {lrel}, grad {gerr}")
    del runs, one_g, tp_g
    torch.cuda.empty_cache()

    # 2. card against CPU, one step at 140^2, TF32 off
    small_f, small_t = _train_batch(2, 140, 11)
    res = {}
    with no_tf32():
        for d in ("cpu", "cuda"):
            t = Trainer(DA_V2_SMALL, learning_rate=TRAIN_LR, device=d).init(
                torch.Generator().manual_seed(0))
            loss = t.step(small_f, small_t)
            res[d] = (loss, _flat({k: p.grad for k, p in t.module.named_parameters()}))
    rel = abs(res["cuda"][0] - res["cpu"][0]) / abs(res["cpu"][0])
    gerr = float((res["cuda"][1] - res["cpu"][1]).abs().max() / res["cpu"][1].abs().max())
    say(f"PHASE train card vs CPU: one step at 140^2, batch 2, float32, TF32 off: loss "
        f"{res['cuda'][0]:.7f} vs {res['cpu'][0]:.7f} (rel {rel:.2e}, need <= 1e-4), gradient "
        f"max |d| / max |g| {gerr:.2e} (need <= 1e-4) [{card}]")
    expect(rel <= 1e-4 and gerr <= 1e-4, f"train card vs CPU: loss rel {rel}, grad {gerr}")

    # 3. DDP: two ranks under gloo, both on cuda:0, against one process (and
    # against the mean of the two halves' gradients taken in one process:
    # the same sums as the ranks', so what DDP itself adds)
    from visiondepth3d_tpu_torch.train import ssi_loss

    frames4, targets4 = _train_batch(4, 140, 11)
    with no_tf32():
        t = Trainer(DA_V2_SMALL, learning_rate=TRAIN_LR, device="cuda").init(
            torch.Generator().manual_seed(0))
        halves = []
        for a in (0, 2):
            t.module.zero_grad(set_to_none=True)
            x = torch.from_numpy(frames4[a:a + 2]).cuda().permute(0, 3, 1, 2)
            ssi_loss(t.module(x), torch.from_numpy(targets4[a:a + 2]).cuda()).backward()
            halves.append(_flat({k: p.grad for k, p in t.module.named_parameters()}))
        half_grad = (halves[0] + halves[1]) / 2
        one_losses = []
        for i in range(2):
            one_losses.append(t.step(frames4, targets4))
            if i == 0:
                one_grad = _flat({k: p.grad for k, p in t.module.named_parameters()})
        one_params = _flat(dict(t.module.named_parameters()))
    del t
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    ctx = mp.get_context("spawn")
    t0 = time.perf_counter()
    procs = [ctx.Process(target=_ddp_rank, args=(r, port, str(tmp))) for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=300)
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    codes = [p.exitcode for p in procs]
    expect(codes == [0, 0], f"a DDP rank failed: exit codes {codes}")
    ddp = torch.load(tmp / "ddp_rank0.pt")
    top = float(one_grad.abs().max())
    lrel = max(abs(a - b) / abs(b) for a, b in zip(ddp["losses"], one_losses))
    gerr = float((ddp["grad"] - one_grad).abs().max()) / top
    gsplit = float((half_grad - one_grad).abs().max()) / top
    ghalf = float((ddp["grad"] - half_grad).abs().max()) / top
    pmean = float((ddp["params"] - one_params).abs().mean())
    say(f"PHASE train DDP: 2 ranks (gloo, both on cuda:0, {time.perf_counter() - t0:.1f} s "
        f"with the spawn), 2 steps of 2 + 2 frames at 140^2 against one process on 4: losses "
        f"{ddp['losses']} vs {one_losses} (max rel {lrel:.2e}, need <= 1e-5); first gradient "
        f"max |d| / max |g| {gerr:.2e} from the whole batch's (need <= 2e-5; the halves' mean "
        f"in one process is {gsplit:.2e} from it: float32 sums of two batch shapes) and "
        f"{ghalf:.2e} from the halves' mean (need <= 1e-6); weights mean |d| {pmean:.2e} (need "
        f"<= {1e-2 * TRAIN_LR:.0e}) [{card}]")
    expect(lrel <= 1e-5 and gerr <= 2e-5 and ghalf <= 1e-6
           and pmean <= 1e-2 * TRAIN_LR,
           f"DDP vs one process: loss {lrel}, grad {gerr} (split {gsplit}, halves {ghalf}), "
           f"weights {pmean}")


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
            for name, fn in (("surface", phase_surface), ("catalog", phase_catalog),
                             ("families", phase_families), ("routes", phase_routes),
                             ("dcrafter", phase_dcrafter)):
                if name in phases:
                    timed(name, fn, card, tmp)
            if "rifebatch" in phases:
                timed("rifebatch", phase_rife_batch, card, tmp)
            if "parity" in phases:
                timed("parity", phase_parity, card, tmp)
                timed("parity tools", phase_tools_parity, tmp)
            if "cli" in phases:
                if "parity" not in phases:
                    write_clip(tmp / "small.y4m", 256, 144, 4)
                timed("cli", phase_cli, tmp)
            if "product" in phases:
                timed("product", phase_product, card, tmp)
            if "serve" in phases:
                timed("serve", phase_serve, card, tmp)
            mesh_counts = {}
            if "mesh" in phases:
                mesh_counts = timed("mesh", phase_mesh, card, tmp)
            if "train" in phases:
                timed("train", phase_train, card, tmp)
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
        row = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
               "launches": counts.get(name), "max_abs_err": k["err"], "ms": k["ms"],
               "plain_ms": k["plain"], "bound_ms": k["bound_ms"],
               "bound_by": k["bound_by"], "library_ms": k["library_ms"]}
        if "band" in k:
            # the band forms, with their launches on the sp=2 render of the mesh phase
            band, finish = BAND_ENTRIES[name]
            sp = mesh_counts.get("sp render", {})
            row["band"] = dict(k["band"], bound_by="bytes", band_launches=sp.get(band),
                               finish_launches=sp.get(finish))
        kb = kernels.get((name + "_band", key[1]))
        if kb is not None:
            # K7's query-band form, with its launches on the sp=2 depth route
            row["band"] = {"shape": kb["shape"], "nk": kb["nk"], "max_abs_err": kb["err"],
                           "ms": kb["ms"], "plain_ms": kb["plain"],
                           "bound_ms": kb["bound_ms"], "bound_by": kb["bound_by"],
                           "library_ms": kb["library_ms"], "bitwise": kb["bitwise"],
                           "launches": mesh_counts.get("sp depth", {}).get(name)}
        table.append(row)
    say(card_line())
    say(json.dumps({"kernels": table}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
