"""The fused 2D -> 3D render with Apple Depth Pro on one device, driven as
``vd3d-torch render --model depth-pro --inference-size 1536`` drives it,
timed from the render loop.

Everything but the model is ``render_fused``'s (loaded through
``core/spec.load_module``): the program's reader, predictor, chunk
function and writer wrapped in the benchmark's spans (``WrapReader``,
``PredictorProxy``, ``wrap_chunk_fn``, ``Sink``), the compared chunks'
copies (``Stash``), the stereo parameters and the window's sample. The
predictor is ``load_predictor("depth-pro", ...)`` at the configuration's
size, its weights drawn from the seed in transformers' names
(``reference/depth_pro.py``).

The traced stretch is exported once: the usual ``TraceView`` and an index
of the program's own spans (``core/program_spans.py``), whose
``depth.<stage>`` spans inside Depth Pro's forward the ``depthpro.*``
readers read; the program's ``depth.windows`` counter (windows the patch
encoder ran) is taken from ``utils.observability.records()`` and noted.

The check is ``render_fused``'s with the Depth Pro reference in place of
Depth Anything's: the model on its own depth (``depth_gap``,
``state_gap``), the stereo stage on the program's depth
(``frame_off_share``), over the first two chunks and ``check_chunks``
chunks of the window.
"""

from __future__ import annotations

import dataclasses
import gc
import math
import time

import numpy as np
import torch

from portbench.core import check as chk
from portbench.core import clip as clipmod
from portbench.core import program_spans
from portbench.core import spec as specmod
from portbench.core import weights as wmod
from portbench.core.trace import TraceView, traced
from portbench.reference import depth_pro as ref_dp
from portbench.reference import render as ref_render
from portbench.reference import stereo as ref_stereo
from portbench.reference.precision import Mat

fused = specmod.load_module(specmod.PKG / "routes" / "render_fused.py",
                            "portbench_route_render_fused")
START_CHUNKS = fused.START_CHUNKS
WINDOWS = "depth.windows"  # the program's counter


def port_model_config(conf: dict):
    """The program's ``DepthProConfig`` of an HF Depth Pro config."""
    from visiondepth3d_tpu_torch.depth.configs import ViTConfig
    from visiondepth3d_tpu_torch.depth.depth_pro import DepthProConfig

    def vit(c):
        return ViTConfig(hidden_size=c["hidden_size"], num_layers=c["num_hidden_layers"],
                         num_heads=c["num_attention_heads"], mlp_ratio=c["mlp_ratio"],
                         patch_size=c["patch_size"], layer_norm_eps=c["layer_norm_eps"],
                         image_size=c["image_size"])

    return DepthProConfig(
        patch_model=vit(conf["patch_model_config"]), image_model=vit(conf["image_model_config"]),
        fov_model=vit(conf["fov_model_config"]), patch_size=conf["patch_size"],
        scaled_images_ratios=tuple(conf["scaled_images_ratios"]),
        scaled_images_overlap_ratios=tuple(conf["scaled_images_overlap_ratios"]),
        scaled_images_feature_dims=tuple(conf["scaled_images_feature_dims"]),
        intermediate_hook_ids=tuple(conf["intermediate_hook_ids"]),
        intermediate_feature_dims=tuple(conf["intermediate_feature_dims"]),
        fusion_hidden_size=conf["fusion_hidden_size"],
        merge_padding_value=conf["merge_padding_value"],
        num_fov_head_layers=conf["num_fov_head_layers"], use_fov_model=conf["use_fov_model"])


def make_predictor(config: dict, sd: dict, dev):
    """The program's predictor through ``load_predictor``, at the catalog's
    config (held equal to the file's) unless the file says otherwise."""
    from visiondepth3d_tpu_torch.depth.registry import CATALOG, load_predictor

    port_cfg = port_model_config(config)
    override = None
    if config.get("check_catalog", True):
        if CATALOG[config["port_model"]].config != port_cfg:
            raise specmod.SpecError(f"{config['port_model']}: the program's catalog config "
                                    f"differs from {config['name']}'s file")
    else:
        override = port_cfg
    return load_predictor(config["port_model"], checkpoint=sd,
                          inference_size=config["inference_size"], dtype=config["dtype"],
                          config=override, device=dev)


def run(ctx) -> dict:
    """One run of a cell; the parts of the result line (see ``portbench/run.py``)."""
    from visiondepth3d_tpu_torch.io import Y4MPlaneReader, open_video
    from visiondepth3d_tpu_torch.pipeline.stereo_pipeline import (
        ChunkStream, RenderConfig, make_chunk_fn, plane_input, probe_geometry)
    from visiondepth3d_tpu_torch.state import init_trackers
    from visiondepth3d_tpu_torch.utils import observability

    mix, conf, spans = ctx.traffic, ctx.config, ctx.spans
    dev = torch.device(ctx.device)
    cuda = dev.type == "cuda"
    size_t = mix["chunk_size"]
    w, h, n_clip = mix["width"], mix["height"], mix["frames"]

    # the clip and the weights, from the seed
    path = clipmod.clip_path(mix["name"], ctx.seed)
    ctx.cleanup.append(lambda: clipmod.remove(path))
    ctx.notes["clip_bytes"] = clipmod.write_clip(path, ctx.seed, w, h, n_clip, mix["fps"], dev)
    mcfg = ref_dp.model_cfg(conf)
    specs = ref_dp.param_specs(mcfg)
    sd, checksum = wmod.state_dict(specs, ctx.seed, dev)
    predictor = make_predictor(conf, sd, dev)
    del sd
    if cuda:
        torch.cuda.empty_cache()

    # what render_stereo_video builds on one card
    port_params, ref_params = fused.stereo_params(mix, ctx.program_stereo)
    rcfg = RenderConfig(output_format=mix["output_format"], output_height=mix["output_height"],
                        preserve_original_aspect=mix["preserve_aspect"], chunk_size=size_t,
                        device=str(dev), mesh="off")
    probe = open_video(path)
    first, geom = probe_geometry(probe, rcfg)
    if not plane_input(path, rcfg, probe):
        raise specmod.SpecError("the mix's clip does not take the plane-input path")
    probe.close()
    reader = fused.WrapReader(Y4MPlaneReader(path), spans)
    ctx.cleanup.append(reader.close)
    stash = fused.Stash(spans, pinned=cuda)
    proxy = fused.PredictorProxy(predictor, spans, stash)
    chunk_fn = fused.wrap_chunk_fn(make_chunk_fn(port_params, geom, rcfg, predictor=proxy,
                                                 yuv_in=True), spans, stash)
    sink = fused.Sink(spans, size_t, stash)
    trackers = init_trackers(geom.eye_h, geom.eye_w, device=dev)
    stream = ChunkStream(reader, None, sink, chunk_fn, trackers, dev, geom, rcfg, True, set())
    if not stream.yuv_out:
        raise specmod.SpecError("the output does not take the plane-output path")

    # warm-up: every shape the window uses; the first chunks are compared
    warm = mix["warmup_chunks"]
    if warm < START_CHUNKS:
        raise specmod.SpecError(f"warmup_chunks must be at least {START_CHUNKS}")
    depth_like = torch.empty((size_t, geom.eye_h, geom.eye_w), dtype=torch.float32)
    stash.reserve(range(START_CHUNKS), (), depth_like, trackers)
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    chunk_s = 0.0
    for k in range(warm):
        spans.chunk = k
        t0 = time.perf_counter()
        stream.launch()
        chunk_s = time.perf_counter() - t0
    stream.flush()
    if cuda:
        torch.cuda.synchronize()

    # the chunks of the window to compare, drawn from the seed; a traced
    # run keeps its traced stretch out of them
    traced_n = mix["trace_chunks"] if ctx.trace else 0
    expected = int(0.8 * ctx.seconds / max(chunk_s, 1e-3))
    picks = fused.window_sample(ctx.seed, mix["check_chunks"], traced_n, expected)
    picks = {warm + j for j in picks}
    stash.reserve(picks, picks, depth_like, trackers)
    if cuda:
        # the sink holds the compared chunks' readback buffers: grow the
        # pinned-memory cache by as many blocks now, not in the window
        out_bytes = geom.out_h * geom.out_w * 3 // 2
        spare = [torch.empty((size_t, out_bytes), dtype=torch.uint8, pin_memory=True)
                 for _ in range(len(picks) + 1)]
        del spare
    ctx.mark_setup()

    # the window
    delivered0, launches, prof = sink.frames, 0, None
    t_start = time.perf_counter()

    def launch():
        nonlocal launches
        spans.chunk = warm + launches
        with spans.span("launch"):
            stream.launch()
        launches += 1

    if traced_n:
        def stretch():
            for _ in range(traced_n):
                launch()
            stream.flush()

        observability.reset_records()
        prof = traced(spans, stretch, cuda)
    while time.perf_counter() - t_start < ctx.seconds:
        launch()
    stream.flush()
    if cuda:
        torch.cuda.synchronize()
    window_s = time.perf_counter() - t_start
    delivered = sink.frames - delivered0
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    ctx.check_imports()
    trace = program = None
    frames_traced = traced_n * size_t
    if prof is not None:
        trace_events = program_spans.events(prof)
        trace = TraceView(trace_events)
        program = program_spans.ProgramSpans(trace_events, trace)
        del trace_events
        windows = sum(n for (name, _), n in observability.records().counts.items()
                      if name == WINDOWS)
        ctx.notes["windows_per_frame"] = windows / frames_traced if windows else None

    launch_s = [t1 - t0 for t0, t1, c in spans.records["launch"] if c >= warm + traced_n]
    if launch_s:
        q = np.quantile(launch_s, [0.0, 0.25, 0.5, 0.75, 1.0])
        ctx.notes["chunk_wall_s_quantiles"] = [round(float(x), 4) for x in q]
        per = 1e3 / max(1, len(launch_s) * size_t)
        ctx.notes["host_ms_per_frame"] = {
            n: round(spans.total_s(n, range(warm + traced_n, warm + launches)) * per, 3)
            for n in ("read", "dispatch", "depth", "sink", "launch")}
    untraced = range(warm + traced_n, warm + launches)
    layer = {
        "spans": spans, "trace": trace, "program": program, "frames_traced": frames_traced,
        "untraced_chunks": untraced, "untraced_frames": len(untraced) * size_t,
        "geometry": {"eye_h": geom.eye_h, "eye_w": geom.eye_w, "warp_h": geom.warp_h,
                     "warp_w": geom.warp_w},
        "stereo": dataclasses.asdict(ref_params), "image_bytes": 4,
        "model": mcfg, "family": conf["family"], "inference_size": conf["inference_size"],
        "dtype": conf["dtype"], "tf32": bool(conf.get("tf32")),
        "fast_head": conf["fast_head"], "pkg": ctx.bench.pkg,
    }

    # the program's state is freed before the reference runs
    kept = {k: sink.kept.get(k, []) for k in sorted(stash.chunks) if k < warm + launches}
    record = {"depth": stash.record("depth"), "before": stash.record("before"),
              "after": stash.record("after"), "out": kept}
    del stream, chunk_fn, proxy, predictor, trackers, sink
    gc.collect()
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    detail: dict = {}
    t_check = time.perf_counter()
    gaps = compare(ctx, record, mcfg, specs, checksum, ref_params, w, h, n_clip, size_t,
                   conf["inference_size"], warm, detail=detail)
    ctx.notes["check_s"] = time.perf_counter() - t_check
    ctx.notes["compared"] = detail
    correct, rows = chk.combine(gaps, ctx.limits)
    if any(len(kept[k]) != size_t for k in kept):
        correct = False
    return {"correct": correct, "attempted": launches * size_t,
            "failed": launches * size_t - delivered,
            "e2e": {"fps": delivered / window_s, "peak_gib": peak / 2**30},
            "window_s": window_s, "peak_bytes": peak,
            "layer": layer, "checks": rows,
            "notes": {"compared_chunks": sorted(kept), "launches": launches,
                      "delivered": delivered}}


def compare(ctx, record: dict, mcfg, specs, checksum, params, w, h, n_clip, size_t, size,
            warm, detail: dict | None = None) -> dict:
    """The three numbers of ``check.py`` over the compared chunks, as
    ``render_fused.compare`` reads them, with the Depth Pro reference: its
    model and temporal depth filter on its own (``depth_gap``,
    ``state_gap``; each chunk's per-frame depth range, hi - lo before the
    normalization, goes to ``detail``), its stereo stage on the program's
    depth (``frame_off_share``)."""
    dev = torch.device(ctx.device)
    mm = Mat("float32")
    sd, again = wmod.state_dict(specs, ctx.seed, dev)
    if again != checksum:
        raise RuntimeError("the weights made again from the seed differ from the first")
    geom = ref_render.full_sbs_geometry(w, h, ctx.traffic["output_height"],
                                        ctx.traffic["preserve_aspect"])
    path = clipmod.clip_path(ctx.traffic["name"], ctx.seed)
    gaps = dict.fromkeys(chk.NUMBERS, 0.0)
    own = on_prog = ref_stereo.init_trackers(geom.eye_h, geom.eye_w, dev)
    with mm.scope(), torch.inference_mode():
        for k in sorted(record["out"]):
            idx = [(k * size_t + i) % n_clip for i in range(size_t)]
            planes = [torch.from_numpy(p).to(dev) for p in clipmod.read_planes(path, w, h, idx)]
            if k in record["before"]:
                own = on_prog = {f: v.to(dev) for f, v in record["before"][k].items()}
            ranges: list = []
            depth = ref_dp.predict_01(mm, sd, mcfg, ref_render.source(geom, *planes), size,
                                      (geom.eye_h, geom.eye_w), ranges=ranges)
            after = ref_render.carry(own, depth)
            d_gap, shares, fields_b = math.nan, None, {}
            if k in record["depth"]:
                prog_depth = record["depth"][k].to(dev)
                d_gap = float((prog_depth - depth).abs().max())
                del depth
                after_b, _, out = ref_render.chunk(mm, params, None, None, size, geom, on_prog,
                                                   *planes, depth=prog_depth)
                frames = record["out"][k]
                if len(frames) == size_t:
                    prog = tuple(np.stack([f[i] for f in frames]) for i in range(3))
                    shares = {tol: chk.frame_shares(prog, out, tol) for tol in (0, 1, 2)}
                    mean_gap = chk.frame_gaps(prog, out)
                if k in record["after"]:
                    fields_b = chk.state_gaps(record["after"][k], after_b)
                on_prog = after_b
                del prog_depth, out
            own = after
            off = shares[chk.TOLERANCE] if shares is not None else np.array([math.nan])
            fields = (chk.state_gaps(record["after"][k], after) if k in record["after"]
                      else dict.fromkeys(chk.STATE_FIELDS, math.nan))
            for name, v in (("depth_gap", d_gap), ("frame_off_share", float(off.max())),
                            ("state_gap", max(fields[f] for f in chk.STATE_FIELDS))):
                gaps[name] = chk.worse(gaps[name], v)
            if detail is not None:
                detail[k] = {"depth": d_gap, "state": {f: v for f, v in fields.items() if v > 0},
                             "depth_range": [min(ranges), max(ranges)]}
                if shares is not None:
                    detail[k].update({f"off_tol{t}_max": float(a.max()) for t, a in shares.items()})
                    detail[k]["mean_gap_u8_max"] = float(mean_gap.max())
                    detail[k]["state_on_prog_depth"] = {f: v for f, v in fields_b.items() if v > 0}
            del planes
    return gaps
