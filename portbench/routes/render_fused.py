"""The fused 2D -> 3D render on one device, driven as ``vd3d-torch render``
drives it, timed from the render loop.

Set-up builds what ``render_stereo_video`` builds on one card: the clip
probed (``probe_geometry``), plane input (``Y4MPlaneReader``), the chunk
function with the depth predictor (``make_chunk_fn(..., yuv_in=True)``),
fresh trackers (``init_trackers``) and one ``ChunkStream``. The benchmark
hands the stream four objects of its own, and patches nothing of the
program:

- the reader: the program's plane reader, back at frame 0 at the end of
  the clip, so one render runs through the whole window (span ``read``);
- the predictor: the program's predictor, its ``predict_01`` inside span
  ``depth``;
- the chunk function: the program's, called inside span ``dispatch``;
- the writer: a sink with ``write_yuv420`` (span ``sink``) that counts
  the frames, keeps those of the compared chunks and writes nothing.

Warm-up runs ``warmup_chunks`` chunks through the same stream (every
shape the window uses), then the window launches chunks until
``--seconds`` have passed and drains the last readback. ``fps`` is the
frames the writer received in the window over the window's wall time.

The check: the first two chunks (from fresh trackers) and ``check_chunks``
chunks of the window drawn from the seed are compared with the plain
reference (``portbench/reference``), which runs after the window, once the
program's state is freed. For a window chunk the reference starts from the
trackers the program carried into it (copied aside before the chunk); the
first two chunks check the start and the carry by themselves. The depth
model is checked on the reference's own depth; the stereo stage, packing
and YUV on the program's depth (see ``core/check.py``).
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
from portbench.core import spec as specmod
from portbench.core import weights as wmod
from portbench.core.trace import traced, view
from portbench.reference import depth_anything as ref_da
from portbench.reference import render as ref_render
from portbench.reference import stereo as ref_stereo
from portbench.reference.precision import Mat

START_CHUNKS = 2  # compared from fresh trackers: the start and one carry


class WrapReader:
    """The program's reader, wrapped around: the clip read again from frame
    0 at its end."""

    def __init__(self, rd, spans):
        self.rd, self.spans = rd, spans
        self.width, self.height, self.fps = rd.width, rd.height, rd.fps

    def read(self):
        with self.spans.span("read"):
            frame = self.rd.read()
            if frame is None:
                if not self.rd.seek(0):
                    raise RuntimeError("the clip cannot be read from its start again")
                frame = self.rd.read()
        return frame

    def close(self):
        self.rd.close()


class Stash:
    """Host copies of what the program made in the compared chunks, queued
    asynchronously into pinned buffers reserved during set-up."""

    def __init__(self, spans, pinned: bool):
        self.spans, self.pinned = spans, pinned
        self.chunks: set[int] = set()
        self.depth: dict[int, torch.Tensor] = {}
        self.before: dict[int, dict] = {}
        self.after: dict[int, dict] = {}
        self.filled: set[tuple[str, int]] = set()

    def _buf(self, x: torch.Tensor) -> torch.Tensor:
        return torch.empty(x.shape, dtype=x.dtype, pin_memory=self.pinned)

    def reserve(self, chunks, window, depth_like: torch.Tensor, trackers) -> None:
        """Buffers for the depth and the end state of ``chunks``, and for the
        start state of ``window`` (the chunks the reference starts from the
        program's trackers)."""
        state = {f.name: getattr(trackers, f.name) for f in dataclasses.fields(trackers)}
        for k in chunks:
            self.depth[k] = self._buf(depth_like)
            self.after[k] = {n: self._buf(v) for n, v in state.items()}
        for k in window:
            self.before[k] = {n: self._buf(v) for n, v in state.items()}
        self.chunks.update(chunks)

    def _state(self, kind: str, store: dict, trackers) -> None:
        k = self.spans.chunk
        if k in store:
            for n, buf in store[k].items():
                buf.copy_(getattr(trackers, n), non_blocking=self.pinned)
            self.filled.add((kind, k))

    def on_depth(self, d: torch.Tensor) -> None:
        k = self.spans.chunk
        if k in self.depth:
            self.depth[k].copy_(d, non_blocking=self.pinned)
            self.filled.add(("depth", k))

    def on_before(self, trackers) -> None:
        self._state("before", self.before, trackers)

    def on_after(self, trackers) -> None:
        self._state("after", self.after, trackers)

    def record(self, kind: str) -> dict:
        return {k: v for k, v in getattr(self, kind).items() if (kind, k) in self.filled}


class PredictorProxy:
    """The program's predictor with ``predict_01`` inside span ``depth``."""

    def __init__(self, predictor, spans, stash: Stash):
        self.predictor, self.spans, self.stash = predictor, spans, stash
        self.device = predictor.device

    def predict_01(self, frames, out_hw=None):
        with self.spans.span("depth"):
            d = self.predictor.predict_01(frames, out_hw=out_hw)
        self.stash.on_depth(d)
        return d


class Sink:
    """The render's writer: counts the frames and keeps the planes of the
    compared chunks (views of the program's host buffers, not copies)."""

    def __init__(self, spans, chunk_size: int, stash: Stash):
        self.spans, self.chunk_size, self.stash = spans, chunk_size, stash
        self.frames = 0
        self.kept: dict[int, list] = {}

    def write_yuv420(self, y, u, v):
        with self.spans.span("sink"):
            chunk = self.frames // self.chunk_size
            if chunk in self.stash.chunks:
                self.kept.setdefault(chunk, []).append((y, u, v))
            self.frames += 1

    def write(self, frame):
        raise RuntimeError("the render wrote RGB frames: the sink takes YUV420 planes")

    def close(self):
        pass


def wrap_chunk_fn(chunk_fn, spans, stash: Stash):
    def chunk(trackers, frames_in, blanks=None):
        stash.on_before(trackers)
        with spans.span("dispatch"):
            trackers, out = chunk_fn(trackers, frames_in, blanks)
        stash.on_after(trackers)
        return trackers, out

    return chunk


def port_model_config(conf: dict):
    """The program's ``DPTConfig`` of an HF Depth Anything config."""
    from visiondepth3d_tpu_torch.depth.configs import DPTConfig, ViTConfig

    bb = conf["backbone_config"]
    vit = ViTConfig(hidden_size=bb["hidden_size"], num_layers=bb["num_hidden_layers"],
                    num_heads=bb["num_attention_heads"], mlp_ratio=bb["mlp_ratio"],
                    patch_size=bb["patch_size"], layer_norm_eps=bb["layer_norm_eps"],
                    image_size=bb["image_size"])
    return DPTConfig(backbone=vit, out_indices=tuple(bb["out_indices"]),
                     reassemble_factors=tuple(conf["reassemble_factors"]),
                     neck_hidden_sizes=tuple(conf["neck_hidden_sizes"]),
                     fusion_hidden_size=conf["fusion_hidden_size"],
                     head_hidden_size=conf["head_hidden_size"],
                     depth_estimation_type=conf["depth_estimation_type"],
                     max_depth=float(conf.get("max_depth") or 1.0))


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
                          config=override, device=dev, fast_head=config["fast_head"])


def stereo_params(traffic: dict, program: dict | None = None):
    """The program's and the reference's stereo parameters of the mix; every
    field the reference holds must read alike in both, but for those that
    ``program`` sets on the program's side alone (the control's lower
    precision)."""
    from visiondepth3d_tpu_torch.stereo import StereoParams

    given, program = traffic.get("stereo", {}), program or {}
    port, ref = StereoParams(**dict(given, **program)), ref_stereo.Params(**given)
    differ = [f.name for f in dataclasses.fields(ref)
              if f.name not in program and getattr(port, f.name) != getattr(ref, f.name)]
    if differ:
        raise specmod.SpecError(f"the program's stereo parameters differ from the "
                                f"reference's in {differ}")
    return port, ref


def window_sample(seed: int, count: int, first: int, expected: int) -> set[int]:
    """``count`` chunk indices drawn from the seed, spread over the window's
    expected chunks from ``first`` on (window-relative)."""
    rng = np.random.default_rng([seed, 20])
    span = max(1, expected - first)
    return {first + int(u * span) for u in rng.random(count)}


def run(ctx) -> dict:
    """One run of a cell; the parts of the result line (see ``portbench/run.py``)."""
    from visiondepth3d_tpu_torch.io import Y4MPlaneReader, open_video
    from visiondepth3d_tpu_torch.pipeline.stereo_pipeline import (
        ChunkStream, RenderConfig, make_chunk_fn, plane_input, probe_geometry)
    from visiondepth3d_tpu_torch.state import init_trackers

    mix, conf, spans = ctx.traffic, ctx.config, ctx.spans
    dev = torch.device(ctx.device)
    cuda = dev.type == "cuda"
    size_t = mix["chunk_size"]
    w, h, n_clip = mix["width"], mix["height"], mix["frames"]

    # the clip and the weights, from the seed
    path = clipmod.clip_path(mix["name"], ctx.seed)
    ctx.cleanup.append(lambda: clipmod.remove(path))
    ctx.notes["clip_bytes"] = clipmod.write_clip(path, ctx.seed, w, h, n_clip, mix["fps"], dev)
    mcfg = ref_da.model_cfg(conf)
    specs = ref_da.param_specs(mcfg)
    sd, checksum = wmod.state_dict(specs, ctx.seed, dev)
    predictor = make_predictor(conf, sd, dev)
    del sd
    if cuda:
        torch.cuda.empty_cache()

    # what render_stereo_video builds on one card
    port_params, ref_params = stereo_params(mix, ctx.program_stereo)
    rcfg = RenderConfig(output_format=mix["output_format"], output_height=mix["output_height"],
                        preserve_original_aspect=mix["preserve_aspect"], chunk_size=size_t,
                        device=str(dev), mesh="off")
    probe = open_video(path)
    first, geom = probe_geometry(probe, rcfg)
    if not plane_input(path, rcfg, probe):
        raise specmod.SpecError("the mix's clip does not take the plane-input path")
    probe.close()
    reader = WrapReader(Y4MPlaneReader(path), spans)
    ctx.cleanup.append(reader.close)
    stash = Stash(spans, pinned=cuda)
    proxy = PredictorProxy(predictor, spans, stash)
    chunk_fn = wrap_chunk_fn(make_chunk_fn(port_params, geom, rcfg, predictor=proxy,
                                           yuv_in=True), spans, stash)
    sink = Sink(spans, size_t, stash)
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
    picks = window_sample(ctx.seed, mix["check_chunks"], traced_n, expected)
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
    trace = view(prof) if prof is not None else None

    launch_s = [t1 - t0 for t0, t1, c in spans.records["launch"] if c >= warm + traced_n]
    if launch_s:
        q = np.quantile(launch_s, [0.0, 0.25, 0.5, 0.75, 1.0])
        ctx.notes["chunk_wall_s_quantiles"] = [round(float(x), 4) for x in q]
        per = 1e3 / max(1, len(launch_s) * size_t)
        ctx.notes["host_ms_per_frame"] = {
            n: round(spans.total_s(n, range(warm + traced_n, warm + launches)) * per, 3)
            for n in ("read", "dispatch", "depth", "sink", "launch")}
    frames_traced = traced_n * size_t
    untraced = range(warm + traced_n, warm + launches)
    layer = {
        "spans": spans, "trace": trace, "frames_traced": frames_traced,
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
    """The three numbers of ``check.py`` over the compared chunks. The
    reference runs each chunk in float32, from fresh trackers over the
    first chunks and from the program's trackers over the window's: its
    model and temporal depth filter on its own (``depth_gap``,
    ``state_gap``), and its whole stereo stage on the program's depth
    (``frame_off_share``). ``detail``, when given, gets each chunk's
    readings."""
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
            depth = ref_render.depth_of(mm, sd, mcfg, size, geom, ref_render.source(geom, *planes))
            after = ref_render.carry(own, depth)
            d_gap, shares, fields_b = math.nan, None, {}
            if k in record["depth"]:
                prog_depth = record["depth"][k].to(dev)
                d_gap = float((prog_depth - depth).abs().max())
                del depth
                after_b, _, out = ref_render.chunk(mm, params, sd, mcfg, size, geom, on_prog,
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
                detail[k] = {"depth": d_gap, "state": {f: v for f, v in fields.items() if v > 0}}
                if shares is not None:
                    detail[k].update({f"off_tol{t}_max": float(a.max()) for t, a in shares.items()})
                    detail[k]["mean_gap_u8_max"] = float(mean_gap.max())
                    detail[k]["state_on_prog_depth"] = {f: v for f, v in fields_b.items() if v > 0}
            del planes
    return gaps
