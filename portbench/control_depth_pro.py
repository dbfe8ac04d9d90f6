"""The control of the Depth Pro cell's check, at the cell's own sizes:
``control.py``'s ``reference-tf32`` mode with the Depth Pro reference.

The plain reference computed a step below the configuration's precision
(TF32 for float32 with TF32 off) is put in the program's place and read by
the cell's own comparison; beside it, the float32 reference put there (the
comparison of the reference with itself). The program's own modes
(``program``, ``program-bf16-image``) are ``control.py``'s, which runs any
cell:

    python3 portbench/control_depth_pro.py --workload depth-pro.sbs1080-1536 --seeds 11 12
    python3 portbench/control.py --workload depth-pro.sbs1080-1536 --mode program-bf16-image \
        --seconds 4 --seeds 11

Prints one JSON line per seed with every reading, then their extremes.
The benchmark's runs never run this.
"""

import argparse
import json
import sys
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def produce(ctx, mm, params, sd, mcfg, geom, chunks: int) -> dict:
    """The Depth Pro reference in ``mm``'s precision over the first
    ``chunks`` chunks, recorded as a run records the program."""
    import torch

    from portbench.core import clip as clipmod
    from portbench.reference import depth_pro as ref_dp
    from portbench.reference import render as ref_render
    from portbench.reference import stereo as ref_stereo

    mix, dev = ctx.traffic, torch.device(ctx.device)
    size_t, n = mix["chunk_size"], mix["frames"]
    path = clipmod.clip_path(mix["name"], ctx.seed)
    record = {"depth": {}, "before": {}, "after": {}, "out": {}}
    state = ref_stereo.init_trackers(geom.eye_h, geom.eye_w, dev)
    with mm.scope(), torch.inference_mode():
        for k in range(chunks):
            idx = [(k * size_t + i) % n for i in range(size_t)]
            planes = [torch.from_numpy(p).to(dev)
                      for p in clipmod.read_planes(path, mix["width"], mix["height"], idx)]
            if k >= mix["warmup_chunks"]:
                record["before"][k] = {f: v.cpu() for f, v in state.items()}
            depth = ref_dp.predict_01(mm, sd, mcfg, ref_render.source(geom, *planes),
                                      ctx.config["inference_size"], (geom.eye_h, geom.eye_w))
            state, depth, out = ref_render.chunk(mm, params, None, None, None, geom, state,
                                                 *planes, depth=depth)
            record["depth"][k] = depth.cpu()
            record["after"][k] = {f: v.cpu() for f, v in state.items()}
            ys, us, vs = (p.cpu().numpy() for p in out)
            record["out"][k] = [(ys[i], us[i], vs[i]) for i in range(size_t)]
    return record


def read_seed(bench, conf: dict, mix: dict, seed: int, device: str = "cuda",
              precision: str = "tf32", chunks: int = 3) -> dict:
    """The control's readings and the float32 reference's, as the run's
    comparison reads them (each compared chunk's under ``*_detail``)."""
    import torch

    from portbench.core import clip as clipmod
    from portbench.core import weights as wmod
    from portbench.reference import depth_pro as ref_dp
    from portbench.reference import render as ref_render
    from portbench.reference import stereo as ref_stereo
    from portbench.reference.precision import Mat

    route = bench.route(mix["route"])
    mcfg = ref_dp.model_cfg(conf)
    specs = ref_dp.param_specs(mcfg)
    params = ref_stereo.Params(**mix.get("stereo", {}))
    geom = ref_render.full_sbs_geometry(mix["width"], mix["height"], mix["output_height"],
                                        mix["preserve_aspect"])
    dev = torch.device(device)
    ctx = types.SimpleNamespace(device=device, seed=seed, traffic=mix, config=conf)
    path = clipmod.clip_path(mix["name"], seed)
    clipmod.write_clip(path, seed, mix["width"], mix["height"], mix["frames"], mix["fps"], dev)
    readings: dict = {}
    try:
        sd, checksum = wmod.state_dict(specs, seed, dev)
        for label, mm in (("control", Mat(precision)), ("float32", Mat("float32"))):
            record = produce(ctx, mm, params, sd, mcfg, geom, chunks)
            detail: dict = {}
            readings[label] = route.compare(ctx, record, mcfg, specs, checksum, params,
                                            mix["width"], mix["height"], mix["frames"],
                                            mix["chunk_size"], conf["inference_size"],
                                            mix["warmup_chunks"], detail=detail)
            readings[f"{label}_detail"] = detail
            del record
    finally:
        clipmod.remove(path)
    return readings


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--chunks", type=int, default=3)
    args = ap.parse_args(argv)
    from portbench.run import cache_dirs

    cache_dirs(ROOT)

    import torch

    from portbench.core import spec

    bench = spec.Benchmark(ROOT)
    cell = bench.workload(args.workload)
    conf, mix = bench.config(cell["config"]), bench.traffic(cell["traffic"])
    extremes: dict = {}
    for seed in args.seeds:
        readings = read_seed(bench, conf, mix, seed, "cuda", "tf32", args.chunks)
        torch.cuda.empty_cache()
        print(json.dumps({"seed": seed, "mode": "reference-tf32", "readings": readings}),
              flush=True)
        for label, gaps in readings.items():
            if label.endswith("_detail"):
                continue
            for k, v in gaps.items():
                lo, hi = extremes.get(f"{label}.{k}", (v, v))
                extremes[f"{label}.{k}"] = (min(lo, v), max(hi, v))
    print(json.dumps({"extremes (least, most)": extremes}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
