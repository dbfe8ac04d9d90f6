"""The controls of the check, and the readings its limits are set from,
at the cell's own sizes:

- ``reference-tf32``: the plain reference put in the program's place,
  computed a step below the configuration's precision (TF32 for float32
  with TF32 off), read by the same comparison a run makes; with it, the
  comparison of faults planted in the float32 reference put in the
  program's place: its trackers left unchanged by a chunk, half of a
  chunk's frames left out (the first half delivered twice), one delivered
  frame altered;
- ``program-bf16-image``: the program with its own lower-precision path
  switched on, the stereo stage's image plane in bfloat16, run as
  ``run.py`` runs it with a short window;
- ``program``: the program as the cell states it, run so: the sound
  readings, many seeds in one process.

    python3 portbench/control.py --workload da2-large.sbs1080 --mode reference-tf32 --seeds 11 12 13

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
    """The reference in ``mm``'s precision over the first ``chunks`` chunks,
    recorded as a run records the program."""
    import torch

    from portbench.core import clip as clipmod
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
            state, depth, out = ref_render.chunk(mm, params, sd, mcfg, ctx.config["inference_size"],
                                                 geom, state, *planes)
            record["depth"][k] = depth.cpu()
            record["after"][k] = {f: v.cpu() for f, v in state.items()}
            ys, us, vs = (p.cpu().numpy() for p in out)
            record["out"][k] = [(ys[i], us[i], vs[i]) for i in range(size_t)]
    return record


def read_seed(bench, conf: dict, mix: dict, seed: int, device: str = "cuda",
              precision: str = "tf32", chunks: int = 4) -> dict:
    """Every reading of one seed: the control's, the float32 reference's and
    each planted fault's, as the run's comparison reads them."""
    import copy

    import torch

    from portbench.core import clip as clipmod
    from portbench.core import weights as wmod
    from portbench.reference import depth_anything as ref_da
    from portbench.reference import render as ref_render
    from portbench.reference import stereo as ref_stereo
    from portbench.reference.precision import Mat

    route = bench.route(mix["route"])
    mcfg = ref_da.model_cfg(conf)
    specs = ref_da.param_specs(mcfg)
    params = ref_stereo.Params(**mix.get("stereo", {}))
    geom = ref_render.full_sbs_geometry(mix["width"], mix["height"], mix["output_height"],
                                        mix["preserve_aspect"])
    dev = torch.device(device)
    ctx = types.SimpleNamespace(device=device, seed=seed, traffic=mix, config=conf)
    path = clipmod.clip_path(mix["name"], seed)
    clipmod.write_clip(path, seed, mix["width"], mix["height"], mix["frames"], mix["fps"], dev)
    warm = mix["warmup_chunks"]

    def compare(rec, detail=None):
        return route.compare(ctx, rec, mcfg, specs, checksum, params, mix["width"],
                             mix["height"], mix["frames"], mix["chunk_size"],
                             conf["inference_size"], warm, detail=detail)

    try:
        sd, checksum = wmod.state_dict(specs, seed, dev)
        detail: dict = {}
        readings = {"control": compare(produce(ctx, Mat(precision), params, sd, mcfg, geom,
                                               chunks), detail)}
        readings["control_detail"] = detail
        sound = produce(ctx, Mat("float32"), params, sd, mcfg, geom, chunks)
        readings["float32"] = compare(sound)
        del sd
        bad = copy.deepcopy(sound)
        init = {f: v.cpu() for f, v in ref_stereo.init_trackers(geom.eye_h, geom.eye_w,
                                                                 "cpu").items()}
        for k in bad["after"]:
            bad["after"][k] = bad["before"].get(k, init)
        readings["state_unchanged"] = compare(bad)
        bad = copy.deepcopy(sound)
        half = mix["chunk_size"] // 2
        for k in bad["out"]:
            bad["out"][k] = bad["out"][k][:half] * 2
        readings["half_batch"] = compare(bad)
        bad = copy.deepcopy(sound)
        k0 = max(bad["out"])
        y, u, v = bad["out"][k0][3]
        bad["out"][k0][3] = ((y.astype("int32") + 8).clip(0, 255).astype("uint8"), u, v)
        readings["frame_altered"] = compare(bad)
    finally:
        clipmod.remove(path)
    return readings


PROGRAM_MODES = {"program": {}, "program-bf16-image": {"image_dtype": "bfloat16"}}


def read_program(bench, workload: str, seed: int, seconds: float, mode: str) -> dict:
    """The check of one run of the program (``PROGRAM_MODES``), as ``run.py``
    makes it, with each compared chunk's readings."""
    from portbench.core import runner

    res = runner.run_cell(bench, workload, seed, seconds, False, device="cuda",
                          program_stereo=PROGRAM_MODES[mode])
    return {"correct": res["correct"],
            "check": {k: c["value"] for k, c in res["check"].items()},
            "check_detail": res["_notes"].get("compared", {})}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--mode", choices=["reference-tf32", *PROGRAM_MODES],
                    default="reference-tf32")
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--chunks", type=int, default=4)
    ap.add_argument("--seconds", type=float, default=4.0)
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
        if args.mode == "reference-tf32":
            readings = read_seed(bench, conf, mix, seed, "cuda", "tf32", args.chunks)
        else:
            readings = read_program(bench, args.workload, seed, args.seconds, args.mode)
        torch.cuda.empty_cache()
        print(json.dumps({"seed": seed, "mode": args.mode, "readings": readings}), flush=True)
        for label, gaps in readings.items():
            if label.endswith("_detail") or not isinstance(gaps, dict):
                continue
            for k, v in gaps.items():
                lo, hi = extremes.get(f"{label}.{k}", (v, v))
                extremes[f"{label}.{k}"] = (min(lo, v), max(hi, v))
    print(json.dumps({"extremes (least, most)": extremes}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
