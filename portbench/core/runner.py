"""One run of a cell: the route's run, then the result line.

``run_cell`` loads what the cell names, runs its route and reduces the
route's output to the result; ``emit`` prints it. The CPU rehearsal and
the tests call ``run_cell`` with ``device="cpu"`` (and small configs and
mixes of their own); ``run.py`` calls it only with a card.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
import types

from . import guard


class ForbiddenImport(RuntimeError):
    pass


def check_imports() -> None:
    found = guard.forbidden_modules()
    if found:
        raise ForbiddenImport(f"forbidden modules loaded: {', '.join(found)}")


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return res.stdout.strip().splitlines()[0] if res.returncode == 0 else "unknown"
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def run_cell(bench, workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t0: float | None = None, config: dict | None = None,
             traffic: dict | None = None, program_stereo: dict | None = None) -> dict:
    """Run one cell; ``config`` and ``traffic`` replace the cell's files
    (the rehearsal's small sizes); ``program_stereo`` sets stereo parameters
    on the program's side alone (the control, ``control.py``)."""
    import torch

    t0 = time.perf_counter() if t0 is None else t0
    cell = bench.workload(workload)
    conf = config if config is not None else bench.config(cell["config"])
    mix = traffic if traffic is not None else bench.traffic(cell["traffic"])
    route = bench.route(mix["route"])
    torch.backends.cuda.matmul.allow_tf32 = bool(conf.get("tf32", False))
    torch.backends.cudnn.allow_tf32 = bool(conf.get("tf32", False))

    from .spans import Spans

    ctx = types.SimpleNamespace(
        bench=bench, workload=workload, cell=cell, config=conf, traffic=mix, seed=seed,
        seconds=seconds, trace=trace, device=device, spans=Spans(), notes={}, cleanup=[],
        limits=bench.limits(workload, mix["route"]), check_imports=check_imports,
        setup_s=None, program_stereo=program_stereo or {})

    def mark_setup():
        ctx.setup_s = time.perf_counter() - t0

    ctx.mark_setup = mark_setup
    try:
        out = route.run(ctx)
    finally:
        for fn in reversed(ctx.cleanup):
            fn()
    check_imports()

    metrics = {}
    if trace:
        for m in bench.per_layer(workload):
            value = bench.metric_reader(m["name"]).read(out["layer"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = dict(out["e2e"], setup_s=ctx.setup_s)
        for m in bench.end_to_end(workload):
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": torch.cuda.get_device_name(0) if device == "cuda" else device,
           "count": cell["chips"], "memory_peak_bytes": out["peak_bytes"]}
    result = {"correct": bool(out["correct"]), "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics, "device": dev}
    view = out["layer"].get("trace")
    if trace and view is not None:
        dev["busy_s"] = view.busy_s()
        dev["window_s"] = view.window_s
        result["breakdown"] = {"device_ops": view.top_ops(10), "idle_gaps": view.top_gaps(10)}
        ctx.notes["host_runtime_calls_s"] = sorted(view.host_calls.items(),
                                                   key=lambda kv: -kv[1])[:8]
    result["check"] = {name: {"value": v, "limit": lim} for name, v, lim in out["checks"]}
    result["_notes"] = dict(ctx.notes, **out.get("notes", {}), setup_s=ctx.setup_s,
                            window_s=out.get("window_s"))
    return result


def emit(result: dict) -> int:
    """Print the notes, then the compared numbers as the last lines of
    standard error, and the result as the last line of standard output."""
    notes = result.pop("_notes", {})
    if result["device"]["platform"] == "gpu":
        notes["card"] = card_line()
    print("portbench notes " + json.dumps(notes, default=str), file=sys.stderr)
    for name, c in result["check"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
