"""The port's benchmark: one run of one cell of ``BENCHMARK.json``.

    python3 portbench/run.py --workload da2-large.sbs1080 --seed 7 --seconds 20 --trace 0

From the root of a checkout with the port (``visiondepth3d_tpu_torch``)
beside this folder, on a machine with as many CUDA cards as the cell asks
for. Prints one JSON object as the last line of standard output: the
cell's end-to-end metrics with ``--trace 0``, its per-layer metrics with
``--trace 1``, and in both whether the output matched the plain reference
(``correct``), with each compared number and its limit under ``check`` and
as the last lines of standard error. Exits non-zero, and prints no result,
without the cards, on any error, or when JAX or the JAX package was loaded.
"""

import time

T0 = time.perf_counter()  # set-up counts from here

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def cache_dirs(root: Path) -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    base = root / ".portbench_cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(base / sub)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache_dirs(ROOT)

    from portbench.core import runner, spec

    bench = spec.Benchmark(ROOT)
    chips = bench.workload(args.workload)["chips"]
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {args.workload} needs {chips} CUDA card(s); this machine has {n}",
              file=sys.stderr)
        return 3
    result = runner.run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace),
                             device="cuda", t0=T0)
    return runner.emit(result)


if __name__ == "__main__":
    sys.exit(main())
