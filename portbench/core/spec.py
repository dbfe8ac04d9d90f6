"""The benchmark's pieces, found by the names in ``BENCHMARK.json``.

Every piece that belongs to one configuration, traffic mix, route or
per-layer metric lives in a file of its own under ``portbench/``:

- ``configs/<config>.json``: the configuration as it is run (the file that
  ``BENCHMARK.json`` names for it);
- ``traffic/<mix>.json``: a traffic mix's parameters, naming its ``route``;
- ``routes/<route>.py``: what runs one route of the program;
- ``metrics/<metric>.py``: the reader of one per-layer metric;
- ``roofline/<kernel>.py``: the operations and bytes of one hand kernel;
- ``flops/<family>.py``: a model family's FLOPs per frame;
- ``limits/<workload>.json`` or ``limits/<route>.json``: the limits of the
  numbers that decide ``correct``.

A later change adds a configuration, mix, route, metric, kernel or family
by adding files and entries: nothing here lists them.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent  # portbench/
ROOT = PKG.parent  # the checkout's root, where BENCHMARK.json lies


class SpecError(ValueError):
    pass


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """The Python file at ``path`` as a module named ``name`` (file names may
    hold dots, so they are loaded by path, not imported by name)."""
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise SpecError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


class Benchmark:
    """``BENCHMARK.json`` of one checkout and the files it names."""

    def __init__(self, root: Path = ROOT):
        self.root = Path(root)
        self.pkg = self.root / "portbench"
        self.data = load_json(self.root / "BENCHMARK.json")

    def _entry(self, key: str, name: str) -> dict:
        for e in self.data[key]:
            if e["name"] == name:
                return e
        raise SpecError(f"{key}: no entry named {name!r} in BENCHMARK.json")

    def workload(self, name: str) -> dict:
        return self._entry("workloads", name)

    def config(self, name: str) -> dict:
        entry = self._entry("configs", name)
        cfg = load_json(self.root / entry["file"])
        cfg.setdefault("name", name)
        return cfg

    def traffic(self, name: str) -> dict:
        path = self.pkg / "traffic" / f"{name}.json"
        if not path.exists():
            raise SpecError(f"traffic mix {name!r}: no file {path.relative_to(self.root)}")
        mix = load_json(path)
        mix.setdefault("name", name)
        return mix

    def route(self, name: str):
        return load_module(self.pkg / "routes" / f"{name}.py", f"portbench_route_{name}")

    def end_to_end(self, workload: str) -> list[dict]:
        return [m for m in self.data["end_to_end"] if workload in m.get("workloads", [workload])]

    def per_layer(self, workload: str) -> list[dict]:
        """The per-layer metrics this cell reports: those that list it, and
        those without a list whose end-to-end metric the cell reports."""
        e2e = {m["name"] for m in self.end_to_end(workload)}
        return [m for m in self.data["per_layer"]
                if (workload in m["workloads"] if "workloads" in m else m["moves"] in e2e)]

    def metric_reader(self, name: str):
        path = self.pkg / "metrics" / f"{name}.py"
        if not path.exists():
            raise SpecError(f"per-layer metric {name!r}: no reader {path.relative_to(self.root)}")
        return load_module(path, f"portbench_metric_{name}")

    def limits(self, workload: str, route: str) -> dict:
        for stem in (workload, route):
            path = self.pkg / "limits" / f"{stem}.json"
            if path.exists():
                return load_json(path)
        raise SpecError(f"no limits for {workload!r} (limits/{workload}.json or "
                        f"limits/{route}.json)")


def rooflines(pkg: Path = PKG) -> dict:
    """Every hand kernel's work model, by the file's name."""
    return {p.stem: load_module(p, f"portbench_roofline_{p.stem}")
            for p in sorted((pkg / "roofline").glob("*.py"))}


def flops_model(family: str, pkg: Path = PKG):
    path = pkg / "flops" / f"{family}.py"
    if not path.exists():
        raise SpecError(f"no FLOP model for family {family!r} ({path})")
    return load_module(path, f"portbench_flops_{family}")
