"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the program; names are compared whole at the
top level (the port's name begins with the JAX package's)."""

import ast
import json
import subprocess
import sys
from pathlib import Path

from portbench.core import guard

PKG = Path(__file__).resolve().parents[1]
ROOT = PKG.parent


def test_top_level_names_compared_whole():
    assert guard.forbidden_modules({"visiondepth3d_tpu_torch": 1,
                                    "visiondepth3d_tpu_torch.depth": 1}) == []
    assert guard.forbidden_modules({"visiondepth3d_tpu": 1, "jaxlib.xla": 1, "jaxtyping": 1,
                                    "flax.linen": 1}) == ["flax.linen", "jaxlib.xla",
                                                          "visiondepth3d_tpu"]


def _modules_after(imports: list[str]) -> list[str]:
    code = ("import sys, json; sys.path.insert(0, %r)\n" % str(ROOT)
            + "".join(f"import {m}\n" for m in imports)
            + "print(json.dumps(sorted(sys.modules)))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, cwd=ROOT)
    return json.loads(out.stdout.strip().splitlines()[-1])


def _harness_modules() -> list[str]:
    return sorted("portbench." + ".".join(p.relative_to(PKG).with_suffix("").parts)
                  for p in PKG.rglob("*.py")
                  if "tests" not in p.parts and p.name != "__init__.py"
                  and "." not in p.stem and (p.parent / "__init__.py").exists())


def test_harness_and_port_import_no_jax():
    """Every harness module, the route, the readers and the port's render
    path, imported in one fresh process."""
    from portbench.core.spec import Benchmark, load_module, rooflines

    mods = _harness_modules() + ["portbench.core.runner", "visiondepth3d_tpu_torch",
                                 "visiondepth3d_tpu_torch.pipeline.stereo_pipeline",
                                 "visiondepth3d_tpu_torch.depth.registry"]
    loaded = _modules_after(mods)
    assert guard.forbidden_modules(loaded) == []
    bench = Benchmark(ROOT)
    for m in bench.data["per_layer"]:
        bench.metric_reader(m["name"])
    bench.route("render_fused")
    rooflines()
    assert load_module(PKG / "control.py", "portbench_control_guard")


def test_reference_imports_nothing_of_the_program():
    loaded = _modules_after([f"portbench.reference.{p.stem}"
                             for p in (PKG / "reference").glob("*.py")
                             if p.stem != "__init__"])
    assert not [n for n in loaded if guard.top_level(n) in (guard.PORT, *guard.FORBIDDEN)]
    for path in (PKG / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom) and node.level == 0
                     else [])
            for name in names:
                assert guard.top_level(name) not in (guard.PORT, *guard.FORBIDDEN), \
                    f"{path.name} imports {name}"
