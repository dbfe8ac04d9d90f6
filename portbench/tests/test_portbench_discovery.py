"""A configuration, a traffic mix, a route and a per-layer metric are added
by new files and new entries only: the harness finds each by its name, and
no file it already has changes."""

import hashlib
import json
import shutil
from pathlib import Path

from portbench.core.spec import Benchmark

ROOT = Path(__file__).resolve().parents[2]


def _digests(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((root / "portbench").rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def test_added_files_are_found_by_name(tmp_path):
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = _digests(tmp_path)

    pkg = tmp_path / "portbench"
    conf = json.loads((pkg / "configs" / "da2-small.json").read_text())
    conf["name"] = "da2-base"
    (pkg / "configs" / "da2-base.json").write_text(json.dumps(conf))
    mix = json.loads((pkg / "traffic" / "sbs1080.json").read_text())
    mix["route"] = "render_echo"
    (pkg / "traffic" / "sbs720.json").write_text(json.dumps(mix))
    (pkg / "routes" / "render_echo.py").write_text("def run(ctx):\n    return 'echo'\n")
    (pkg / "metrics" / "io.write_ms.py").write_text(
        "def read(layer):\n    return layer.get('write_ms')\n")
    (pkg / "limits" / "render_echo.json").write_text(json.dumps({"depth_gap": 1}))
    data = json.loads((tmp_path / "BENCHMARK.json").read_text())
    data["configs"].append({"name": "da2-base", "source": "https://example.org/base",
                            "file": "portbench/configs/da2-base.json", "reduced": [],
                            "why": "a test"})
    data["workloads"].append({"name": "da2-base.sbs720", "config": "da2-base",
                              "traffic": "sbs720", "chips": 1, "why": "a test"})
    data["per_layer"].append({"name": "io.write_ms", "unit": "ms/frame", "better": "lower",
                              "source": "program_span", "layer": "media I/O", "moves": "fps",
                              "workloads": ["da2-base.sbs720"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(data))

    bench = Benchmark(tmp_path)
    cell = bench.workload("da2-base.sbs720")
    assert bench.config(cell["config"])["name"] == "da2-base"
    assert bench.traffic(cell["traffic"])["route"] == "render_echo"
    assert bench.route("render_echo").run(None) == "echo"
    names = [m["name"] for m in bench.per_layer("da2-base.sbs720")]
    assert names == ["io.write_ms"]
    assert bench.metric_reader("io.write_ms").read({"write_ms": 2.5}) == 2.5
    assert bench.limits("da2-base.sbs720", "render_echo") == {"depth_gap": 1}
    assert [m["name"] for m in bench.end_to_end("da2-base.sbs720")] == [
        "fps", "peak_gib", "setup_s"]
    # the cells that were there keep their metrics, and no file changed
    assert "io.write_ms" not in [m["name"] for m in bench.per_layer("da2-small.sbs2160")]
    after = _digests(tmp_path)
    assert {k: v for k, v in after.items() if k in before} == before


def test_every_named_piece_exists():
    bench = Benchmark(ROOT)
    for cell in bench.data["workloads"]:
        mix = bench.traffic(cell["traffic"])
        bench.config(cell["config"])
        bench.route(mix["route"])
        bench.limits(cell["name"], mix["route"])
        assert bench.per_layer(cell["name"])
    for m in bench.data["per_layer"]:
        assert callable(bench.metric_reader(m["name"]).read)
