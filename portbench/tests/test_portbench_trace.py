"""The per-layer readers on a synthetic trace with known intervals: the
idle share, the attribution of device operations to the benchmark's spans
by the host time of their launch, the counts and the shares."""

import pytest

from portbench.core.peaks import PEAK_BYTES, PEAK_FLOPS
from portbench.core.spans import Spans
from portbench.core.spec import Benchmark, flops_model
from portbench.core.trace import TraceView
from portbench.reference.depth_anything import model_cfg


def _span(name, t0, t1):
    return {"ph": "X", "cat": "user_annotation", "name": f"portbench.{name}",
            "ts": t0 * 1e3, "dur": (t1 - t0) * 1e3}


def _op(name, corr, launch_ms, t0, t1, cat="kernel"):
    return [{"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": launch_ms * 1e3,
             "dur": 5.0, "args": {"correlation": corr}},
            {"ph": "X", "cat": cat, "name": name, "ts": t0 * 1e3, "dur": (t1 - t0) * 1e3,
             "args": {"correlation": corr}}]


def synthetic() -> TraceView:
    """Two chunks in a 100 ms stretch (times in ms): four device operations,
    two launched from inside ``depth``."""
    ev = [_span("stretch", 0, 100),
          _span("launch", 0, 40), _span("read", 0, 10), _span("dispatch", 10, 30),
          _span("depth", 12, 20),
          _span("launch", 50, 90), _span("read", 50, 60), _span("dispatch", 60, 80),
          _span("depth", 62, 70)]
    ev += _op("sm80_xmma_gemm_f32", 1, 13, 20, 30)
    ev += _op("void stereo_warp_kernel<float>(float const*, int)", 2, 25, 30, 35)
    ev += _op("sm80_xmma_gemm_f32", 3, 63, 70, 85)
    ev += _op("Memcpy DtoH (Device -> Pinned)", 4, 85, 86, 88, cat="gpu_memcpy")
    ev += [{"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 1.0, "dur": 1.0}]
    return TraceView(ev)


@pytest.fixture
def layer(bench):
    cfg = model_cfg(bench.config("da2-small"))
    return {"trace": synthetic(), "frames_traced": 8, "spans": Spans(),
            "untraced_chunks": range(0), "untraced_frames": 0,
            "geometry": {"eye_h": 100, "eye_w": 100, "warp_h": 100, "warp_w": 100},
            "stereo": {"enable_feathering": True, "enable_healing": False, "blur_ksize": 9},
            "image_bytes": 4, "model": cfg, "family": "dpt_dinov2", "inference_size": 518,
            "dtype": "float32", "tf32": False, "fast_head": False, "pkg": bench.pkg}


def _read(bench, name, layer):
    return bench.metric_reader(name).read(layer)


def test_busy_idle_and_gaps():
    view = synthetic()
    assert view.window_s == pytest.approx(0.1)
    assert view.busy_s() == pytest.approx(0.032)
    gaps = view.idle_gaps()
    assert [round(s * 1e3, 6) for s, _ in gaps] == [0, 35, 85, 88]
    assert [round(g * 1e3, 6) for _, g in gaps] == [20, 35, 1, 12]
    # longest first, each named by the innermost span the host was in when
    # it began
    assert [name for name, _ in view.top_gaps()] == ["launch", "read", "launch", "launch"]


def test_attribution_by_launch_time():
    view = synthetic()
    assert len(view.launched_in("launch")) == 4
    assert [o["name"] for o in view.launched_in("depth")] == ["sm80_xmma_gemm_f32"] * 2
    assert view.span_at(0.015) == "depth" and view.span_at(0.045) == "loop"


def test_readers(bench, layer):
    assert _read(bench, "device.idle_pct", layer) == pytest.approx(68.0)
    assert _read(bench, "loop.events_per_frame", layer) == pytest.approx(0.5)
    assert _read(bench, "depth.device_ms", layer) == pytest.approx(25 / 8)
    assert _read(bench, "stereo.device_ms", layer) == pytest.approx(7 / 8)
    bound = max(100 * 100 * 52 / PEAK_BYTES, 38 * 100 * 100 / PEAK_FLOPS["float32"])
    assert _read(bench, "kernels.roofline_pct", layer) == pytest.approx(100 * bound / 5e-3)
    per_frame = flops_model("dpt_dinov2").flops_per_frame(layer["model"], 518)
    assert _read(bench, "mfu_pct", layer) == pytest.approx(
        100 * per_frame * 8 / 0.1 / PEAK_FLOPS["float32"])
    # host spans: nothing outside the stretch, so nothing to read
    assert _read(bench, "io.read_ms", layer) is None
    assert _read(bench, "loop.dispatch_ms", layer) is None


def test_host_span_readers(bench, layer):
    spans = Spans()
    spans.records["read"] = [(0.0, 0.002, 5), (0.0, 0.004, 6), (0.0, 9.0, 1)]
    spans.records["dispatch"] = [(0.0, 0.008, 5), (0.0, 0.008, 6)]
    layer = dict(layer, spans=spans, untraced_chunks=range(5, 7), untraced_frames=4)
    assert _read(bench, "io.read_ms", layer) == pytest.approx(1.5)
    assert _read(bench, "loop.dispatch_ms", layer) == pytest.approx(4.0)


def test_no_trace_reads_nothing(bench, layer):
    layer = dict(layer, trace=None)
    for m in Benchmark().data["per_layer"]:
        if m["name"] not in ("io.read_ms", "loop.dispatch_ms"):
            assert _read(bench, m["name"], layer) is None, m["name"]


def test_no_hand_kernel_reads_no_roofline(bench, layer):
    view = synthetic()
    view.ops = [o for o in view.ops if "stereo_warp" not in o["name"]]
    assert _read(bench, "kernels.roofline_pct", dict(layer, trace=view)) is None
