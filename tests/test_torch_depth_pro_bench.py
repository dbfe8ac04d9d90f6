"""Depth Pro in the port's benchmark: the plain reference
(``portbench/reference/depth_pro.py``), its FLOP model, the spans inside
the port's forward, the memory repair, the readers and the cell's route.

On the CPU, at a tiny config that keeps the published ratios, overlaps and
window grid (384 px windows of a /16 ViT are 24 x 24 tokens; here 48 px
windows of a /2 ViT), so a frame is 1 + 9 + 25 windows and the seams are
trimmed as published (6 and 3 tokens), at widths of 32:
- the reference's weight list is the port model's state dict at the
  published widths (951,991,330 parameters) and transformers' (without the
  unused masked-image tokens);
- the reference against the port's ``DepthPro`` and ``predict_01``, and
  against transformers' ``DepthProForDepthEstimation``, on one seeded
  state dict: within float32 rounding;
- the FLOP model against ``FlopCounterMode`` on the port's model on the
  meta device at the published widths (19.28 TFLOP a frame, within 1 %:
  the counter adds the resizes' products);
- under the CPU profiler every top-level operation of the forward lies in
  one of the six leaf spans, the ``depth.windows`` counter reads 35 a
  frame and ``depth.fusion_groups`` 1 a forward;
- the patch encoder's trunk keeps only the tapped block outputs, and the
  model's output is bit for bit the forward that kept every block's;
- the ``depthpro.*`` readers on a synthetic trace, and None on a program
  without the spans;
- the route rehearsed end to end, correct, and not correct when the
  program's seam trimming is broken or when the reference in TF32 stands
  in for the program (the control).
"""

from __future__ import annotations

import copy
import json
import math
from pathlib import Path

import pytest
import torch
torch.set_num_threads(1)

from portbench.core import runner, weights
from portbench.core.program_spans import ProgramSpans
from portbench.core.spec import Benchmark, flops_model
from portbench.core.trace import TraceView
from portbench.reference import depth_pro as ref_dp
from portbench.reference.precision import Mat

ROOT = Path(__file__).resolve().parents[1]
CELL = "depth-pro.sbs1080-1536"
LEAVES = ("depth.windows", "depth.patch_encoder", "depth.merge", "depth.image_encoder",
          "depth.fusion", "depth.fov")
SIZE = 192  # 4 x the image encoder's 48: the 0.25 scale holds one window
OUT = 1536  # the decoder's size is the grid's (24) times 64, whatever the pixels
TINY_MIX = {"name": "tinydp", "route": "render_fused_depth_pro", "width": 128, "height": 72,
            "frames": 6, "fps": 24, "output_format": "Full-SBS", "output_height": 72,
            "preserve_aspect": True, "chunk_size": 2, "stereo": {}, "warmup_chunks": 2,
            "trace_chunks": 1, "check_chunks": 1}


def published() -> dict:
    return json.loads((ROOT / "portbench" / "configs" / "depth-pro.json").read_text())


def tiny_config() -> dict:
    conf = copy.deepcopy(published())
    for k in ("patch_model_config", "image_model_config", "fov_model_config"):
        conf[k].update(hidden_size=32, num_hidden_layers=4, num_attention_heads=2,
                       patch_size=2, image_size=48)
    conf.update(name="tiny-depth-pro", patch_size=48, scaled_images_feature_dims=[32, 32, 16],
                intermediate_hook_ids=[3, 1], intermediate_feature_dims=[16, 16],
                fusion_hidden_size=16, inference_size=SIZE, check_catalog=False)
    return conf


def _route():
    return Benchmark(ROOT).route("render_fused_depth_pro")


def _state(conf, seed=5):
    cfg = ref_dp.model_cfg(conf)
    sd, _ = weights.state_dict(ref_dp.param_specs(cfg), seed, "cpu")
    return cfg, sd


def _port_model(conf, sd):
    from visiondepth3d_tpu_torch.depth.depth_pro import DepthPro

    model = DepthPro(_route().port_model_config(conf)).eval()
    model.load_state_dict(sd)
    return model


def _hf_model(conf):
    from transformers import DepthProConfig, DepthProForDepthEstimation
    from transformers.models.dinov2 import Dinov2Config

    keys = ("hidden_size", "num_hidden_layers", "num_attention_heads", "mlp_ratio", "patch_size",
            "image_size", "layer_norm_eps", "layerscale_value")
    sub = {k: Dinov2Config(**{x: conf[k][x] for x in keys})
           for k in ("patch_model_config", "image_model_config", "fov_model_config")}
    skip = set(sub) | {"name", "source", "port_model", "family", "dtype", "tf32",
                       "inference_size", "fast_head", "check_catalog", "architectures",
                       "model_type", "assumed"}
    cfg = DepthProConfig(**sub, **{k: v for k, v in conf.items() if k not in skip})
    return DepthProForDepthEstimation(cfg).eval()


def _pixels(n=2, seed=1):
    return torch.rand((n, 3, SIZE, SIZE), generator=torch.Generator().manual_seed(seed)) * 2 - 1


def _close(a, b, rel=1e-5):
    return float((a - b).abs().max()) <= rel * float(b.abs().max())


def test_reference_weights_are_the_port_models():
    """At the published widths, name for name and shape for shape; 952.0 M."""
    from visiondepth3d_tpu_torch.depth.depth_pro import DepthPro

    cfg = ref_dp.model_cfg(published())
    with torch.device("meta"):
        model = DepthPro(_route().port_model_config(published()))
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    got = {n: s for n, s, _, _ in ref_dp.param_specs(cfg)}
    assert got == want
    assert sum(math.prod(s) for s in got.values()) == 951_991_330


def test_reference_weights_are_transformers_names():
    hf = {k: tuple(v.shape) for k, v in _hf_model(tiny_config()).state_dict().items()
          if not k.endswith("embeddings.mask_token")}
    got = {n: s for n, s, _, _ in ref_dp.param_specs(ref_dp.model_cfg(tiny_config()))}
    assert got == hf


def test_reference_matches_the_port():
    """Depth and field of view of one seeded state dict, and ``predict_01``
    through ``load_predictor``, within float32 rounding."""
    from visiondepth3d_tpu_torch.depth.registry import load_predictor

    conf = tiny_config()
    cfg, sd = _state(conf)
    x = _pixels()
    with torch.no_grad():
        depth, fov = _port_model(conf, sd)(x)
        rdepth, rfov = ref_dp.forward(Mat(), sd, cfg, x)
    assert depth.shape == (2, OUT, OUT) and _close(depth, rdepth) and _close(fov, rfov)
    assert float(rdepth.amax() - rdepth.amin()) > 1.0  # not a degenerate depth

    pred = load_predictor("depth-pro", checkpoint=sd, inference_size=SIZE,
                          config=_route().port_model_config(conf), device="cpu")
    frames = torch.rand((3, 72, 128, 3), generator=torch.Generator().manual_seed(2))
    got = pred.predict_01(frames, out_hw=(72, 128))
    ref = ref_dp.predict_01(Mat(), sd, cfg, frames, SIZE, (72, 128))
    assert float((got - ref).abs().max()) < 1e-5


def test_reference_matches_transformers():
    conf = tiny_config()
    cfg, sd = _state(conf, seed=9)
    hf = _hf_model(conf)
    missing, unexpected = hf.load_state_dict(sd, strict=False)
    assert not unexpected and all(k.endswith("embeddings.mask_token") for k in missing)
    x = _pixels(seed=3)
    with torch.no_grad():
        out = hf(pixel_values=x)
        rdepth, rfov = ref_dp.forward(Mat(), sd, cfg, x)
    assert _close(out.predicted_depth, rdepth) and _close(out.field_of_view, rfov)


def test_flops_match_the_counter():
    """The FLOP model against torch's counter on the port's model on the
    meta device, one frame at 1536^2."""
    from torch.utils.flop_counter import FlopCounterMode

    from visiondepth3d_tpu_torch.depth.depth_pro import DepthPro

    conf = published()
    with torch.device("meta"):
        model = DepthPro(_route().port_model_config(conf)).eval()
        with torch.no_grad(), FlopCounterMode(display=False) as counter:
            model(torch.empty(1, 3, 1536, 1536))
    ours = flops_model("depth_pro").flops_per_frame(ref_dp.model_cfg(conf), 1536)
    assert abs(ours / counter.get_total_flops() - 1) < 0.01
    assert abs(ours / 19.28e12 - 1) < 0.01


def test_spans_cover_the_forward():
    """Under the profiler each top-level operation of the model's forward
    lies in exactly one leaf span (they do not nest), the windows counter
    reads 35 a frame and the decoder runs the chunk in one group."""
    from torch.profiler import ProfilerActivity, profile

    from visiondepth3d_tpu_torch.utils import observability

    conf = tiny_config()
    _, sd = _state(conf)
    model, x = _port_model(conf, sd), _pixels(n=2)
    observability.reset_records()
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU]) as prof:
        with observability.span("depth"):
            model(x)
    counts = observability.records().counts
    observability.reset_records()
    assert counts == {("depth.windows", None): 70, ("depth.fusion_groups", None): 1}

    def annotation(e):
        return e.name.startswith(observability.SPAN_PREFIX)

    events = prof.events()
    leaves = [e for e in events if annotation(e) and e.name[5:] in LEAVES]
    assert {e.name[5:] for e in leaves} == set(LEAVES)
    for e in leaves:
        p = e.cpu_parent
        assert p is not None and p.name == "vd3d.depth", (e.name, p and p.name)
    ops = [e for e in events if not annotation(e) and e.cpu_parent is not None
           and annotation(e.cpu_parent)]
    assert ops
    for e in ops:
        assert e.cpu_parent.name[5:] in LEAVES, (e.name, e.cpu_parent.name)


def _forward_keeping_every_block(model, pixels):
    """Depth Pro's forward as it was before it dropped its intermediates:
    every block output of the patch encoder kept, each list held to the end."""
    from visiondepth3d_tpu_torch.depth.depth_pro import reconstruct, split_to_patches
    from visiondepth3d_tpu_torch.ops.resize import resize_bilinear

    cfg = model.cfg
    b, _, h, w = pixels.shape
    out_size = cfg.image_model.image_size // cfg.image_model.patch_size
    exp = int(math.log2(w / out_size))
    base_h, base_w = h // 2 ** exp, w // 2 ** exp
    n_scaled = len(cfg.scaled_images_ratios)
    enc, neck = model.depth_pro.encoder, model.depth_pro.neck
    scaled, counts = [], []
    for r, overlap in zip(cfg.scaled_images_ratios, cfg.scaled_images_overlap_ratios):
        img = resize_bilinear(pixels, (int(h * r), int(w * r)), channel_last=False)
        tiles, n = split_to_patches(img, cfg.patch_size, overlap)
        scaled.append(tiles)
        counts.append(n * b)
    trunk = enc.patch_encoder.model
    grid = cfg.patch_size // cfg.patch_model.patch_size
    x = trunk.embeddings(torch.cat(scaled[::-1]), (grid, grid))
    hiddens = []
    for block in trunk.encoder.layer:
        x = block(x)
        hiddens.append(x)
    last = trunk.layernorm(x)
    per_scale_last = torch.split(last, counts[::-1], dim=0)[::-1]
    feats = [reconstruct(per_scale_last[i], b, int(cfg.merge_padding_value
                                                   / cfg.scaled_images_ratios[i]),
                         (base_h * 2 ** i, base_w * 2 ** i)) for i in range(n_scaled)]
    top = 2 ** (n_scaled - 1)
    pad = int(cfg.merge_padding_value * (1 / cfg.scaled_images_ratios[-1]))
    for hook in cfg.intermediate_hook_ids:
        hs = torch.split(hiddens[hook], counts[::-1], dim=0)[0]
        feats.append(reconstruct(hs, b, pad, (base_h * top, base_w * top)))
    img_small = resize_bilinear(pixels, (cfg.image_model.image_size,) * 2, channel_last=False)
    image_last, _ = enc.image_encoder.model(img_small)
    features = [reconstruct(image_last, b, 0, (base_h, base_w)), *feats]
    up = neck.feature_upsample
    features[0] = up.image_block(features[0])
    for i in range(n_scaled):
        features[i + 1] = up.scaled_images[i](features[i + 1])
    for i in range(len(cfg.intermediate_hook_ids)):
        features[n_scaled + i + 1] = up.intermediate[i](features[n_scaled + i + 1])
    fused_low = neck.fuse_image_with_low_res(torch.cat([features[1], features[0]], dim=1))
    features = [fused_low, *features[2:]]
    projected = [p(f) for p, f in zip(neck.feature_projection.projections, features)]
    fused = None
    for layer, hs in zip(model.fusion_stage.intermediate, projected[:-1]):
        fused = layer(hs) if fused is None else layer(fused, hs)
    fused = model.fusion_stage.final(fused, projected[-1])
    return model.head.layers(fused)[:, 0]


def test_trunk_keeps_only_the_taps_and_the_output_is_unchanged():
    conf = tiny_config()
    _, sd = _state(conf, seed=11)
    model = _port_model(conf, sd)
    trunk = model.depth_pro.encoder.patch_encoder.model
    assert trunk.taps == (3, 1)
    assert model.depth_pro.encoder.image_encoder.model.taps == ()
    x = _pixels(n=2, seed=4)
    with torch.no_grad():
        last, taps = trunk(x[:, :, :48, :48])
        assert last.shape == (2, 577, 32) and len(taps) == 2
        depth, _ = model(x)
        assert torch.equal(depth, _forward_keeping_every_block(model, x))


def _trace(with_program: bool):
    """A 100 ms stretch of one chunk (times in ms): five device operations,
    four launched inside Depth Pro's stages when the program has spans."""
    def span(prefix, name, t0, t1):
        return {"ph": "X", "cat": "user_annotation", "name": f"{prefix}{name}",
                "ts": t0 * 1e3, "dur": (t1 - t0) * 1e3}

    def op(corr, launch, t0, t1):
        return [{"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
                 "ts": launch * 1e3, "dur": 5.0, "args": {"correlation": corr}},
                {"ph": "X", "cat": "kernel", "name": f"k{corr}", "ts": t0 * 1e3,
                 "dur": (t1 - t0) * 1e3, "args": {"correlation": corr}}]

    ev = [span("portbench.", "stretch", 0, 100), span("portbench.", "launch", 0, 90),
          span("portbench.", "depth", 1, 60), span("vd3d.", "depth", 2, 59)]
    if with_program:
        ev += [span("vd3d.", "depth.windows", 3, 5), span("vd3d.", "depth.patch_encoder", 5, 20),
               span("vd3d.", "depth.merge", 20, 22), span("vd3d.", "depth.fusion", 30, 50)]
    ev += op(1, 4, 10, 11) + op(2, 6, 11, 31) + op(3, 21, 31, 32) + op(4, 40, 40, 70)
    ev += op(5, 80, 80, 83)
    return ev


READERS = ("depthpro.encoder_device_ms", "depthpro.decoder_device_ms",
           "depthpro.windows_device_ms")


@pytest.mark.parametrize("with_program, want", [(True, (20 / 4, 30 / 4, 2 / 4)),
                                                (False, (None, None, None))])
def test_depth_pro_readers(with_program, want):
    """Device ms a frame by the program's spans; nothing from a program
    without them (the parent's side of the cell)."""
    bench = Benchmark(ROOT)
    ev = _trace(with_program)
    view = TraceView(ev)
    layer = {"trace": view, "program": ProgramSpans(ev, view), "frames_traced": 4}
    for name, value in zip(READERS, want):
        got = bench.metric_reader(name).read(layer)
        assert got is None if value is None else got == pytest.approx(value), name
    names = {m["name"] for m in bench.per_layer(CELL)}
    assert set(READERS) | {"mfu_pct", "depth.device_ms", "loop.events_per_frame"} <= names
    assert "io.read_ms" not in names


@pytest.fixture
def tmpdir_env(tmp_path, monkeypatch):
    """The clip under the test's own directory; the import guard off: this
    process holds JAX (``tests/conftest.py``), and the guard has its own
    test in ``portbench/tests``."""
    import tempfile

    monkeypatch.setenv("TMPDIR", str(tmp_path))
    monkeypatch.setattr(tempfile, "tempdir", None)
    monkeypatch.setattr(runner, "check_imports", lambda: None)


def test_rehearsal_is_correct(tmpdir_env):
    """The route end to end on the CPU: traced, the windows counted, the
    check passed; the program's seams untrimmed, the check failed."""
    bench = Benchmark(ROOT)
    res = runner.run_cell(bench, CELL, 2**31 + 77, 0.5, True, device="cpu",
                          config=tiny_config(), traffic=dict(TINY_MIX))
    assert res["correct"], res["check"]
    notes = res["_notes"]
    assert notes["windows_per_frame"] == 35
    assert set(notes["compared_chunks"]) >= {0, 1}
    assert res["device"]["platform"] == "cpu"
    assert min(min(c["depth_range"]) for c in notes["compared"].values()) > 1.0


def test_untrimmed_seams_are_not_correct(tmpdir_env, monkeypatch):
    from visiondepth3d_tpu_torch.depth import depth_pro

    merge = depth_pro.merge_patches
    monkeypatch.setattr(depth_pro, "merge_patches", lambda p, b, pad: merge(p, b, 0))
    res = runner.run_cell(Benchmark(ROOT), CELL, 7, 0.5, False, device="cpu",
                          config=tiny_config(), traffic=dict(TINY_MIX))
    assert not res["correct"]
    assert res["check"]["depth_gap"]["value"] > res["check"]["depth_gap"]["limit"]


def test_the_tf32_control_is_not_correct(tmpdir_env):
    """The reference in TF32 (emulated on the CPU) put in the program's
    place fails the cell's limits; the float32 reference passes them."""
    from portbench import control_depth_pro
    from portbench.core import check

    bench = Benchmark(ROOT)
    readings = control_depth_pro.read_seed(bench, tiny_config(), dict(TINY_MIX), 4, "cpu",
                                           chunks=1)
    limits = bench.limits(CELL, "render_fused_depth_pro")
    assert not check.combine(readings["control"], limits)[0], readings["control"]
    assert check.combine(readings["float32"], limits)[0]
