"""The port's frame tools (Real-ESRGAN, RIFE, the merged pipeline) against
the JAX package, on numpy-seeded inputs at toy sizes.

Weights: the JAX modules' flax params go through ``*_from_jax_params``
into the port's modules. Tolerances (float32):
- ``flow_warp`` (one image) and ``flow_warp_batch``: 1e-6 (the same
  4-gather formula);
- pixel (un)shuffle: exact (pure data movement);
- RRDBNet and IFNet outputs: 1e-5 (summation order of the convs, carried
  through the network and, for IFNet, through the flow warps);
- the staged ESRGAN route against whole-frame apply: 2e-6, the JAX
  package's own bound for the same comparison;
- the merged pipeline end to end: max |d| <= 1 on the written u8 YUV420
  planes (a value on a rounding boundary may land one step apart).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
torch.set_num_threads(1)

import visiondepth3d_tpu_torch.enhance.pipeline as tpipe
from visiondepth3d_tpu.enhance import esrgan as jesr
from visiondepth3d_tpu.enhance import rife as jrife
from visiondepth3d_tpu.enhance.pipeline import EnhanceConfig as JConfig
from visiondepth3d_tpu.enhance.pipeline import run_merged_pipeline as jrun
from visiondepth3d_tpu.ops import flow_warp as jflow
from test_torch_reference import bounded
from visiondepth3d_tpu_torch.cli.main import main as cli_main
from visiondepth3d_tpu_torch.enhance import esrgan as tesr
from visiondepth3d_tpu_torch.enhance import rife as trife
from visiondepth3d_tpu_torch.enhance.convert import ifnet_from_jax_params, rrdbnet_from_jax_params
from visiondepth3d_tpu_torch.enhance.pipeline import EnhanceConfig, run_merged_pipeline
from visiondepth3d_tpu_torch.io import Y4MPlaneReader, Y4MReader, Y4MWriter
from visiondepth3d_tpu_torch.ops.flow_warp import flow_warp, flow_warp_batch
from visiondepth3d_tpu_torch.utils.onnx_reader import write_onnx_initializers


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _jax_params(model, seed, *inputs, jitter=0.0):
    """Flax init, plus seeded noise on every leaf so that zero biases and
    unit betas are exercised too."""
    params = model.init(jax.random.PRNGKey(seed), *map(jnp.asarray, inputs))["params"]
    if jitter:
        rng = np.random.default_rng(seed)
        params = jax.tree.map(
            lambda v: v + jitter * jnp.asarray(rng.standard_normal(v.shape), v.dtype), params)
    return params


def _write_clip(path, w, h, n, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    with Y4MWriter(str(path), w, h, 24.0) as wr:
        for i in range(n):
            f = np.empty((h, w, 3), np.uint8)
            f[..., 0] = (xx * 7 + 9 * i) % 256
            f[..., 1] = (yy * 9) % 256
            f[..., 2] = rng.integers(0, 256, (h, w))
            wr.write(f)


def _read(path):
    with Y4MReader(str(path)) as rd:
        return rd.fps, np.stack(list(rd))


def _planes(path):
    frames = []
    with Y4MPlaneReader(str(path)) as rd:
        while (f := rd.read()) is not None:
            frames.append(f)
        return frames, rd.fps


# ------------------------------------------------------------------ ops

FLOW_CASES = ["identity", "integer_shift", "random_past_borders"]


def _flow_case(case):
    rng = np.random.default_rng(4)
    img = rng.random((2, 12, 20, 3), dtype=np.float32)
    flow = np.zeros((2, 12, 20, 2), np.float32)
    if case == "integer_shift":
        flow[..., 0], flow[..., 1] = 3.0, -2.0
    elif case == "random_past_borders":
        flow = (rng.standard_normal((2, 12, 20, 2)) * 9).astype(np.float32)
    return img, flow


@pytest.mark.parametrize("case", FLOW_CASES)
def test_flow_warp_matches_jax(case):
    """The batch form against JAX's ``flow_warp_batch``."""
    img, flow = _flow_case(case)
    got = flow_warp_batch(_t(img), _t(flow)).numpy()
    want = np.asarray(jflow.flow_warp_batch(jnp.asarray(img), jnp.asarray(flow)))
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    if case == "identity":
        np.testing.assert_allclose(got, img, atol=1e-6, rtol=0)


@pytest.mark.parametrize("case", FLOW_CASES)
def test_flow_warp_one_image_matches_jax(case):
    """The one-image form ([H, W, C], [H, W, 2]) against JAX's ``flow_warp``."""
    img, flow = _flow_case(case)
    for i in range(img.shape[0]):
        got = flow_warp(_t(img[i]), _t(flow[i])).numpy()
        want = np.asarray(jflow.flow_warp(jnp.asarray(img[i]), jnp.asarray(flow[i])))
        assert got.shape == img.shape[1:]
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("r", [2, 4])
def test_pixel_shuffles_exact(r):
    x = np.random.default_rng(r).random((2, 8, 12, 3 * r * r), dtype=np.float32)
    np.testing.assert_array_equal(trife.pixel_shuffle(_t(x), r).numpy(),
                                  np.asarray(jrife.pixel_shuffle(jnp.asarray(x), r)))
    y = np.ascontiguousarray(x[..., :3])
    np.testing.assert_array_equal(tesr._pixel_unshuffle(_t(y), r).numpy(),
                                  np.asarray(jesr._pixel_unshuffle(jnp.asarray(y), r)))


# ------------------------------------------------------------------ models

# (scale, n_up, unshuffle): Real-ESRGAN x4 / x2 / x1, KAIR/BSRGAN x2 / x4
RRDB_STYLES = {"realesrgan_x4": (4, 2, True), "realesrgan_x2": (2, 2, True),
               "realesrgan_x1": (1, 2, True), "kair_x2": (2, 1, False),
               "kair_x4": (4, 2, False)}


@pytest.mark.parametrize("style", sorted(RRDB_STYLES))
def test_rrdbnet_matches_jax(style):
    scale, n_up, unshuffle = RRDB_STYLES[style]
    x = np.random.default_rng(1).random((1, 8, 12, 3), dtype=np.float32)
    jm = jesr.RRDBNet(nf=16, nb=2, gc=8, scale=scale, n_up=n_up, unshuffle=unshuffle)
    params = _jax_params(jm, 0, x, jitter=0.02)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    tm = tesr.RRDBNet(16, 2, 8, scale, n_up, unshuffle)
    tm.load_state_dict(rrdbnet_from_jax_params(_np(params)))
    with torch.no_grad():
        got = tm(_t(x)).numpy()
    assert got.shape == want.shape == (1, 8 * scale, 12 * scale, 3)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def _rdb_concat(m, x):
    """The dense block as written with concatenations (the JAX package's
    form), on the port's convs."""
    x1 = m.conv1(x)
    x2 = m.conv2(torch.cat([x, x1], -1))
    x3 = m.conv3(torch.cat([x, x1, x2], -1))
    x4 = m.conv4(torch.cat([x, x1, x2, x3], -1))
    return x + 0.2 * m.conv5(torch.cat([x, x1, x2, x3, x4], -1))


@pytest.mark.parametrize("nf,gc", [(16, 8), (64, 32)])
def test_buffered_dense_block_matches_jax_and_concat(nf, gc):
    """The one-buffer ResidualDenseBlock equals the concat form bit for bit
    and the JAX package's block (flax params through the converter)."""
    x = np.random.default_rng(nf).random((1, 6, 10, nf), dtype=np.float32)
    jm = jesr.ResidualDenseBlock(nf=nf, gc=gc)
    params = _jax_params(jm, 3, x, jitter=0.02)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    sd = rrdbnet_from_jax_params({"body0": {"rdb1": _np(params)}})
    tm = tesr.ResidualDenseBlock(nf, gc)
    tm.load_state_dict({k.removeprefix("body.0.rdb1."): v for k, v in sd.items()})
    with torch.no_grad():
        got = tm(_t(x))
        concat = _rdb_concat(tm, _t(x))
    assert torch.equal(got, concat)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("res_prelu", [False, True])
def test_ifnet_matches_jax(res_prelu):
    rng = np.random.default_rng(2)
    a, b = (rng.random((2, 16, 24, 3), dtype=np.float32) for _ in range(2))
    cfg = jrife.IFNetConfig(cs=(32, 16), scales=(2, 1), n_res=2, res_prelu=res_prelu)
    jm = cfg.build()
    params = _jax_params(jm, 1, a, b, jitter=0.1)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(a), jnp.asarray(b), 0.25))
    tcfg = trife.IFNetConfig(**dataclasses.asdict(cfg))
    tm = tcfg.build()
    tm.load_state_dict(ifnet_from_jax_params(_np(params), tcfg))
    with torch.no_grad():
        got = tm(_t(a), _t(b), 0.25).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    seq = trife.interpolate_pairs(tm, _t(a), multiplier=2)
    jseq = jrife.interpolate_pairs(params, jm, jnp.asarray(a), multiplier=2)
    np.testing.assert_allclose(seq.numpy(), np.asarray(jseq), atol=1e-5, rtol=0)


@pytest.mark.parametrize("scale", [4, 2])
def test_staged_esrgan_exact_and_matches_jax(scale):
    """apply_rrdbnet_staged (trunk whole, x4 tail tiled with a clamped halo)
    against the port's whole-frame apply and the JAX package's staged route,
    and the dispatcher's switch to it above the threshold."""
    x = np.random.default_rng(7).random((1, 24, 32, 3), dtype=np.float32)
    jm = jesr.RRDBNet(nf=16, nb=1, gc=8, scale=scale)
    params = _jax_params(jm, 3, x, jitter=0.02)
    tm = tesr.RRDBNet(16, 1, 8, scale)
    tm.load_state_dict(rrdbnet_from_jax_params(_np(params)))
    fh = 24 // (4 // scale)
    with torch.no_grad():
        whole = tm(_t(x)).numpy()
        staged = tesr.apply_rrdbnet_staged(tm, _t(x), tail_tile_hw=(fh // 2, 8)).numpy()
    jstaged = np.asarray(jesr.apply_rrdbnet_staged(jm, params, jnp.asarray(x),
                                                   tail_tile_hw=(fh // 2, 8)))
    np.testing.assert_allclose(staged, whole, atol=2e-6, rtol=0)
    np.testing.assert_allclose(staged, jstaged, atol=1e-5, rtol=0)
    cfg = EnhanceConfig(esrgan_nf=16, esrgan_nb=1, esrgan_gc=8, esrgan_scale=scale)
    with torch.no_grad():
        np.testing.assert_array_equal(tpipe._apply_esrgan(cfg, tm, _t(x)).numpy(), whole)
        orig, tpipe._STAGE_THRESHOLD_PX = tpipe._STAGE_THRESHOLD_PX, 1
        try:
            routed = tpipe._apply_esrgan(cfg, tm, _t(x)).numpy()
        finally:
            tpipe._STAGE_THRESHOLD_PX = orig
    np.testing.assert_allclose(routed, whole, atol=2e-6, rtol=0)


# ------------------------------------------------------------------ weights

def _kair_state(state: dict) -> dict:
    """Real-ESRGAN names -> KAIR/BSRGAN names (RRDB_trunk.N.RDBM, trunk_conv,
    upconv1/2, HRconv)."""
    out = {}
    for k, v in state.items():
        if k.startswith("body."):
            parts = k.split(".")
            k = ".".join(["RRDB_trunk", parts[1], parts[2].upper(), *parts[3:]])
        for old, new in (("conv_body.", "trunk_conv."), ("conv_up1.", "upconv1."),
                         ("conv_up2.", "upconv2."), ("conv_hr.", "HRconv.")):
            if k.startswith(old):
                k = new + k[len(old):]
        out[k] = v
    return out


@pytest.mark.parametrize("case", ["realesrgan_x2_model_prefix", "kair_x2_override",
                                  "kair_x4"])
def test_convert_esrgan_matches_jax(case):
    scale, n_up, unshuffle = {"realesrgan_x2_model_prefix": (2, 2, True),
                              "kair_x2_override": (2, 1, False), "kair_x4": (4, 2, False)}[case]
    net = tesr.RRDBNet(16, 2, 8, scale, 2, unshuffle)  # a .pth keeps upconv2 at x2
    gen = torch.Generator().manual_seed(5)
    state = {k: torch.randn(v.shape, generator=gen) for k, v in net.state_dict().items()}
    hint = None
    if case == "realesrgan_x2_model_prefix":
        state = {f"model.{k}": v for k, v in state.items()}
    else:
        state = _kair_state(state)
        hint = 2 if case == "kair_x2_override" else None
    got, cfg = tesr.convert_esrgan(state, scale=hint)
    jparams, jcfg = jesr.convert_esrgan({k: v.numpy() for k, v in state.items()}, scale=hint)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert (cfg.scale, cfg.n_up, cfg.unshuffle) == (scale, n_up, unshuffle)
    want = rrdbnet_from_jax_params(_np(jparams))
    assert set(got) == set(want)
    for k in want:
        torch.testing.assert_close(got[k], want[k], atol=0, rtol=0)
    cfg.build().load_state_dict(got)


def test_convert_esrgan_names_supported_families():
    """A non-RRDBNet checkpoint (SRVGGNetCompact: body.N.weight) fails with an
    error that names the supported families."""
    srvgg = {f"body.{i}.weight": np.zeros((64, 3 if i == 0 else 64, 3, 3), np.float32)
             for i in range(3)}
    with pytest.raises(ValueError, match="RRDBNet.*KAIR/BSRGAN"):
        tesr.convert_esrgan(srvgg)


@pytest.mark.parametrize("res_prelu", [False, True])
def test_convert_rife_matches_jax(res_prelu):
    tcfg = trife.IFNetConfig(cs=(32, 16, 8), scales=(4, 2, 1), n_res=2, res_prelu=res_prelu)
    gen = torch.Generator().manual_seed(6)
    state = {f"module.{k}": torch.randn(v.shape, generator=gen)
             for k, v in tcfg.build().state_dict().items()}
    state["module.block_tea.conv0.0.0.weight"] = torch.zeros(4, 4, 3, 3)  # ignored
    got, cfg = trife.convert_rife(state)
    jparams, jcfg = jrife.convert_rife({k: v.numpy() for k, v in state.items()})
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    want = ifnet_from_jax_params(_np(jparams), cfg)
    assert set(got) == set(want)
    for k in want:
        torch.testing.assert_close(got[k], want[k], atol=0, rtol=0)


# ------------------------------------------------------------------ pipeline

@pytest.mark.parametrize("case", ["keep_size", "pre_downscale_blend_upscaled"])
def test_merged_pipeline_matches_jax(tmp_path, case):
    """ESRGAN x4 + RIFE x2 over a 6-frame 32x24 clip in chunks of 3, so the
    pair carry crosses two chunk boundaries and the last chunk is padded:
    resized back to the source size, or pre-downscaled by 2, blended with
    the bilinear-upscaled source and written at the upscaled size."""
    src = tmp_path / "in.y4m"
    _write_clip(src, 32, 24, 6)
    kw = dict(esrgan_nf=8, esrgan_nb=1, esrgan_gc=8, esrgan_scale=4, use_rife=True,
              fps_multiplier=2, chunk_size=3)
    if case == "pre_downscale_blend_upscaled":
        kw.update(pre_downscale=0.5, keep_original_size=False, blend_mode="MEDIUM")
    out_hw = (24, 32) if case == "keep_size" else (48, 64)
    x = np.zeros((1, 16, 16, 3), np.float32)
    jep = _jax_params(jesr.RRDBNet(nf=8, nb=1, gc=8, scale=4), 0, x, jitter=0.02)
    rcfg = jrife.IFNetConfig(cs=(16, 8), scales=(2, 1), n_res=2)
    jrp = _jax_params(rcfg.build(), 1, x, x, jitter=0.05)
    n_jax = bounded(jrun, src, tmp_path / "jax.y4m", JConfig(**kw), esrgan_params=jep,
                    rife_params=(jrp, rcfg))
    tcfg = trife.IFNetConfig(**dataclasses.asdict(rcfg))
    n = run_merged_pipeline(src, tmp_path / "port.y4m", EnhanceConfig(**kw),
                            esrgan_params=rrdbnet_from_jax_params(_np(jep)),
                            rife_params=(ifnet_from_jax_params(_np(jrp), tcfg), tcfg),
                            device="cpu")
    assert n == n_jax == (6 - 1) * 2 + 1
    # compare what was written: the YUV420 planes (decoding them to RGB
    # would turn a one-step difference into up to two)
    got, fps = _planes(tmp_path / "port.y4m")
    want, jfps = _planes(tmp_path / "jax.y4m")
    assert abs(fps - 48.0) < 1e-3 and abs(jfps - fps) < 1e-6
    assert len(got) == len(want) == 11 and got[0][0].shape == out_hw
    for g, w in zip(got, want):
        for gp, wp in zip(g, w):
            assert np.abs(gp.astype(int) - wp.astype(int)).max() <= 1


def test_merged_pipeline_upscaled_size_and_weights_error(tmp_path):
    src = tmp_path / "in.y4m"
    _write_clip(src, 32, 24, 3)
    cfg = EnhanceConfig(esrgan_scale=2, esrgan_nf=8, esrgan_nb=1, esrgan_gc=8,
                        keep_original_size=False, pre_downscale=0.5, use_rife=False,
                        chunk_size=2, allow_random_weights=True)
    n = run_merged_pipeline(src, tmp_path / "out.y4m", cfg, device="cpu")
    _, frames = _read(tmp_path / "out.y4m")
    assert n == 3 and frames.shape == (3, 24, 32, 3)  # int(dim * 0.5) * 2
    with pytest.raises(ValueError, match="converted checkpoints"):
        run_merged_pipeline(src, tmp_path / "x.y4m", EnhanceConfig(rife_scales=(2, 1)),
                            device="cpu")
    # dp=2 on the CPU twice: the same bytes as one device; tp refused (dp only)
    assert run_merged_pipeline(src, tmp_path / "dp.y4m", cfg, mesh_axes={"dp": 2},
                               device="cpu") == 3
    assert (tmp_path / "dp.y4m").read_bytes() == (tmp_path / "out.y4m").read_bytes()
    with pytest.raises(ValueError, match="only the dp"):
        run_merged_pipeline(src, tmp_path / "x.y4m", cfg, mesh_axes={"dp": 2, "tp": 2},
                            device="cpu")


def test_tools_cli_cpu(tmp_path):
    """`vd3d-torch tools` on the CPU with a catalog ESRGAN file: a KAIR .pth-
    style table that keeps the unused upconv2 (so its names alone say x4)
    is read as x2 because the catalog entry's scale is passed on."""
    src = tmp_path / "in.y4m"
    _write_clip(src, 16, 12, 3)
    net = tesr.RRDBNet(8, 1, 8, scale=4, n_up=2, unshuffle=False)
    tpipe.init_random_(net, torch.Generator().manual_seed(0))
    wdir = tmp_path / "weights"
    wdir.mkdir()
    write_onnx_initializers(wdir / tesr.ESRGAN_CATALOG["BSRGANx2"]["file"],
                            {k: v.numpy() for k, v in _kair_state(net.state_dict()).items()})
    out = tmp_path / "out.y4m"
    rc = cli_main(["tools", "--input", str(src), "--output", str(out), "--esrgan",
                   "--esrgan-model", "BSRGANx2", "--weights-dir", str(wdir), "--upscaled-size",
                   "--rife", "--allow-random-weights", "--chunk-size", "2", "--device", "cpu"])
    assert rc == 0
    fps, frames = _read(out)
    assert frames.shape == (5, 24, 32, 3) and abs(fps - 48.0) < 1e-3
    # --mesh dp=2 with --device cpu: two runs on the CPU, the same frames
    assert cli_main(["tools", "--input", str(src), "--output", str(tmp_path / "dp.y4m"),
                     "--esrgan", "--esrgan-model", "BSRGANx2", "--weights-dir", str(wdir),
                     "--upscaled-size", "--rife", "--allow-random-weights", "--chunk-size",
                     "2", "--device", "cpu", "--mesh", "dp=2"]) == 0
    assert (tmp_path / "dp.y4m").read_bytes() == out.read_bytes()
    with pytest.raises(SystemExit):
        cli_main(["tools", "--input", str(src), "--rife", "--allow-random-weights",
                  "--device", "cpu", "--mesh", "sp=2"])
    # --control is ported: 'cancel' stops before the first chunk
    (tmp_path / "ctl").write_text("cancel")
    out = tmp_path / "cancelled.y4m"
    assert cli_main(["tools", "--input", str(src), "--output", str(out), "--rife",
                     "--allow-random-weights", "--device", "cpu", "--control",
                     str(tmp_path / "ctl")]) == 0
    with Y4MReader(str(out)) as rd:
        assert rd.count() == 0


def test_entry_points_default_to_the_card(tmp_path):
    """Without a card, every entry point called without a device raises
    instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    from visiondepth3d_tpu_torch.depth import DA_TINY
    from visiondepth3d_tpu_torch.depth.registry import load_predictor

    src = tmp_path / "in.y4m"
    _write_clip(src, 16, 12, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_predictor("depth-anything-v2-small", None, inference_size=28, config=DA_TINY)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_merged_pipeline(src, tmp_path / "x.y4m",
                            EnhanceConfig(use_esrgan=False, rife_scales=(2, 1),
                                          allow_random_weights=True))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli_main(["tools", "--input", str(src), "--output", str(tmp_path / "y.y4m"),
                  "--rife", "--allow-random-weights"])
