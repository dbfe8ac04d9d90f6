"""The functions the port added to close the JAX package's public surface,
against their JAX counterparts on the CPU: the same numpy inputs from a
seed through both, at toy sizes. Tolerances (float32):

- ``rgb_to_gray``, ``bgr_to_rgb``, ``midtone_shape``: 1e-6;
- ``depth_frame_to_01``: bit for bit (round(gray) / 255);
- ``bilateral_smooth_depth``: 1e-5 (81 taps summed in one order on both
  sides; ``exp`` differs by ulps between XLA's and PyTorch's kernels);
- ``hist_quantile``: 1e-6 (the histogram counts are exact; the inversion
  is a few float32 operations);
- ``extract_tiles``, ``blend_tiles``, ``tiled_apply``: 1e-6;
- ``pop_controls_locked_to_defaults``: field for field;
- ``rife_apply``, ``esrgan_apply``: 1e-5, the tolerance of the IFNet and
  RRDBNet parity tests (``test_torch_enhance.py``);
- ``pixel_shift`` (the public form, at the params' shifts): shift map and
  subject depth within 1e-5, the eyes within 1e-4.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
torch.set_num_threads(1)

from visiondepth3d_tpu.enhance import esrgan as jesr
from visiondepth3d_tpu.enhance import rife as jrife
from visiondepth3d_tpu.ops import convert as jconvert
from visiondepth3d_tpu.ops import depth_shaping as jshaping
from visiondepth3d_tpu.ops import filters as jfilters
from visiondepth3d_tpu.ops import quantiles as jquant
from visiondepth3d_tpu.ops import tiling as jtiling
from visiondepth3d_tpu_torch.enhance import esrgan as tesr
from visiondepth3d_tpu_torch.enhance import rife as trife
from visiondepth3d_tpu_torch.enhance.convert import ifnet_from_jax_params, rrdbnet_from_jax_params
from visiondepth3d_tpu_torch.ops import convert as tconvert
from visiondepth3d_tpu_torch.ops import depth_shaping as tshaping
from visiondepth3d_tpu_torch.ops import filters as tfilters
from visiondepth3d_tpu_torch.ops import quantiles as tquant
from visiondepth3d_tpu_torch.ops import tiling as ttiling


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want, atol):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=0)


def _depth_ramp(h=96, w=160):
    """tests/conftest.py's depth_ramp."""
    yy, xx = np.mgrid[0:h, 0:w]
    d = 0.5 + 0.3 * np.sin(xx / 17.0) * np.cos(yy / 11.0) + 0.2 * (xx / w - 0.5)
    return np.clip(d, 0.0, 1.0).astype(np.float32)


# ------------------------------------------------------------------ convert

@pytest.mark.parametrize("shape", [(24, 40, 3), (2, 12, 20, 3)])
def test_rgb_to_gray_matches_jax(shape):
    x = np.random.default_rng(1).random(shape, dtype=np.float32)
    _close(tconvert.rgb_to_gray(_t(x)), jconvert.rgb_to_gray(jnp.asarray(x)), 1e-6)


@pytest.mark.parametrize("dtype", [np.float32, np.uint8])
def test_bgr_to_rgb_matches_jax(dtype):
    x = (np.random.default_rng(2).random((12, 20, 3)) * 255).astype(dtype)
    got = tconvert.bgr_to_rgb(_t(x)).numpy()
    assert got.dtype == x.dtype
    _close(got, jconvert.bgr_to_rgb(jnp.asarray(x)), 1e-6)


@pytest.mark.parametrize("case", ["random", "gray"])
def test_depth_frame_to_01_matches_jax(case):
    rng = np.random.default_rng(3)
    x = rng.integers(0, 256, (24, 40, 3), dtype=np.uint8)
    if case == "gray":  # a depth video decoded to RGB: near-equal channels
        x = np.clip(x[..., :1].astype(np.int16) + rng.integers(-1, 2, (24, 40, 3)), 0,
                    255).astype(np.uint8)
    got = tconvert.depth_frame_to_01(_t(x)).numpy()
    want = np.asarray(jconvert.depth_frame_to_01(x))
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------------ shaping and filters

@pytest.mark.parametrize("gamma", [0.85, 1.3])
def test_midtone_shape_matches_jax(gamma):
    d = np.random.default_rng(4).uniform(-0.1, 1.1, (24, 40)).astype(np.float32)
    _close(tshaping.midtone_shape(_t(d), gamma), jshaping.midtone_shape(jnp.asarray(d), gamma),
           1e-6)


def _bilateral_input(case):
    if case == "ramp_noise":  # tests/test_stereo_ops.py: the exact u8 grid
        d = _depth_ramp()
        d = np.clip(d + 0.08 * np.random.default_rng(7).standard_normal(d.shape), 0.0, 1.0)
        return (np.round(d * 255.0) / 255.0).astype(np.float32), {}
    if case == "hard_edge":
        d = np.zeros((32, 64), np.float32)
        d[:, 32:] = 1.0
        return d, {}
    d = np.random.default_rng(8).random((20, 36), dtype=np.float32)
    return d, dict(ksize=5, sigma_color=20.0, sigma_space=3.0)


@pytest.mark.parametrize("case", ["ramp_noise", "hard_edge", "small_window"])
def test_bilateral_smooth_depth_matches_jax(case):
    d, kw = _bilateral_input(case)
    got = tfilters.bilateral_smooth_depth(_t(d), **kw)
    _close(got, jfilters.bilateral_smooth_depth(jnp.asarray(d), **kw), 1e-5)
    if case == "hard_edge":  # the edge survives, as the JAX test asks
        assert got[:, :30].max() < 0.02 and got[:, 34:].min() > 0.98


# ------------------------------------------------------------------ quantiles

def _quantile_input(case):
    rng = np.random.default_rng(9)
    if case == "random":  # tests/test_quantiles.py
        return rng.random((128, 128), dtype=np.float32), None
    # every value well inside its bin of 2048
    x = ((rng.integers(0, 2048, (96, 80)) + rng.uniform(0.1, 0.9, (96, 80))) / 2048)
    mask = rng.random((96, 80)) > 0.3 if case == "masked" else None
    return x.astype(np.float32), mask


@pytest.mark.parametrize("case", ["random", "inside_bins", "masked"])
def test_hist_quantile_matches_jax(case):
    x, mask = _quantile_input(case)
    qs = [0.02, 0.05, 0.5, 0.95, 0.98]
    for q in (qs, 0.5):
        got = tquant.hist_quantile(_t(x), q, None if mask is None else _t(mask))
        want = jquant.hist_quantile(jnp.asarray(x), q, None if mask is None
                                    else jnp.asarray(mask))
        assert tuple(got.shape) == tuple(np.shape(want))
        _close(got, want, 1e-6)


# ------------------------------------------------------------------ tiling

TILE_CASES = {"identity_rgb": ((70, 100, 3), (32, 48), 8),
              "square_gray": ((40, 56, 1), (24, 24), 6),
              "one_tile": ((20, 30, 3), (32, 48), 8)}


def _tile_input(case):
    shape, tile_hw, overlap = TILE_CASES[case]
    return np.random.default_rng(10).random(shape, dtype=np.float32), tile_hw, overlap


@pytest.mark.parametrize("case", sorted(TILE_CASES))
def test_extract_tiles_matches_jax(case):
    img, tile_hw, overlap = _tile_input(case)
    got, starts = ttiling.extract_tiles(_t(img), tile_hw, overlap)
    want, jstarts = jtiling.extract_tiles(jnp.asarray(img), tile_hw, overlap)
    assert starts == jstarts
    _close(got, want, 1e-6)


@pytest.mark.parametrize("case", sorted(TILE_CASES))
def test_blend_tiles_matches_jax(case):
    img, tile_hw, overlap = _tile_input(case)
    tiles, starts = jtiling.extract_tiles(jnp.asarray(img), tile_hw, overlap)
    tiles = np.asarray(tiles) * 1.5 + 0.25
    for t in (tiles, tiles[..., 0]):  # [N, th, tw, C] and [N, th, tw]
        got = ttiling.blend_tiles(_t(t), starts, img.shape[:2])
        _close(got, jtiling.blend_tiles(jnp.asarray(t), starts, img.shape[:2]), 1e-6)


@pytest.mark.parametrize("case", sorted(TILE_CASES))
def test_tiled_apply_matches_jax(case):
    img, tile_hw, overlap = _tile_input(case)
    for fn in (lambda t: t, lambda t: t.sum(-1) * 0.5):  # channels out, depth out
        got = ttiling.tiled_apply(fn, _t(img), tile_hw, overlap)
        want = jtiling.tiled_apply(fn, jnp.asarray(img), tile_hw, overlap)
        assert tuple(got.shape) == tuple(want.shape)
        _close(got, want, 1e-6)
    # tests/test_utils_config.py: an identity fn gives the image back
    _close(ttiling.tiled_apply(lambda t: t, _t(img), tile_hw, overlap), img, 1e-5)


# ------------------------------------------------------------------ stereo

POP_FIELDS = ("depth_pop_gamma", "depth_pop_mid", "depth_stretch_lo", "depth_stretch_hi",
              "fg_pop_multiplier", "bg_push_multiplier", "subject_lock_strength")


@pytest.mark.parametrize("case", ["defaults", "moved"])
def test_pop_controls_locked_to_defaults_matches_jax(case):
    from visiondepth3d_tpu.stereo.params import StereoParams as JParams
    from visiondepth3d_tpu.stereo.params import pop_controls_locked_to_defaults as jlock
    from visiondepth3d_tpu_torch.stereo import StereoParams as TParams
    from visiondepth3d_tpu_torch.stereo import pop_controls_locked_to_defaults as tlock

    kw = {} if case == "defaults" else dict(
        zip(POP_FIELDS, (1.4, 0.3, 0.1, 0.8, 2.0, 0.5, 0.2)), fg_shift=5.0, bg_shift=-2.0)
    got, want = tlock(TParams(**kw)), jlock(JParams(**kw))
    for f in dataclasses.fields(TParams):
        if hasattr(want, f.name):
            assert getattr(got, f.name) == getattr(want, f.name), f.name
    assert [getattr(got, f) for f in POP_FIELDS] == [0.85, 0.50, 0.05, 0.95, 1.20, 1.10, 1.00]


@pytest.mark.parametrize("feather", [True, False])
def test_pixel_shift_matches_jax(feather):
    from visiondepth3d_tpu.state import init_trackers as jinit
    from visiondepth3d_tpu.stereo import StereoParams as JParams
    from visiondepth3d_tpu.stereo import pixel_shift as jshift
    from visiondepth3d_tpu_torch.state import init_trackers as tinit
    from visiondepth3d_tpu_torch.stereo import StereoParams as TParams
    from visiondepth3d_tpu_torch.stereo import pixel_shift as tshift

    h, w = 24, 48
    frame = np.random.default_rng(11).random((h, w, 3), dtype=np.float32)
    depth = _depth_ramp(h, w)
    kw = dict(enable_feathering=feather)
    jout = jshift(JParams(**kw).with_shift_bound(w), jinit(h, w), jnp.asarray(frame),
                  jnp.asarray(depth))
    tout = tshift(TParams(**kw).with_shift_bound(w), tinit(h, w, device="cpu"), _t(frame),
                  _t(depth))
    assert len(tout) == len(jout) == 5
    _, left, right, shift_map, subject = tout
    _close(shift_map, jout[3], 1e-5)
    _close(subject, jout[4], 1e-5)
    _close(left, jout[1], 1e-4)
    _close(right, jout[2], 1e-4)


# ------------------------------------------------------------------ frame tools

def _jax_params(model, seed, *inputs, jitter):
    params = model.init(jax.random.PRNGKey(seed), *map(jnp.asarray, inputs))["params"]
    rng = np.random.default_rng(seed)
    params = jax.tree.map(
        lambda v: v + jitter * jnp.asarray(rng.standard_normal(v.shape), v.dtype), params)
    return jax.tree.map(np.asarray, params)


@pytest.mark.parametrize("res_prelu", [False, True])
def test_rife_apply_matches_jax(res_prelu):
    rng = np.random.default_rng(12)
    a, b = (rng.random((16, 24, 3), dtype=np.float32) for _ in range(2))
    cfg = jrife.IFNetConfig(cs=(32, 16), scales=(2, 1), n_res=2, res_prelu=res_prelu)
    params = _jax_params(cfg.build(), 1, a[None], b[None], jitter=0.1)
    want = np.asarray(jrife.rife_apply((params, cfg), a, b, 0.25))
    tcfg = trife.IFNetConfig(**dataclasses.asdict(cfg))
    state = ifnet_from_jax_params(params, tcfg)
    got = trife.rife_apply((state, tcfg), _t(a), _t(b), 0.25)
    assert got.shape == (16, 24, 3) and got.device == torch.device("cpu")
    _close(got, want, 1e-5)
    model = tcfg.build()
    model.load_state_dict(state)
    _close(trife.rife_apply(model, _t(a), _t(b), 0.25), want, 1e-5)


@pytest.mark.parametrize("scale", [4, 2])
def test_esrgan_apply_matches_jax(scale):
    x = np.random.default_rng(13).random((8, 12, 3), dtype=np.float32)
    cfg = jesr.ESRGANConfig(nf=16, nb=1, gc=8, scale=scale)
    params = _jax_params(cfg.build(), 3, x[None], jitter=0.02)
    want = np.asarray(jesr.esrgan_apply(params, x, cfg=cfg))
    tcfg = tesr.ESRGANConfig(**dataclasses.asdict(cfg))
    got = tesr.esrgan_apply(rrdbnet_from_jax_params(params), _t(x), cfg=tcfg)
    assert got.shape == (8 * scale, 12 * scale, 3)
    _close(got, want, 1e-5)


def test_tiny_pipelines_importable_where_jax_defines_them():
    from visiondepth3d_tpu_torch.depth.diffusion import loaders
    from visiondepth3d_tpu_torch.depth.diffusion.depthcrafter import tiny_depthcrafter
    from visiondepth3d_tpu_torch.depth.diffusion.marigold import tiny_marigold

    assert tiny_marigold is loaders.tiny_marigold
    assert tiny_depthcrafter is loaders.tiny_depthcrafter
