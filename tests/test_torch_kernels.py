"""The kernels' plain versions against the JAX Pallas kernels and their XLA
twins; the CUDA kernels against their plain versions on a card.

The Pallas kernels run as the JAX package's own tests run them on the CPU,
in TPU interpret mode. Tolerances:
- K3 (quantile pair) and K4 (subject statistics): bit-identical; both
  sides take the bisection's decisions on exact float32 counts.
- K1 (warp) float32: 1e-5. bfloat16: 1e-2, two bf16 steps near 1: the
  Pallas kernel accumulates its taps in bf16, the plain version in float32
  with one rounding at the end.
- K2 (feather + heal) float32: 1e-5 wherever the heal mask cannot flip,
  i.e. away (3 px, the 5x5 + 3x3 reach) from pixels whose gray gradient
  lies within 2e-5 of the 0.05 threshold. bfloat16: mean 4e-3 (the Pallas
  kernel and the XLA chain round every step to bf16).
- K5 (3x3 conv) float32: 2e-6 against flax ``nn.Conv`` and the Pallas
  kernel in its ``cat9`` form, the plain version's arithmetic (one K = 9C
  product; summation order only). bfloat16 against the float32 reference:
  0.15, the JAX package's own bound for bf16 operands.

The CUDA cases carry the ``cuda`` marker and skip without a card.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn
from jax.experimental.pallas import tpu as pltpu

from visiondepth3d_tpu.ops import edges as jedges
from visiondepth3d_tpu.ops import quantiles as jq
from visiondepth3d_tpu.ops import warp as jwarp
from visiondepth3d_tpu.ops.pallas_postfx import feather_heal_pallas
from visiondepth3d_tpu.ops.pallas_stats import quantile_pair_pallas, subject_stats_pallas
from visiondepth3d_tpu.ops.pallas_conv import conv3x3_pallas
from visiondepth3d_tpu.ops.pallas_warp import stereo_warp_pallas
from visiondepth3d_tpu_torch.kernels import conv, postfx, stats, warp


def _depth(h, w, seed=0, edges=True):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    d = 0.5 + 0.3 * np.sin(xx / 7.0 + seed) * np.cos(yy / 5.0) + 0.2 * (xx / w - 0.5)
    if edges:
        d = d + 0.25 * ((xx > w // 3) & (xx < w // 2) & (yy > h // 4)).astype(np.float32)
    return np.clip(d + 0.02 * rng.random((h, w)), 0, 1).astype(np.float32)


def _frame(h, w, seed=1):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    f = 0.5 + 0.4 * np.sin(xx[..., None] / (5.0 + np.arange(3)) + yy[..., None] / 9.0)
    return np.clip(f + 0.05 * rng.random((h, w, 3)), 0, 1).astype(np.float32)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else jnp.asarray(x, jnp.float32))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


# ---------------------------------------------------------------- K1 warp

WARP_CASES = {
    # name: (h, w, shift amplitude, bound, constant depth)
    "w160": (32, 160, 0.05, 6, False),
    "w60_not_128": (16, 60, 0.08, 5, False),
    "clamp_at_border": (16, 128, 0.12, 9, False),
    "constant_depth": (16, 128, 0.05, 6, True),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(WARP_CASES))
def test_warp_plain_matches_pallas(name, dtype):
    h, w, amp, bound, const = WARP_CASES[name]
    frame = _frame(h, w)
    depth = np.full((h, w), 0.4, np.float32) if const else _depth(h, w)
    shift = (amp * np.sin(np.arange(w) / 9.0)[None, :] * np.ones((h, 1))).astype(np.float32)
    shift[:, :4] = amp  # sample past the left border
    shift[:, -4:] = -amp  # and the right one, for the opposite eye
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    with pltpu.force_tpu_interpret_mode():
        want = stereo_warp_pallas(jnp.asarray(frame, jdt), jnp.asarray(depth, jdt),
                                  jnp.asarray(shift), bound, block_rows=16)
    got = warp.stereo_warp_torch(_t(frame, tdt), _t(depth, tdt), _t(shift), bound)
    tol = 1e-5 if dtype == "float32" else 1e-2
    for g, wv in zip(got, want):
        assert g.dtype == tdt
        np.testing.assert_allclose(_np(g), _np(wv), atol=tol, rtol=0)


@pytest.mark.parametrize("bound", [None, 6])
def test_warp_plain_matches_xla_h_not_multiple_of_8(bound):
    h, w = 21, 50
    frame, depth = _frame(h, w), _depth(h, w)
    shift = (0.1 * (np.random.default_rng(3).random((h, w)) - 0.5)).astype(np.float32)
    want = jwarp.stereo_warp(jnp.asarray(frame), jnp.asarray(depth), jnp.asarray(shift), bound)
    got = warp.stereo_warp_torch(_t(frame), _t(depth), _t(shift), bound)
    for g, wv in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(wv), atol=1e-5, rtol=0)


def test_warp_dispatch_cpu_uses_plain():
    frame, depth = _frame(8, 32), _depth(8, 32)
    shift = np.zeros((8, 32), np.float32)
    left, right, dl, dr = warp.stereo_warp(_t(frame), _t(depth), _t(shift), 3)
    np.testing.assert_allclose(left.numpy(), frame, atol=1e-7)
    with pytest.raises(ValueError):
        warp.stereo_warp_cuda(_t(frame), _t(depth), _t(shift), 3)


# ---------------------------------------------------------------- K2 post-fx

def _near_threshold(feathered: np.ndarray, reach: int = 3) -> np.ndarray:
    """Pixels whose heal mask may flip under float32 rounding, dilated by
    the mask's reach into the output."""
    g = feathered.mean(axis=-1)
    dx = np.pad(g[:, 1:] - g[:, :-1], [(0, 0), (1, 0)])
    dy = np.pad(g[1:] - g[:-1], [(1, 0), (0, 0)])
    near = np.abs(np.sqrt(dx * dx + dy * dy) - 0.05) < 2e-5
    out = near.copy()
    for oy in range(-reach, reach + 1):
        for ox in range(-reach, reach + 1):
            out |= np.roll(np.roll(near, oy, 0), ox, 1)
    return out


POSTFX_CASES = {
    # name: (h, w, blur_ksize, feather, heal)
    "k9_both": (48, 160, 9, True, True),
    "k15_w_not_128": (40, 96, 15, True, True),
    "k5_feather_only": (32, 128, 5, True, False),
    "k7_heal_only": (32, 128, 7, False, True),
}


@pytest.mark.parametrize("name", sorted(POSTFX_CASES))
def test_postfx_plain_matches_pallas_f32(name):
    h, w, k, feather, heal = POSTFX_CASES[name]
    rng = np.random.default_rng(5)
    frame = _frame(h, w)
    left = np.clip(frame + 0.1 * rng.standard_normal(frame.shape), 0, 1).astype(np.float32)
    right = np.clip(frame - 0.1 * rng.standard_normal(frame.shape), 0, 1).astype(np.float32)
    dl, dr = _depth(h, w), np.roll(_depth(h, w), 3, axis=1)
    kw = dict(blur_ksize=k, feather_strength=10.0, heal_strength=0.5,
              enable_feathering=feather, enable_healing=heal)
    with pltpu.force_tpu_interpret_mode():
        want = feather_heal_pallas(*(jnp.asarray(a) for a in (left, right, frame, dl, dr)),
                                   block_rows=8, **kw)
    got = postfx.feather_heal_torch(*(_t(a) for a in (left, right, frame, dl, dr)), **kw)
    for eye, d, g, wv in ((left, dl, got[0], want[0]), (right, dr, got[1], want[1])):
        feathered = (np.asarray(jedges.feather_shift_edges(
            jnp.asarray(eye), jnp.asarray(frame), jnp.asarray(d), k, 10.0))
            if feather else eye)
        ok = ~_near_threshold(feathered) if heal else np.ones((h, w), bool)
        err = np.abs(_np(g) - _np(wv)).max(axis=-1)
        assert ok.mean() > 0.8
        assert err[ok].max() <= 1e-5, err[ok].max()


def test_postfx_plain_matches_xla_chain_bf16():
    h, w = 48, 96
    frame = _frame(h, w)
    rng = np.random.default_rng(6)
    left = np.clip(frame + 0.1 * rng.standard_normal(frame.shape), 0, 1).astype(np.float32)
    dl = _depth(h, w)
    b = jnp.bfloat16
    want = jedges.feather_shift_edges(jnp.asarray(left, b), jnp.asarray(frame, b),
                                      jnp.asarray(dl, b), 9, 10.0)
    want = jedges.heal_missing_pixels(want, jnp.asarray(frame, b), None, 0.5)
    got, _ = postfx.feather_heal_torch(
        *(_t(a, torch.bfloat16) for a in (left, left, frame, dl, dl)), blur_ksize=9)
    assert got.dtype == torch.bfloat16
    assert np.abs(_np(got) - _np(want)).mean() <= 4e-3


# ------------------------------------------------------- K3 quantile pair

QPAIR_CASES = {
    "random": lambda: np.random.default_rng(0).random((64, 256)).astype(np.float32),
    "depth_w_not_128": lambda: _depth(40, 100),
    "h_not_multiple_of_8": lambda: _depth(21, 64, seed=2),
    "constant": lambda: np.full((32, 128), 0.37, np.float32),
    "outside_01": lambda: (np.random.default_rng(1).random((16, 128)) * 1.4 - 0.2
                           ).astype(np.float32),
}


@pytest.mark.parametrize("qs", [(0.02, 0.98), (0.05, 0.95)])
@pytest.mark.parametrize("name", sorted(QPAIR_CASES))
def test_quantile_pair_bit_identical(name, qs):
    x = QPAIR_CASES[name]()
    q = jnp.asarray(qs, jnp.float32)
    xla = np.asarray(jq.bisect_quantile_01(jnp.asarray(x), q))
    got = stats.quantile_pair(_t(x), *qs).numpy()
    np.testing.assert_array_equal(got, xla)
    if x.shape[0] % 8 == 0:
        with pltpu.force_tpu_interpret_mode():
            pallas = np.asarray(quantile_pair_pallas(jnp.asarray(x), q))
        np.testing.assert_array_equal(got, pallas)


# ------------------------------------------------------- K4 subject stats

SUBJECT_CASES = {
    "random": lambda: np.random.default_rng(2).random((64, 128)).astype(np.float32),
    "depth": lambda: _depth(48, 80),
    "constant_valid": lambda: np.full((24, 64), 0.37, np.float32),
    "none_valid": lambda: np.full((24, 64), 0.97, np.float32),
}


@pytest.mark.parametrize("name", sorted(SUBJECT_CASES))
def test_subject_stats_bit_identical(name):
    m = SUBJECT_CASES[name]()
    h, w = m.shape
    crop = m[h // 5: h * 4 // 5, w // 5: w * 4 // 5]
    tcrop = _t(m)[h // 5: h * 4 // 5, w // 5: w * 4 // 5]  # a strided view
    hist, count, median = stats.subject_stats(tcrop)
    valid = (crop > 0.05) & (crop < 0.95)
    np.testing.assert_array_equal(hist.numpy(), np.asarray(
        jq.histogram_01(jnp.asarray(crop), 64, jnp.asarray(valid))))
    assert float(count) == float(valid.sum())
    assert median.numpy() == np.asarray(
        jq.hist_masked_median(jnp.asarray(crop), jnp.asarray(valid)))
    if crop.shape[0] % 8 == 0:
        with pltpu.force_tpu_interpret_mode():
            ph, pc, pm = subject_stats_pallas(jnp.asarray(np.ascontiguousarray(crop)), 64)
        np.testing.assert_array_equal(hist.numpy(), np.asarray(ph))
        assert float(count) == float(pc) and median.numpy() == np.asarray(pm)


# ---------------------------------------------------------------- K5 conv

def _conv_inputs(c, o, seed, shape=(2, 16, 24)):
    rng = np.random.default_rng(seed)
    x = rng.random((*shape, c), dtype=np.float32)  # image-like, in [0, 1)
    k = (rng.standard_normal((3, 3, c, o)) / np.sqrt(9 * c)).astype(np.float32)
    b = (0.1 * rng.standard_normal(o)).astype(np.float32)
    return x, k, b


def _flax_conv(x, k, b, act=None):
    use_bias = b is not None
    params = {"kernel": jnp.asarray(k), **({"bias": jnp.asarray(b)} if use_bias else {})}
    y = fnn.Conv(k.shape[-1], (3, 3), padding=((1, 1), (1, 1)), use_bias=use_bias).apply(
        {"params": params}, jnp.asarray(x))
    if act == "relu":
        y = jnp.maximum(y, 0)
    elif act == "lrelu":
        y = jnp.where(y >= 0, y, 0.2 * y)
    return np.asarray(y)


@pytest.mark.parametrize("c,o,act,bias", [(16, 24, None, True), (24, 16, None, True),
                                          (3, 8, None, True), (8, 3, None, True),
                                          (16, 24, "relu", True), (24, 16, "lrelu", True),
                                          (8, 8, "lrelu", False)])
def test_conv_plain_matches_flax_and_pallas(c, o, act, bias):
    x, k, b = _conv_inputs(c, o, seed=c * 100 + o)
    b = b if bias else None
    want = _flax_conv(x, k, b, act)
    with pltpu.force_tpu_interpret_mode():
        pallas = np.asarray(conv3x3_pallas(jnp.asarray(x), jnp.asarray(k),
                                           None if b is None else jnp.asarray(b),
                                           act=act, block_rows=8, variant="cat9"))
    got = conv.conv3x3(_t(x), _t(k), None if b is None else _t(b), act)
    assert got.dtype == torch.float32 and got.shape == (2, 16, 24, o)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-6, rtol=0)
    np.testing.assert_allclose(got.numpy(), pallas, atol=2e-6, rtol=0)


def test_conv_plain_bf16():
    """bf16 operands, f32 accumulation and one rounding: within JAX's own
    bf16 bound of the f32 reference, and within a bf16 step of the Pallas
    kernel (same operands, same accumulation type)."""
    x, k, b = _conv_inputs(16, 16, seed=2, shape=(1, 8, 16))
    want = _flax_conv(x, k, b)
    with pltpu.force_tpu_interpret_mode():
        pallas = np.asarray(conv3x3_pallas(jnp.asarray(x, jnp.bfloat16),
                                           jnp.asarray(k, jnp.bfloat16),
                                           jnp.asarray(b, jnp.bfloat16), block_rows=4,
                                           variant="cat9"),
                            np.float32)
    got = conv.conv3x3(_t(x, torch.bfloat16), _t(k), _t(b))
    assert got.dtype == torch.bfloat16
    assert np.abs(_np(got) - want).max() < 0.15
    assert np.abs(_np(got) - pallas).max() <= 2 ** -7 * np.abs(pallas).max()


def test_conv_dispatch_cpu_uses_plain():
    x, k, b = _conv_inputs(8, 4, seed=3)
    np.testing.assert_array_equal(conv.conv3x3(_t(x), _t(k), _t(b)).numpy(),
                                  conv.conv3x3_torch(_t(x), _t(k), _t(b)).numpy())
    with pytest.raises(ValueError):
        conv.conv3x3_cuda(_t(x), _t(k), _t(b))
    with pytest.raises(ValueError):
        conv.conv3x3(_t(x), _t(k), _t(b), act="gelu")


# ------------------------------------------------------- CUDA: kernel vs plain

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_warp_matches_plain(cuda, dtype):
    h, w = 72, 200
    frame, depth = _t(_frame(h, w), dtype).to(cuda), _t(_depth(h, w), dtype).to(cuda)
    shift = (0.08 * (torch.rand(h, w, generator=torch.Generator().manual_seed(0)) - 0.5)).to(cuda)
    got = warp.stereo_warp(frame, depth, shift, 6)
    ref = warp.stereo_warp_torch(frame, depth, shift, 6)
    tol = 1e-5 if dtype == torch.float32 else 8e-3
    for g, r in zip(got, ref):
        assert (g.float() - r.float()).abs().max().item() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_postfx_matches_plain(cuda, dtype):
    h, w = 72, 200
    frame = _t(_frame(h, w), dtype).to(cuda)
    left = (frame.float() + 0.05).clamp(0, 1).to(dtype)
    d = _t(_depth(h, w), dtype).to(cuda)
    got = postfx.feather_heal(left, left, frame, d, d, blur_ksize=9)
    ref = postfx.feather_heal_torch(left, left, frame, d, d, blur_ksize=9)
    diff = torch.cat([(g.float() - r.float()).abs().reshape(-1) for g, r in zip(got, ref)])
    if dtype == torch.float32:
        assert (diff <= 1e-4).float().mean().item() >= 0.9999
    else:
        assert diff.mean().item() <= 2e-3


@pytest.mark.cuda
def test_cuda_stats_match_plain(cuda):
    m = _t(_depth(108, 192)).to(cuda)
    assert torch.equal(stats.quantile_pair(m, 0.02, 0.98),
                       stats.quantile_pair_torch(m, 0.02, 0.98))
    crop = m[21:86, 38:153]
    for a, b in zip(stats.subject_stats(crop), stats.subject_stats_torch(crop)):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,o,act", [(3, 64, None), (64, 32, "lrelu"), (192, 64, None),
                                     (64, 3, None), (12, 16, "relu")])
def test_cuda_conv_matches_plain(cuda, dtype, c, o, act):
    """Ragged tiles (13 x 37 is no multiple of the 8 x 32 tile), channel
    counts that are no multiple of 16, and every activation."""
    x, k, b = _conv_inputs(c, o, seed=c + o, shape=(2, 13, 37))
    x, k, b = _t(x, dtype).to(cuda), _t(k).to(cuda), _t(b).to(cuda)
    got = conv.conv3x3(x, k, b, act)
    ref = conv.conv3x3_torch(x, k, b, act)
    scale = ref.float().abs().max().item()
    err = (got.float() - ref.float()).abs()
    if dtype == torch.float32:
        assert err.max().item() <= 1e-4 * scale
    else:
        assert err.max().item() <= 8e-3 * scale and err.mean().item() <= 1e-3 * scale
