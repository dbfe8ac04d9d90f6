"""The port's depth of field (``ops/filters.gaussian_blur``, ``ops/dof``, K6's
plain version) against the JAX package; K6 against its plain version on a
card.

Tolerances:
- ``gaussian_blur`` / ``apply_dof`` float32: 1e-6 (the same taps summed in
  the same order; only the last bits of the float32 lerp differ).
  bfloat16 against the JAX bf16 ops: max 1.6e-2 (four bf16 steps near 1)
  and mean 2e-3. The JAX ops round every tap and every level to bf16, the
  port sums in float32 and rounds once.
- ``dof_grade_torch`` against ``dof_grade_pallas`` (TPU interpret mode)
  float32: 3e-6, the JAX package's own bound for its kernel, at the two
  cases of ``tests/test_pallas_dof.py``.
- K6 blurs, per tile, only the levels [lmin, lmax + 1] of the tile's lower
  level indices: every level that carries a nonzero weight at a pixel lies
  in its tile's range, and the lerp that skips the other levels equals
  ``apply_dof`` bit for bit (the skipped terms are exact zeros).
- On the card, K6 against ``dof_grade_torch``: float32 1e-5 (fused
  multiply-adds and summation order), bfloat16 max 1.6e-2 and mean 2e-3
  (both round once; a value near a rounding boundary moves one bf16 step).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
torch.set_num_threads(1)
from jax.experimental.pallas import tpu as pltpu

from visiondepth3d_tpu.ops import dof as jdof
from visiondepth3d_tpu.ops import filters as jfilters
from visiondepth3d_tpu.ops.pallas_dof import dof_grade_pallas, dof_reach as jdof_reach
from visiondepth3d_tpu_torch.kernels import dof as kdof
from visiondepth3d_tpu_torch.ops import dof, filters


def _rgb(h, w, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    f = 0.5 + 0.4 * np.sin(xx[..., None] / (4.0 + np.arange(3)) + yy[..., None] / 7.0)
    return np.clip(f + 0.1 * rng.random((h, w, 3)), 0, 1).astype(np.float32)


def _depth(h, w, seed=1):
    return np.random.default_rng(seed).random((h, w)).astype(np.float32)


def _check(got, want, dtype):
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape
    err = np.abs(got - want)
    if dtype == "float32":
        assert err.max() <= 1e-6, err.max()
    else:
        assert err.max() <= 1.6e-2 and err.mean() <= 2e-3, (err.max(), err.mean())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,ksize,sigma", [((24, 40, 3), 9, 2.0), ((13, 17), 5, 1.0),
                                               ((6, 30, 3), 21, 5.0)])
def test_gaussian_blur_matches_jax(shape, ksize, sigma, dtype):
    """Odd sizes, a 2-D plane, and a reach (10) wider than the 6 rows: the
    reflection repeats as jnp.pad's does."""
    x = np.random.default_rng(2).random(shape).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = jax.jit(jfilters.gaussian_blur, static_argnums=(1, 2))(jnp.asarray(x, jdt), ksize,
                                                                  sigma)
    got = filters.gaussian_blur(torch.from_numpy(x).to(tdt), ksize, sigma)
    assert got.dtype == tdt
    _check(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sigma,levels,focal", [(2.0, 5, 0.45), (1.5, 3, 0.2), (5.0, 5, 0.7)])
def test_apply_dof_matches_jax(sigma, levels, focal, dtype):
    h, w = 32, 48
    rgb, depth = _rgb(h, w), _depth(h, w)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = jax.jit(jdof.apply_dof, static_argnums=(3, 4, 5))(
        jnp.asarray(rgb, jdt), jnp.asarray(depth), jnp.asarray(focal), sigma, 0.35, levels)
    got = dof.apply_dof(torch.from_numpy(rgb).to(tdt), torch.from_numpy(depth),
                        torch.tensor(focal), sigma, 0.35, levels)
    assert got.dtype == tdt
    _check(got, want, dtype)


# the two cases of tests/test_pallas_dof.py
PALLAS_CASES = {
    "graded": dict(h=32, w=48, sigma=2.0, n=5, focal=0.45, seed=0,
                   grade=dict(saturation=1.3, contrast=1.1, brightness=0.05, apply_grade=True)),
    "ungraded": dict(h=16, w=40, sigma=1.5, n=3, focal=0.5, seed=1,
                     grade=dict(apply_grade=False)),
}


@pytest.mark.parametrize("name", sorted(PALLAS_CASES))
def test_dof_grade_plain_matches_pallas(name):
    c = PALLAS_CASES[name]
    rng = np.random.default_rng(c["seed"])
    left = rng.random((c["h"], c["w"], 3)).astype(np.float32)
    right = rng.random((c["h"], c["w"], 3)).astype(np.float32)
    depth = rng.random((c["h"], c["w"])).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = dof_grade_pallas(jnp.asarray(left), jnp.asarray(right), jnp.asarray(depth),
                                jnp.asarray(c["focal"]), max_sigma=c["sigma"],
                                focus_width=0.35, num_levels=c["n"], block_rows=8, **c["grade"])
    got = kdof.dof_grade_torch(*(torch.from_numpy(a) for a in (left, right, depth)),
                               torch.tensor(c["focal"]), c["sigma"], 0.35, c["n"], **c["grade"])
    for g, wv in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(wv), atol=3e-6, rtol=0)


FW_EPS = np.float32(0.35 + 1e-6)  # focus_width + 1e-6 as the float32 the ops divide by


def _level_range_depth(name, h, w):
    """(depth, focal) of a level-range case."""
    rng = np.random.default_rng(7)
    if name.startswith("focal_"):
        return _depth(h, w), {"focal_045": 0.45, "focal_0": 0.0, "focal_1": 1.0}[name]
    if name == "diff_at_and_above_width":  # |d - focal| = focus_width, and beyond
        d = 0.3 + rng.choice(np.array([-1.0, 1.0, -1.5, 1.5, 0.0], np.float32) * FW_EPS,
                             size=(h, w))
        return np.clip(d, 0, 1).astype(np.float32), 0.3
    # |d - 0| / fw_eps = 1/4 and 1/2: the blur index is 1.0 or 2.0 exactly
    return rng.choice(np.array([0.25, 0.5], np.float32) * FW_EPS, size=(h, w)), 0.0


@pytest.mark.parametrize("tile", [(16, 32), (32, 64)])
@pytest.mark.parametrize("name", ["focal_045", "focal_0", "focal_1", "diff_at_and_above_width",
                                  "idx_on_integer"])
def test_dof_tile_level_range_covers_weighted_levels(name, tile):
    h, w, n, sigma = 70, 150, 5, 2.0
    depth, focal = _level_range_depth(name, h, w)
    td, tf = torch.from_numpy(depth), torch.tensor(focal)
    # the blur index of ops/dof.apply_dof
    weights = torch.clamp(torch.abs(td - tf) / (0.35 + 1e-6), 0.0, 1.0)
    idx = torch.clamp(weights * (n - 1), 0.0, n - 1 - 1e-6)
    lower = torch.clamp(torch.floor(idx), 0, n - 2)
    alpha = idx - lower
    if name == "idx_on_integer":
        assert set(idx.unique().tolist()) == {1.0, 2.0} and bool((alpha == 0).all())
    # each tile's range [lmin, lmax + 1], spread back over its pixels
    th, tw = tile
    ph, pw = -h % th, -w % tw
    lo = torch.nn.functional.pad(lower, (0, pw, 0, ph), value=float("inf"))
    hi = torch.nn.functional.pad(lower, (0, pw, 0, ph), value=float("-inf"))
    lmin = -torch.nn.functional.max_pool2d(-lo[None], tile)[0]
    lmax = torch.nn.functional.max_pool2d(hi[None], tile)[0]
    lmin = lmin.repeat_interleave(th, 0).repeat_interleave(tw, 1)[:h, :w]
    lmax = lmax.repeat_interleave(th, 0).repeat_interleave(tw, 1)[:h, :w]
    rgb = torch.from_numpy(_rgb(h, w))
    out = torch.zeros_like(rgb)
    for i, sg in enumerate(dof.level_sigmas(sigma, n)):
        wgt = (lower == i).float() * (1.0 - alpha) + (lower == i - 1).float() * alpha
        in_range = (lmin <= i) & (i <= lmax + 1)
        assert bool(in_range[wgt != 0].all()), f"level {i} weighted outside its tile's range"
        img = rgb if sg == 0.0 else filters.gaussian_blur(rgb, dof.level_ksize(sg), sg)
        out = torch.where(in_range[..., None], out + img * wgt[..., None], out)
    want = dof.apply_dof(rgb, td, tf, sigma, 0.35, n)
    assert torch.equal(torch.clamp(out, 0.0, 1.0), want)


def test_dof_reach_and_dispatch():
    """The reach matches the JAX package's; the CPU dispatch runs the plain
    version; the kernel refuses a reach past its halo and CPU tensors."""
    for sigma, n in ((2.0, 5), (2.0, 3), (3.5, 5), (5.0, 5), (0.4, 4)):
        assert kdof.dof_reach(sigma, n) == jdof_reach(sigma, n)
    assert kdof.dof_reach(5.0, 5) == kdof.MAX_REACH
    h, w = 12, 20
    left, depth = torch.from_numpy(_rgb(h, w)), torch.from_numpy(_depth(h, w))
    got = kdof.dof_grade(left, left, depth, torch.tensor(0.3), 2.0)
    ref = kdof.dof_grade_torch(left, left, depth, torch.tensor(0.3), 2.0)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, atol=0, rtol=0)
    with pytest.raises(ValueError, match="reach"):
        kdof.dof_grade_cuda(left, left, depth, 0.3, 5.5)
    with pytest.raises(ValueError, match="CUDA"):
        kdof.dof_grade_cuda(left, left, depth, 0.3, 2.0)


# (h, w, focal): ragged tiles (45 x 70 is no multiple of the 32 x 64 tile),
# 136 x 264 with interior tiles (the TMA-fed path), smaller than one tile,
# smaller than 2 x the largest reach, a width whose row pitch TMA cannot
# take (37 x 3 values), every pixel in focus and every pixel out of focus
DOF_SHAPES = {"45x70": (45, 70, 0.4), "136x264": (136, 264, 0.4), "20x40": (20, 40, 0.4),
              "7x9": (7, 9, 0.4), "w37": (90, 37, 0.4), "in_focus": (70, 136, None),
              "out_of_focus": (70, 136, 5.0)}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", sorted(DOF_SHAPES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sigma,levels,grade", [(2.0, 5, True), (5.0, 5, True),
                                                (1.5, 3, False)])
def test_cuda_dof_grade_matches_plain(dtype, sigma, levels, grade, shape):
    """The shapes of DOF_SHAPES at the largest reach (10) the kernel takes
    and two others."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    dev = torch.device("cuda")
    h, w, f = DOF_SHAPES[shape]
    left = torch.from_numpy(_rgb(h, w, 3)).to(dev, dtype)
    right = torch.from_numpy(_rgb(h, w, 4)).to(dev, dtype)
    depth = torch.from_numpy(_depth(h, w)).to(dev)
    if f is None:  # in focus: the focal plane at each pixel's own depth
        depth = torch.full((h, w), 0.4, device=dev)
    focal = torch.tensor(0.4 if f is None else f, device=dev)
    kw = dict(saturation=1.2, contrast=0.9, brightness=0.02, apply_grade=grade)
    got = kdof.dof_grade(left, right, depth, focal, sigma, focus_width=0.35, num_levels=levels,
                         **kw)
    ref = kdof.dof_grade_torch(left, right, depth, focal, sigma, 0.35, levels, **kw)
    err = torch.cat([(g.float() - r.float()).abs().reshape(-1) for g, r in zip(got, ref)])
    if dtype == torch.float32:
        assert err.max().item() <= 1e-5
    else:
        assert err.max().item() <= 1.6e-2 and err.mean().item() <= 2e-3
