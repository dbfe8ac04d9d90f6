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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sigma,levels,grade", [(2.0, 5, True), (5.0, 5, True),
                                                (1.5, 3, False)])
def test_cuda_dof_grade_matches_plain(dtype, sigma, levels, grade):
    """Ragged tiles (45 x 70 is no multiple of the 16 x 32 tile) and the
    largest reach (10) the kernel takes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    dev = torch.device("cuda")
    h, w = 45, 70
    left = torch.from_numpy(_rgb(h, w, 3)).to(dev, dtype)
    right = torch.from_numpy(_rgb(h, w, 4)).to(dev, dtype)
    depth = torch.from_numpy(_depth(h, w)).to(dev)
    focal = torch.tensor(0.4, device=dev)
    kw = dict(saturation=1.2, contrast=0.9, brightness=0.02, apply_grade=grade)
    got = kdof.dof_grade(left, right, depth, focal, sigma, 0.35, levels, **kw)
    ref = kdof.dof_grade_torch(left, right, depth, focal, sigma, 0.35, levels, **kw)
    err = torch.cat([(g.float() - r.float()).abs().reshape(-1) for g, r in zip(got, ref)])
    if dtype == torch.float32:
        assert err.max().item() <= 1e-5
    else:
        assert err.max().item() <= 1.6e-2 and err.mean().item() <= 2e-3
