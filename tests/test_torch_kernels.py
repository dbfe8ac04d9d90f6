"""The kernels' plain versions against the JAX Pallas kernels and their XLA
twins; the CUDA kernels against their plain versions on a card.

The Pallas kernels run as the JAX package's own tests run them on the CPU,
in TPU interpret mode. Tolerances:
- K3 (quantile pair) and K4 (subject statistics): bit-identical; both
  sides take the bisection's decisions on exact float32 counts. K4's
  cluster schedule (per-CTA counts, the slice merge, the 64-bin histogram
  from the 4096 right-closed bins and the edge counts, the replay as a
  count of the k where the bisection's predicate holds) is emulated in
  numpy and held bit-identical too, as is K3's grid schedule (each CTA
  zeroing its share of the scratch, one band of rows per CTA, the global
  flush, the last CTA's replay).
- K1 (warp) float32: 1e-5. bfloat16: 1e-2, two bf16 steps near 1: the
  Pallas kernel accumulates its taps in bf16, the plain version in float32
  with one rounding at the end.
- K2 (feather + heal) float32: 1e-5 wherever the heal mask cannot flip,
  i.e. away (3 px, the 5x5 + 3x3 reach) from pixels whose gray gradient
  lies within 2e-5 of the 0.05 threshold. bfloat16: mean 4e-3 (the Pallas
  kernel and the XLA chain round every step to bf16). The CUDA kernel's
  strips (each image type's width), row segments and warm-up skips are
  emulated in numpy from each CTA's own input windows and held to the same
  f32 tolerance.
- K5 (3x3 conv) float32: 2e-6 against flax ``nn.Conv`` and the Pallas
  kernel in its ``cat9`` form, the plain version's arithmetic (one K = 9C
  product; summation order only). bfloat16 against the float32 reference:
  0.15, the JAX package's own bound for bf16 operands.
- Split TF32 (K5's and K7's float32 bodies on the tensor cores): the halves
  are TF32 values within 2^-22 of x; the three-product arithmetic,
  emulated in numpy at toy shapes, within K7's float32 gate (1e-5) and
  K5's (1e-4 x max |ref|) of the float64 result.

The CUDA cases carry the ``cuda`` marker and skip without a card.
"""

from __future__ import annotations

import functools
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
torch.set_num_threads(1)
from flax import linen as fnn
from jax.experimental.pallas import tpu as pltpu

from visiondepth3d_tpu.ops import edges as jedges
from visiondepth3d_tpu.ops import quantiles as jq
from visiondepth3d_tpu.ops import warp as jwarp
from visiondepth3d_tpu.ops.pallas_postfx import feather_heal_pallas
from visiondepth3d_tpu.ops.pallas_stats import quantile_pair_pallas, subject_stats_pallas
from visiondepth3d_tpu.ops.pallas_conv import conv3x3_pallas
from visiondepth3d_tpu.ops.pallas_warp import stereo_warp_pallas
from visiondepth3d_tpu_torch.kernels import conv, postfx, stats, tf32, warp


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


def test_grid_sample_yardstick_computes_the_warp():
    """K1's library yardstick in ``chip_smoke.py`` (one F.grid_sample over
    both eyes, frame and depth stacked) computes the plain warp of
    ``ops/warp.py`` in float32: within 1e-4 at 270x480 on a random frame
    with shifts of +-3 % (seed 0). The gap is the rounding of the normalized
    grid coordinate, about W * 2^-24 px."""
    import importlib.util

    from visiondepth3d_tpu_torch.ops import warp as warp_ops

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    gen = torch.Generator().manual_seed(0)
    h, w = 270, 480
    frame, depth = torch.rand(h, w, 3, generator=gen), torch.rand(h, w, generator=gen)
    shift = (torch.rand(h, w, generator=gen) * 2 - 1) * 0.03
    out = smoke.warp_grid_sample(*smoke.warp_grid_inputs(frame, depth, shift))
    got = (out[0, :3].permute(1, 2, 0), out[1, :3].permute(1, 2, 0), out[0, 3], out[1, 3])
    for g, want in zip(got, warp_ops.stereo_warp(frame, depth, shift)):
        assert (g - want).abs().max().item() <= 1e-4


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


# csrc/postfx.cu's schedule: strips of TW output columns (by image type),
# segments of a multiple of RB rows, RB rows per step
POSTFX_TW = {"bfloat16": 128, "float32": 96}
POSTFX_RB = 4


def _postfx_schedule(left, right, frame, dl, dr, k, tw, fs=10.0, hs=0.5, thr=0.05,
                     feather=True, heal=True, segs=3):
    """numpy emulation of csrc/postfx.cu:feather_heal_kernel with strips of
    `tw` columns and `segs` row segments. Each CTA computes every stage over exactly the rows and
    columns the kernel computes for it, from its staged input windows (zeros
    outside the image, as TMA fills them), in the kernel's float32 order of
    operations, and skips each stage's warm-up steps where the kernel does
    (its need_* conditions). A value the CTA never computes is NaN and
    poisons whatever reads it, so a finite output shows that the reach and
    the skips cover the strip's and the segment's borders.
    -> (left, right) float32 [H, W, 3]."""
    f32 = np.float32
    h, w = dl.shape
    rb = POSTFX_RB
    p, ka = k // 2, k - 1 - k // 2
    warm = -(-(k + 6) // rb)
    row_steps = -(-h // rb)
    seg_steps = -(-row_steps // min(segs, row_steps))
    seg_rows = seg_steps * rb
    fs, hs, thr = f32(fs), f32(hs), f32(thr)
    outs = [np.full((h, w, 3), np.nan, f32) for _ in range(2)]

    def window(img, y0, ny, x0, nx):  # zeros outside the image
        out = np.zeros((ny, nx) + img.shape[2:], f32)
        ys, xs = np.arange(y0, y0 + ny), np.arange(x0, x0 + nx)
        iy, ix = (ys >= 0) & (ys < h), (xs >= 0) & (xs < w)
        out[np.ix_(iy, ix)] = img[np.ix_(ys[iy], xs[ix])]
        return out

    def shifted(a, dy, dx):  # a[y + dy, x + dx], NaN where that is not in a
        out = np.full_like(a, np.nan)
        ny, nx = a.shape[:2]
        out[max(0, -dy):ny - max(0, dy), max(0, -dx):nx - max(0, dx)] = \
            a[max(0, dy):ny - max(0, -dy), max(0, dx):nx - max(0, -dx)]
        return out

    def grad(g, ys, xs, gl, gu):
        dx = np.where(xs[None, :] > 0, g - gl, f32(0))
        dy = np.where(ys[:, None] > 0, g - gu, f32(0))
        return np.sqrt(dx * dx + dy * dy)

    def inside(ys, xs):
        return ((ys >= 0) & (ys < h))[:, None] & ((xs >= 0) & (xs < w))[None, :]

    def skip(a, y0, first):  # NaN in the steps (rows y0 + j rb ..) ending before row `first`
        a = a.copy()
        for j in range(0, a.shape[0], rb):
            if y0 + j + rb <= first:
                a[j:j + rb] = np.nan
        return a

    for seg0 in range(0, h, seg_rows):
        seg1 = min(seg0 + seg_rows, h)
        n = (warm + seg_steps) * rb
        r0 = seg0 - warm * rb  # output rows r0 .., healed r0 + 1 .., F r0 + 3 .., em F + ka ..
        f0, h0 = r0 + 3, r0 + 1
        e0 = f0 + ka
        for x0 in range(0, w, tw):
            cf = np.arange(-4, tw + 4)  # feathered, gray, mask, healed columns
            xf = x0 + cf
            yf, yh, yo = np.arange(f0, f0 + n), np.arange(h0, h0 + n), np.arange(r0, r0 + n)
            fr = window(frame, f0 - 2, n + 2, x0 - 4, tw + 8)  # rows h0 .. = f0 - 2 ..
            for eye, (img, dep) in enumerate(((left, dl), (right, dr))):
                a = window(img, f0, n, x0 - 4, tw + 8)
                o = fr[2:]
                if feather:
                    ce = np.arange(tw + 7 + k)  # em / V columns c = ce - 4 - p
                    xe = x0 + ce - 4 - p
                    ye = np.arange(e0, e0 + n)
                    d = window(dep, e0 - 1, n + 1, x0 - 5 - p, tw + 8 + k)
                    mag = grad(d[1:, 1:], ye, xe, d[1:, :-1], d[:-1, 1:])
                    em = np.where(inside(ye, xe), np.clip(mag * fs, 0, 1), f32(0))
                    em = skip(em, e0, seg0 - 4 - p)
                    # V rows f0 ..: em rows f0 - p + t; em starts at e0 = f0 + ka
                    emf = np.concatenate([np.full((k - 1, em.shape[1]), np.nan, f32), em])
                    v = emf[0:n]
                    for t in range(1, k):
                        v = v + emf[t:t + n]
                    b = v[:, 0:tw + 8]  # blend column c: V columns c - p + t, t < k
                    for t in range(1, k):
                        b = b + v[:, t:t + tw + 8]
                    b = (b / f32(k * k))[..., None]
                    outf = np.clip(a * (f32(1) - b) + o * b, 0, 1)
                else:
                    outf = a
                outf = skip(outf, f0, seg0 - 4)
                if not heal:
                    res = shifted(outf, -3, 0)  # output rows r0 .. = f0 - 3 ..
                else:
                    g = ((outf[..., 0] + outf[..., 2]) + outf[..., 1]) * f32(1 / 3)
                    mag = grad(g, yf, xf, shifted(g, 0, -1), shifted(g, -1, 0))
                    miss = np.where(np.isnan(mag), np.nan, (mag > thr).astype(f32))
                    miss = skip(np.where(inside(yf, xf), miss, f32(0)), f0, seg0 - 3)
                    # healed rows h0 .. = f0 - 2 ..: the mask rows h0 - 2 .. h0 + 2
                    mf = np.concatenate([np.full((4, tw + 8), np.nan, f32), miss])
                    cnt = sum(shifted(mf[dy:dy + n], 0, dx) for dy in range(5)
                              for dx in range(-2, 3))
                    m = skip(np.minimum(cnt / f32(25), f32(1)), h0, seg0 - 1)
                    t = (hs * m)[..., None]
                    outh = shifted(outf, -2, 0)  # feathered rows h0 ..
                    healed = skip(np.where(inside(yh, xf)[..., None],
                                           (f32(1) - t) * outh + t * fr[:n], f32(0)), h0, seg0 - 1)
                    # output rows r0 .. = h0 - 1 ..: healed rows y - 1 .. y + 1
                    hh = np.concatenate([np.full((2, tw + 8, 3), np.nan, f32), healed])
                    vs = (hh[0:n] + hh[1:n + 1]) + hh[2:n + 2]
                    soft = ((shifted(vs, 0, -1) + vs) + shifted(vs, 0, 1)) / f32(9)
                    mo = np.concatenate([np.full((1, tw + 8), np.nan, f32), m])[0:n]
                    t = (f32(0.3) * mo)[..., None]
                    res = np.clip((f32(1) - t) * hh[1:n + 1] + t * soft, 0, 1)
                rows = slice(seg0 - r0, seg1 - r0)
                cols = slice(4, 4 + min(tw, w - x0))
                outs[eye][seg0:seg1, x0:x0 + min(tw, w - x0)] = res[rows, cols]
    return tuple(outs)


@pytest.mark.parametrize("dtype", sorted(POSTFX_TW))
@pytest.mark.parametrize("mode", ["both", "feather_only", "heal_only"])
@pytest.mark.parametrize("k", [1, 9, 15])
def test_postfx_strip_schedule_matches_plain_and_pallas(k, mode, dtype):
    """csrc/postfx.cu's strips (each image type's width) and row segments
    (sizes that divide neither H nor W) emulated in numpy: every output is
    computed from the CTA's own
    windows, and agrees with feather_heal_torch and feather_heal_pallas
    within test_postfx_plain_matches_pallas_f32's tolerances."""
    feather, heal = mode != "heal_only", mode != "feather_only"
    kw = dict(blur_ksize=k, feather_strength=10.0, heal_strength=0.5,
              enable_feathering=feather, enable_healing=heal)
    rng = np.random.default_rng(k)
    for h, w, segs in ((40, 300, 3), (37, 260, 2)):
        frame = _frame(h, w)
        left = np.clip(frame + 0.1 * rng.standard_normal(frame.shape), 0, 1).astype(np.float32)
        right = np.clip(frame - 0.1 * rng.standard_normal(frame.shape), 0, 1).astype(np.float32)
        dl, dr = _depth(h, w), np.roll(_depth(h, w), 3, axis=1)
        got = _postfx_schedule(left, right, frame, dl, dr, k, POSTFX_TW[dtype],
                               feather=feather, heal=heal, segs=segs)
        plain = postfx.feather_heal_torch(*(_t(a) for a in (left, right, frame, dl, dr)), **kw)
        wants = [plain]
        if h % 8 == 0:
            with pltpu.force_tpu_interpret_mode():
                wants.append(feather_heal_pallas(
                    *(jnp.asarray(a) for a in (left, right, frame, dl, dr)), block_rows=8, **kw))
        for e, (eye, d) in enumerate(((left, dl), (right, dr))):
            assert np.isfinite(got[e]).all()
            feathered = (np.asarray(jedges.feather_shift_edges(
                jnp.asarray(eye), jnp.asarray(frame), jnp.asarray(d), k, 10.0))
                if feather else eye)
            ok = ~_near_threshold(feathered) if heal else np.ones((h, w), bool)
            assert ok.mean() > 0.8
            for want in wants:
                err = np.abs(got[e] - _np(want[e])).max(axis=-1)
                assert err[ok].max() <= 1e-5, err[ok].max()


_DIV_CHECK = r"""
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
int main() {  // every float x in [0, 1024]: fma(fma(-q, c, x), r, q) == x / c
  const float cs[] = {9.0f, 25.0f};
  long long bad = 0;
  for (float c : cs) {
    const float r = 1.0f / c;
    for (long long b = 0; b <= 0x44800000LL; ++b) {
      const uint32_t u = (uint32_t)b;
      float x;
      std::memcpy(&x, &u, 4);
      const float q = x * r;
      const float got = std::fmaf(std::fmaf(-q, c, x), r, q), want = x / c;
      uint32_t g, w;
      std::memcpy(&g, &got, 4);
      std::memcpy(&w, &want, 4);
      bad += g != w;
    }
  }
  std::printf("%lld\n", bad);
  return 0;
}
"""


def test_postfx_division_by_9_and_25_is_exact(tmp_path):
    """csrc/postfx.cu divides by 9 (the 3x3 soften) and 25 (the 5x5 mask
    mean) as a product by RN(1 / c) and one FMA correction; for these two
    divisors that equals IEEE division for every float in [0, 1024], which
    covers every sum the kernel divides. Checked exhaustively on the host,
    whose float product, FMA and division round as the card's do."""
    import shutil
    import subprocess

    gxx = shutil.which("g++")
    if gxx is None or " fma" not in Path("/proc/cpuinfo").read_text():
        pytest.skip("needs g++ and a host with FMA instructions")
    src, exe = tmp_path / "div_check.cpp", tmp_path / "div_check"
    src.write_text(_DIV_CHECK)
    subprocess.run([gxx, "-O3", "-march=native", "-ffp-contract=off", "-o", str(exe),
                    str(src)], check=True, timeout=300)
    res = subprocess.run([str(exe)], capture_output=True, text=True, check=True, timeout=300)
    assert res.stdout.strip() == "0"


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


def _qpair_schedule(m: np.ndarray, r0: int, c0: int, rows: int, cols: int, ctas: int,
                    qs) -> np.ndarray:
    """numpy emulation of csrc/stats.cu:quantile_pair_kernel with `ctas`
    CTAs on the view m[r0:r0 + rows, c0:c0 + cols] of a contiguous map
    (16-byte aligned at its start): each CTA zeroes its share of the call's
    uninitialised scratch (4097 bins and a ticket) and counts one contiguous
    band of the row-major (row, column-group) grid into its own 4097-bin
    histogram; after the grid barrier each adds its nonzero bins to the
    global histogram, and the last CTA replays both bisections as the
    number of k where the predicate holds. -> [2]."""
    ld = m.shape[1]
    vec = (r0 * ld + c0) % 4 == 0 and ld % 4 == 0 and cols % 4 == 0
    g = 4 if vec else 1
    groups = cols // g
    n = rows * groups
    f32 = np.float32
    scratch = np.random.default_rng(ctas).integers(-2**31, 2**31, 4098)  # any contents
    idx = np.arange(4098)
    for b in range(ctas):  # thread t of CTA b: b 1024 + t, stride ctas 1024
        scratch[(idx // 1024) % ctas == b] = 0
    assert not scratch.any()  # the grid barrier: every share is zero
    ghist = scratch[:4097]
    for b in range(ctas):
        items = np.arange(n * b // ctas, n * (b + 1) // ctas)
        r, c = items // groups, items % groups
        v = m[r0 + r[:, None], c0 + c[:, None] * g + np.arange(g)].ravel()
        inner = (v > 0) & (v <= 1)
        up = np.ceil(np.where(inner, v, f32(1)) * f32(4096)).astype(np.int64)
        bins = np.where(inner, up - 1, np.where(v <= 0, 0, 4096))
        hist = np.bincount(bins, minlength=4097)
        nz = np.flatnonzero(hist)  # the flush: nonzero bins only
        ghist[nz] += hist[nz]
    assert ghist.sum() == rows * cols
    frac = np.cumsum(ghist[:4095]).astype(f32) / f32(rows * cols)
    out = []
    for q in qs:
        k = int((frac < f32(q)).sum())
        out.append((f32(k) / f32(4096) + f32(k + 1) / f32(4096)) * f32(0.5))
    return np.array(out, f32)


QPAIR_VIEWS = {
    **{name: (fn, None) for name, fn in QPAIR_CASES.items()},
    # a row stride and start column that rule out the float4 loads
    "unaligned_view": (lambda: _depth(50, 93, seed=4), (7, 1, 37, 61)),
}


@functools.lru_cache(maxsize=None)
def _qpair_references(name: str, qs: tuple) -> tuple:
    """The JAX bisection, and quantile_pair_pallas where H is a multiple of
    8, of one QPAIR_VIEWS view."""
    fn, view = QPAIR_VIEWS[name]
    m = fn()
    r0, c0, rows, cols = view or (0, 0, *m.shape)
    x = jnp.asarray(np.ascontiguousarray(m[r0:r0 + rows, c0:c0 + cols]))
    q = jnp.asarray(qs, jnp.float32)
    refs = [np.asarray(jq.bisect_quantile_01(x, q))]
    if rows % 8 == 0:
        with pltpu.force_tpu_interpret_mode():
            refs.append(np.asarray(quantile_pair_pallas(x, q)))
    return tuple(refs)


@pytest.mark.parametrize("ctas", [1, 7, 132, 264])
@pytest.mark.parametrize("name", sorted(QPAIR_VIEWS))
def test_quantile_pair_grid_schedule_bit_identical(name, ctas):
    fn, view = QPAIR_VIEWS[name]
    m = fn()
    r0, c0, rows, cols = view or (0, 0, *m.shape)
    for qs in ((0.02, 0.98), (0.05, 0.95)):
        got = _qpair_schedule(m, r0, c0, rows, cols, ctas, qs)
        for ref in _qpair_references(name, qs):
            np.testing.assert_array_equal(got, ref)
        plain = stats.quantile_pair_torch(_t(m)[r0:r0 + rows, c0:c0 + cols], *qs)
        np.testing.assert_array_equal(got, plain.numpy())


# ------------------------------------------------------- K4 subject stats

SUBJECT_CASES = {
    "random": lambda: np.random.default_rng(2).random((64, 128)).astype(np.float32),
    "depth": lambda: _depth(48, 80),
    "constant_valid": lambda: np.full((24, 64), 0.37, np.float32),
    "none_valid": lambda: np.full((24, 64), 0.97, np.float32),
    # every value on a 1/64 edge: the 64-bin histogram's correction terms
    "on_64_edges": lambda: (np.random.default_rng(3).integers(0, 65, (40, 96)) / 64
                            ).astype(np.float32),
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


def _subject_schedule(m: np.ndarray, r0: int, c0: int, rows: int, cols: int, cluster: int):
    """numpy emulation of csrc/stats.cu:subject_stats_kernel on the view
    m[r0:r0 + rows, c0:c0 + cols] of a contiguous map (16-byte aligned at
    its start): -> (hist [64], count, median), float32."""
    ld = m.shape[1]
    vec = (r0 * ld + c0) % 4 == 0 and ld % 4 == 0 and cols % 4 == 0
    g = 4 if vec else 1
    groups = cols // g
    n = rows * groups
    f32 = np.float32
    hist, edge = np.zeros(4096, np.int64), np.zeros(65, np.int64)
    for rank in range(cluster):  # each CTA's part of the (row, group) grid
        items = np.arange(n * rank // cluster, n * (rank + 1) // cluster)
        r, c = items // groups, items % groups
        v = m[r0 + r[:, None], c0 + c[:, None] * g + np.arange(g)].ravel()
        v = v[(v > f32(0.05)) & (v < f32(0.95))]
        t = v * f32(4096)
        up = np.ceil(t).astype(np.int64)
        hist += np.bincount(up - 1, minlength=4096)
        edge += np.bincount(up[(up % 64 == 0) & (up == t)] // 64, minlength=65)
    s = 4096 // cluster
    slices = [np.cumsum(hist[q * s:(q + 1) * s]) for q in range(cluster)]
    hist64 = np.zeros(64, np.float32)
    for q in range(cluster):
        for j in range(s // 64):
            i = q * (s // 64) + j
            right_closed = slices[q][64 * j + 63] - (slices[q][64 * j - 1] if j else 0)
            hist64[i] = right_closed + edge[i] - edge[i + 1]
    totals = np.array([sl[-1] for sl in slices])
    base = np.concatenate([[0], np.cumsum(totals)])
    cnt = f32(base[-1])
    count = max(cnt, f32(1))
    q = (np.floor((count - f32(1)) * f32(0.5)) + f32(1)) / count
    cum = np.concatenate([base[k] + slices[k] for k in range(cluster)])
    holds = (cum[:4095].astype(np.float32) / count) < q
    k = int(holds.sum())
    median = (f32(k) / f32(4096) + f32(k + 1) / f32(4096)) * f32(0.5)
    return hist64, cnt, f32(median)


SCHEDULE_VIEWS = {
    **{name: (fn, None) for name, fn in SUBJECT_CASES.items()},
    # a row stride and start column that rule out the float4 loads
    "unaligned_view": (lambda: _depth(50, 93, seed=4), (7, 1, 37, 61)),
}


@pytest.mark.parametrize("cluster", [8, 16])
@pytest.mark.parametrize("name", sorted(SCHEDULE_VIEWS))
def test_subject_cluster_schedule_bit_identical(name, cluster):
    fn, view = SCHEDULE_VIEWS[name]
    m = fn()
    h, w = m.shape
    r0, c0, rows, cols = view or (h // 5, w // 5, h * 4 // 5 - h // 5, w * 4 // 5 - w // 5)
    crop = m[r0:r0 + rows, c0:c0 + cols]
    hist, count, median = _subject_schedule(m, r0, c0, rows, cols, cluster)
    valid = (crop > 0.05) & (crop < 0.95)
    np.testing.assert_array_equal(hist, np.asarray(
        jq.histogram_01(jnp.asarray(crop), 64, jnp.asarray(valid))))
    assert count == float(valid.sum())
    assert median == np.asarray(jq.hist_masked_median(jnp.asarray(crop), jnp.asarray(valid)))
    p_hist, p_count, p_median = stats.subject_stats_torch(_t(m)[r0:r0 + rows, c0:c0 + cols])
    np.testing.assert_array_equal(hist, p_hist.numpy())
    assert count == p_count.item() and median == p_median.numpy()


# ------------------------------------------------------- K7 route bound

@pytest.mark.parametrize("n", [511, 512, 4095, 4096])
def test_attention_route_bound_matches_jax(n, monkeypatch):
    """With the USE_VMEM_KERNEL opt-in, self-attention takes K7 where the
    JAX package's gate does (_FLASH_MIN_SEQ <= N < _FLASH_ALWAYS_SEQ, and N
    within its kernel's MAX_RESIDENT_SEQ): from N = 4096 on the JAX package
    always takes its flash library route, SDPA here. Both routes are spies,
    so no N x N attention is computed. The head dim is one K7 is built
    for (``kattention.HEAD_DIMS``): others go to SDPA at any N."""
    from visiondepth3d_tpu.ops import attention as jattention
    from visiondepth3d_tpu.ops.pallas_attention import MAX_RESIDENT_SEQ
    from visiondepth3d_tpu_torch.kernels import attention as kattention
    from visiondepth3d_tpu_torch.ops import attention as tattention

    routes = []

    def spy(name):
        def route(q, k, v):
            routes.append(name)
            return q
        return route

    monkeypatch.setattr(tattention, "USE_VMEM_KERNEL", True)
    monkeypatch.setattr(kattention, "vmem_attention", spy("K7"))
    monkeypatch.setattr(tattention.F, "scaled_dot_product_attention", spy("SDPA"))
    q = torch.zeros(1, n, 2, 16)
    tattention.multi_head_attention(q, q, q)
    jax_k7 = (jattention._FLASH_MIN_SEQ <= n < jattention._FLASH_ALWAYS_SEQ
              and n <= MAX_RESIDENT_SEQ)
    assert routes == ["K7" if jax_k7 else "SDPA"]


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv_channel_slices_match_contiguous(dtype):
    """An input that is a channel slice of a wider NHWC buffer, and an out=
    that is another slice of it, give the contiguous form bit for bit and
    leave the rest of the buffer alone."""
    x, k, b = _conv_inputs(24, 8, seed=11)
    buf = _t(np.random.default_rng(12).random((2, 16, 24, 40), dtype=np.float32), dtype)
    buf[..., :24] = _t(x, dtype)
    want = conv.conv3x3(buf[..., :24].contiguous(), _t(k), _t(b), "lrelu")
    got = conv.conv3x3(buf[..., :24], _t(k), _t(b), "lrelu")
    assert torch.equal(got, want)
    before = buf.clone()
    res = conv.conv3x3(buf[..., :24], _t(k), _t(b), "lrelu", out=buf[..., 30:38])
    assert res.data_ptr() == buf[..., 30:38].data_ptr()
    assert torch.equal(buf[..., 30:38], want)
    assert torch.equal(buf[..., :30], before[..., :30])
    assert torch.equal(buf[..., 38:], before[..., 38:])


def test_conv_rejects_other_strides():
    x, k, b = _conv_inputs(8, 4, seed=13)
    tx = _t(x)
    for bad in (tx.transpose(1, 2), tx[:, 1:], tx[:, :, 1:], tx[..., ::2]):
        with pytest.raises(ValueError, match="channel slice"):
            conv.conv3x3(bad, _t(k[:, :, :bad.shape[-1]]), _t(b))
    out = torch.empty(2, 24, 16, 4).transpose(1, 2)
    with pytest.raises(ValueError, match="channel slice"):
        conv.conv3x3(tx, _t(k), _t(b), out=out)
    with pytest.raises(ValueError, match="out must be"):
        conv.conv3x3(tx, _t(k), _t(b), out=torch.empty(2, 16, 24, 5))
    assert conv.is_channel_slice(torch.empty(1, 2, 3, 8)[..., 2:5])
    assert not conv.is_channel_slice(torch.empty(2, 3, 8))


def _unpack_bf16(p):
    """The bf16 layout back to HWIO: undo the 16-byte group swizzle of each
    64-byte row, then [block, chunk, 9, bn, 32] -> [9, Cp, Op]."""
    nblk, nch, _, bn = p.w.shape[:4]
    n = torch.arange(bn)[:, None]
    w = p.w[:, :, :, n, torch.arange(4)[None, :] ^ ((n >> 1) & 3)]
    w = w.reshape(nblk, nch, 9, bn, 32).permute(2, 1, 4, 0, 3).reshape(9, nch * 32, nblk * bn)
    return w[:, :p.c, :p.o].reshape(3, 3, p.c, p.o), w


def _unpack_f32(p):
    """The float32 layout back to its two halves [2, 9, Cp, Op]: undo the
    16-byte group swizzle of each 64-byte row, [block, chunk, half, 9, bn,
    16] -> [half, 9, Cp, Op], then the K order of each 8 channels (0, 2, 4,
    6, 1, 3, 5, 7)."""
    nblk, nch, _, _, bn = p.w.shape[:5]
    n = torch.arange(bn)[:, None]
    w = p.w[:, :, :, :, n, torch.arange(4)[None, :] ^ ((n >> 1) & 3)]
    w = w.reshape(nblk, nch, 2, 9, bn, 16).permute(2, 3, 1, 5, 0, 4)
    w = w.reshape(2, 9, nch * 16, nblk * bn)
    order = conv.k8_order(nch * 16)
    assert order[:8].tolist() == [0, 2, 4, 6, 1, 3, 5, 7]
    out = torch.empty_like(w)
    out[:, :, order] = w
    return out


@pytest.mark.parametrize("c,o", [(3, 64), (64, 32), (192, 64), (64, 3), (96, 96),
                                 (192, 192), (48, 24)])
def test_pack_conv3x3_layout_unpacks_to_hwio(c, o):
    """pack_conv3x3's bf16 layout (what the wgmma kernel reads) holds every
    weight once, zeros in the padding, and unpacks back to HWIO; the float32
    layout holds the weights' two TF32 halves (big, small), which unpack to
    [9, Cp, Op] planes of TF32 values summing to HWIO within 2^-22, big the
    weights rounded to TF32, zeros in the padding."""
    _, k, b = _conv_inputs(c, o, seed=c + 7 * o)
    p = conv.pack_conv3x3(_t(k), _t(b), torch.bfloat16)
    assert p.bn == conv.block_n(o) and p.op % p.bn == 0 and p.cp % 32 == 0
    assert p.w.shape == (p.op // p.bn, p.cp // 32, 9, p.bn, 4, 8)
    hwio, padded = _unpack_bf16(p)
    assert torch.equal(hwio, _t(k).to(torch.bfloat16))
    assert int((padded != 0).sum()) == int((hwio != 0).sum())
    assert torch.equal(p.bias[:o], _t(b).to(torch.bfloat16).float())
    assert not p.bias[o:].any()
    p32 = conv.pack_conv3x3(_t(k), _t(b), torch.float32)
    assert p32.bn == conv.block_n(o) and p32.op % p32.bn == 0 and p32.cp % 16 == 0
    assert p32.w.shape == (p32.op // p32.bn, p32.cp // 16, 2, 9, p32.bn, 4, 4)
    big, small = _unpack_f32(p32)
    for half in (big, small):
        assert not (half.numpy().view(np.uint32) & 0x1FFF).any()
        assert not half[:, c:].any() and not half[:, :, o:].any()
    w9 = _t(k).reshape(9, c, o)
    assert torch.equal(big[:, :c, :o], tf32.round_tf32(w9))
    assert torch.equal(big[:, :c, :o], _t(_tf32_np(k.reshape(9, c, o))))
    rel = ((big + small)[:, :c, :o] - w9).abs() / w9.abs().clamp_min(1e-30)
    assert rel.max().item() <= 2.0 ** -22
    assert torch.equal(p32.bias[:o], _t(b)) and not p32.bias[o:].any()


# ------------------------------------------- split TF32 (K5's and K7's float32)

def _tf32_np(x):
    """numpy's own TF32 rounding (to nearest, ties away from zero, as the
    card's cvt.rna): add half of the 13 dropped bits' unit to the sign and
    magnitude pattern, mask them off (finite x)."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((u + np.uint32(1 << 12)) & np.uint32(~0x1FFF & 0xFFFFFFFF)).view(np.float32)


def _split_np(x):
    big = _tf32_np(x)
    return big, _tf32_np((np.asarray(x, np.float32) - big).astype(np.float32))


def _mm3(a, b):
    """a @ b as split TF32 does it: the three TF32 products small x big,
    big x small, big x big, each exact in float32, summed in float32."""
    (ab, as_), (bb, bs) = _split_np(a), _split_np(b)
    f = np.float32
    return (np.matmul(as_, bb, dtype=f) + np.matmul(ab, bs, dtype=f)) + np.matmul(ab, bb, dtype=f)


@pytest.mark.parametrize("scale", [1e-30, 1e-3, 1.0, 7e2, 1e30])
def test_split_tf32_halves(scale):
    """tf32.split_tf32: both halves are TF32 values (low 13 mantissa bits
    zero), big is x rounded to nearest with ties away from zero (as numpy's
    own rounding and the tie cases say), |x - big| <= 2^-11 |x|, and
    big + small is within 2^-22 |x| of x."""
    rng = np.random.default_rng(int(np.log10(scale)) + 40)
    x = (rng.standard_normal(8192) * scale).astype(np.float32)
    big, small = (h.numpy() for h in tf32.split_tf32(_t(x)))
    for half in (big, small):
        assert not (half.view(np.uint32) & 0x1FFF).any()
    np.testing.assert_array_equal(big, _tf32_np(x))
    ax = np.abs(x.astype(np.float64))
    assert (np.abs(big - x.astype(np.float64)) <= 2.0 ** -11 * ax).all()
    assert (np.abs(big.astype(np.float64) + small - x) <= 2.0 ** -22 * ax).all()
    p2 = np.float32(2.0 ** np.round(np.log2(scale)))  # ties stay ties at a power of two
    ties = np.array([1 + 2 ** -11, -(1 + 2 ** -11), 1 + 3 * 2 ** -11, 0.0, -0.0],
                    np.float32) * p2
    got = tf32.round_tf32(_t(ties)).numpy()
    want = np.array([1 + 2 ** -10, -(1 + 2 ** -10), 1 + 2 ** -9, 0.0, -0.0], np.float32) * p2
    np.testing.assert_array_equal(got, want)


def _attention_f64(q, k, v):
    s = np.einsum("bqhd,bkhd->bhqk", q, k, dtype=np.float64) / np.sqrt(q.shape[-1])
    p = np.exp(s - s.max(-1, keepdims=True))
    return np.einsum("bhqk,bkhd->bqhd", p / p.sum(-1, keepdims=True), v.astype(np.float64))


def _attention_split(q, k, v, fourth=False):
    """K7's float32 arithmetic in numpy: S and P V as three TF32 products
    (and the dropped small x small as a fourth where asked), the softmax in
    float32, P unnormalized and O divided by l once."""
    qh, kh, vh = (np.ascontiguousarray(x.transpose(0, 2, 1, 3)) for x in (q, k, v))
    mm = _mm3 if not fourth else (lambda a, b: _mm3(a, b) + np.matmul(
        _split_np(a)[1], _split_np(b)[1], dtype=np.float32))
    s = mm(qh, kh.transpose(0, 1, 3, 2))
    m = s.max(-1, keepdims=True)
    p = np.exp2(((s - m) * np.float32(np.log2(np.e) / np.sqrt(q.shape[-1]))).astype(np.float32))
    o = mm(p.astype(np.float32), vh) / p.sum(-1, keepdims=True, dtype=np.float32)
    return o.transpose(0, 2, 1, 3)


def _conv_split(x, k, b, fourth=False):
    """K5's float32 arithmetic in numpy: the plain version's K = 9C product
    as three TF32 products (four with the dropped small x small), bias in
    float32."""
    bsz, h, w, c = x.shape
    xp = np.pad(x, ((0, 0), (1, 1), (1, 1), (0, 0)))
    cat9 = np.concatenate([xp[:, ky:ky + h, kx:kx + w] for ky in range(3) for kx in range(3)],
                          -1).reshape(-1, 9 * c)
    wk = k.reshape(9 * c, -1)
    y = _mm3(cat9, wk)
    if fourth:
        y = y + np.matmul(_split_np(cat9)[1], _split_np(wk)[1], dtype=np.float32)
    return (y + b).reshape(bsz, h, w, -1)


def _conv_f64(x, k, b):
    bsz, h, w, c = x.shape
    xp = np.pad(x.astype(np.float64), ((0, 0), (1, 1), (1, 1), (0, 0)))
    y = sum(np.einsum("bhwc,co->bhwo", xp[:, ky:ky + h, kx:kx + w], k[ky, kx].astype(np.float64))
            for ky in range(3) for kx in range(3))
    return y + b


@pytest.mark.parametrize("shape", [(2, 130, 3, 64), (1, 97, 2, 128), (2, 70, 2, 16)])
def test_split_tf32_attention_meets_k7_gate(shape):
    """K7's float32 arithmetic (three TF32 products for S and for P V),
    emulated in numpy at toy shapes, stays within K7's float32 gate (1e-5)
    of the float64 attention, as close as the plain version (float32
    matmuls) is; the dropped small x small products move it by less than a
    tenth of the gate (a float32 step or two of the output)."""
    from visiondepth3d_tpu_torch.kernels import attention as kattention

    rng = np.random.default_rng(shape[1])
    q, k, v = (rng.standard_normal(shape).astype(np.float32) for _ in range(3))
    ref = _attention_f64(q, k, v)
    got = _attention_split(q, k, v)
    plain = kattention.vmem_attention_torch(*(_t(a) for a in (q, k, v))).numpy()
    err, err_plain = np.abs(got - ref).max(), np.abs(plain - ref).max()
    assert err <= 1e-5 and err_plain <= 1e-5, (err, err_plain)
    assert np.abs(_attention_split(q, k, v, fourth=True) - got).max() <= 1e-6


@pytest.mark.parametrize("c,o", [(3, 64), (64, 32), (192, 64), (64, 3)])
def test_split_tf32_conv_meets_k5_gate(c, o):
    """K5's float32 arithmetic (the K = 9C product as three TF32 products),
    emulated in numpy at the tools' channel counts on a small image, stays
    within K5's float32 gate (1e-4 x max |ref|) of the float64 conv; the
    dropped small x small products move it by less than a tenth of the
    gate (a float32 step or two of the output)."""
    x, k, b = _conv_inputs(c, o, seed=3 * c + o, shape=(1, 9, 11))
    ref = _conv_f64(x, k, b)
    got = _conv_split(x, k, b)
    scale = np.abs(ref).max()
    assert np.abs(got - ref).max() <= 1e-4 * scale
    assert np.abs(_conv_split(x, k, b, fourth=True) - got).max() <= 1e-5 * scale


def test_split_tf32_dropped_product_is_below_2_pow_22():
    """The one product split TF32 leaves out, a_small b_small, is below
    2^-22 |a b| for every pair of float32 values (each small half is at
    most 2^-11 of its value), so over a K-long sum it is below 2^-22 of
    sum |a b|: under a float32 rounding of that sum."""
    rng = np.random.default_rng(11)
    a = (rng.standard_normal(1 << 16) * np.exp(rng.standard_normal(1 << 16) * 4)).astype(
        np.float32)
    b = rng.permutation(a)
    (_, sa), (_, sb) = _split_np(a), _split_np(b)
    dropped = np.abs(sa.astype(np.float64) * sb)
    assert (dropped <= 2.0 ** -22 * np.abs(a.astype(np.float64) * b)).all()
    assert dropped.sum() <= 2.0 ** -22 * np.abs(a.astype(np.float64) * b).sum()


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
@pytest.mark.parametrize("k", [1, 9, 15])
@pytest.mark.parametrize("mode", ["both", "feather_only", "heal_only"])
@pytest.mark.parametrize("h,w", [(72, 200), (37, 1000), (21, 37)])
def test_cuda_postfx_matches_plain(cuda, dtype, k, mode, h, w):
    """K2 under the card gates at odd sizes (W = 1000 by TMA; W = 37, a
    pitch TMA cannot take, by the threads), every blur size the presets
    reach, feather-only and heal-only."""
    frame = _t(_frame(h, w), dtype).to(cuda)
    rng = np.random.default_rng(k)
    left = _t(np.clip(_frame(h, w) + 0.1 * rng.standard_normal((h, w, 3)), 0, 1), dtype).to(cuda)
    right = _t(np.clip(_frame(h, w) - 0.1 * rng.standard_normal((h, w, 3)), 0, 1),
               dtype).to(cuda)
    dl = _t(_depth(h, w), dtype).to(cuda)
    dr = _t(np.roll(_depth(h, w), 3, axis=1), dtype).to(cuda)
    kw = dict(blur_ksize=k, enable_feathering=mode != "heal_only",
              enable_healing=mode != "feather_only")
    got = postfx.feather_heal(left, right, frame, dl, dr, **kw)
    ref = postfx.feather_heal_torch(left, right, frame, dl, dr, **kw)
    diff = torch.cat([(g.float() - r.float()).abs().reshape(-1) for g, r in zip(got, ref)])
    if dtype == torch.float32:
        assert (diff <= 1e-4).float().mean().item() >= 0.9999
    else:
        assert diff.mean().item() <= 2e-3


@pytest.mark.cuda
def test_cuda_stats_match_plain(cuda):
    """K3, and K4 on an aligned crop, an unaligned view (start column 1,
    odd width: scalar loads), a 1x1 crop, a crop larger than one pass of
    the cluster's loads, and values on the 64-bin edges; K4 is one device
    event per call."""
    from visiondepth3d_tpu_torch.kernels._lib import device_ops

    m = _t(_depth(108, 192)).to(cuda)
    assert torch.equal(stats.quantile_pair(m, 0.02, 0.98),
                       stats.quantile_pair_torch(m, 0.02, 0.98))
    big = _t(_depth(1080, 1920, seed=5)).to(cuda)
    edges = _t(SUBJECT_CASES["on_64_edges"]()).to(cuda)
    for crop in (m[21:86, 36:156], m[21:86, 1:150], m[40:41, 50:51], big, edges[8:32, 16:80]):
        for a, b in zip(stats.subject_stats(crop), stats.subject_stats_torch(crop)):
            assert torch.equal(a, b)
    crop = m[21:86, 36:156]
    stats.subject_stats(crop)
    assert device_ops(lambda: stats.subject_stats(crop)) == 1
    assert device_ops(lambda: stats.quantile_pair(m, 0.02, 0.98)) == 1


@pytest.mark.cuda
def test_cuda_quantile_pair_maps_repeats_graphs_and_streams(cuda):
    """K3 bit-exact on a strided view (start column 1, odd width: scalar
    loads), a constant map, values outside [0, 1], a 1x1 map and the 1080p
    depth map; then five calls on different maps in a row, ten replays of
    one captured CUDA graph, and calls overlapping on two streams: no call
    depends on what an earlier or concurrent one left behind."""
    m = _t(_depth(108, 192)).to(cuda)
    maps = [m[21:86, 1:150], torch.full((32, 128), 0.37, device=cuda),
            _t(QPAIR_CASES["outside_01"]()).to(cuda), m[40:41, 50:51],
            _t(_depth(1080, 1920, seed=5)).to(cuda)]
    for qs in ((0.02, 0.98), (0.05, 0.95)):
        for x in maps:
            assert torch.equal(stats.quantile_pair(x, *qs), stats.quantile_pair_torch(x, *qs))
    outs = [stats.quantile_pair(x, 0.02, 0.98) for x in maps]
    for x, got in zip(maps, outs):
        assert torch.equal(got, stats.quantile_pair_torch(x, 0.02, 0.98))
    big = torch.empty_like(maps[-1])
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):  # the first call of this shape may be captured
        captured = stats.quantile_pair(big, 0.02, 0.98)
    for i in range(10):
        big.copy_(_t(_depth(1080, 1920, seed=6 + i)).to(cuda))
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(captured, stats.quantile_pair_torch(big, 0.02, 0.98))
    pair = [_t(_depth(1080, 1920, seed=20 + i)).to(cuda) for i in range(2)]
    wants = [stats.quantile_pair_torch(x, 0.05, 0.95) for x in pair]
    streams = [torch.cuda.Stream(cuda) for _ in pair]
    torch.cuda.synchronize()
    got = [[], []]
    for _ in range(20):
        for i, (x, st) in enumerate(zip(pair, streams)):
            with torch.cuda.stream(st):
                got[i].append(stats.quantile_pair(x, 0.05, 0.95))
    torch.cuda.synchronize()
    for outs_i, want in zip(got, wants):
        for out in outs_i:
            assert torch.equal(out, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,o,act", [(3, 64, None), (64, 32, "lrelu"), (192, 64, None),
                                     (64, 3, None), (12, 16, "relu"), (36, 16, "lrelu"),
                                     (96, 96, None), (192, 192, "lrelu"), (16, 8, "relu"),
                                     (48, 24, None)])
@pytest.mark.parametrize("shape", [(2, 13, 37), (1, 17, 70)])
def test_cuda_conv_matches_plain(cuda, dtype, c, o, act, shape):
    """Ragged tiles (13 x 37 and 17 x 70 are no multiple of the 8 x 32 or
    4 x 32 tile), channel counts that are no multiple of 16 (C = 3, 12:
    loaded by the threads; 36: a last chunk of 4 channels), one chunk by
    TMA (C = 16), several blocks of output channels (96, 192), O = 3 and 8
    (8-wide N tiles), and every activation."""
    x, k, b = _conv_inputs(c, o, seed=c + o, shape=shape)
    x, k, b = _t(x, dtype).to(cuda), _t(k).to(cuda), _t(b).to(cuda)
    got = conv.conv3x3(x, k, b, act)
    ref = conv.conv3x3_torch(x, k, b, act)
    scale = ref.float().abs().max().item()
    err = (got.float() - ref.float()).abs()
    if dtype == torch.float32:
        assert err.max().item() <= 1e-4 * scale
    else:
        assert err.max().item() <= 8e-3 * scale and err.mean().item() <= 1e-3 * scale


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [1, 2, 3, 4, 5])
def test_cuda_conv_on_dense_block_slices(cuda, dtype, k):
    """Conv k of a dense block (nf 64, gc 32): the input a slice of the
    192-channel buffer, the output written into the next 32 channels
    (conv5 reads all 192 into a new tensor), against the plain version on
    the same views."""
    c = 64 + 32 * (k - 1)
    o = 32 if k < 5 else 64
    x, w, b = _conv_inputs(c, o, seed=40 + k, shape=(2, 13, 37))
    buf = _t(np.random.default_rng(k).random((2, 13, 37, 192), dtype=np.float32), dtype)
    buf[..., :c] = _t(x, dtype)
    buf = buf.to(cuda)
    w, b = _t(w).to(cuda), _t(b).to(cuda)
    act = "lrelu" if k < 5 else None
    ref = conv.conv3x3_torch(buf[..., :c], w, b, act)
    if k < 5:
        before = buf.clone()
        conv.conv3x3(buf[..., :c], w, b, act, out=buf[..., c:c + o])
        got = buf[..., c:c + o]
        assert torch.equal(buf[..., :c], before[..., :c])
        assert torch.equal(buf[..., c + o:], before[..., c + o:])
    else:
        got = conv.conv3x3(buf, w, b, act)
    scale = ref.float().abs().max().item()
    err = (got.float() - ref.float()).abs()
    if dtype == torch.float32:
        assert err.max().item() <= 1e-4 * scale
    else:
        assert err.max().item() <= 8e-3 * scale and err.mean().item() <= 1e-3 * scale


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c0,c,o0,o", [(5, 3, 101, 3), (0, 3, 64, 64), (7, 36, 133, 24),
                                       (16, 48, 75, 16)])
def test_cuda_conv_on_unaligned_slices(cuda, dtype, c0, c, o0, o):
    """Channel slices the dense block never makes: inputs starting off a
    16-byte boundary (loaded by the threads, not TMA) and at one (TMA with
    the 192-channel pixel stride), outputs at odd channel offsets (one value
    a store), C = 3 and O = 3 among them; against the plain version, every
    other channel of the buffer unchanged."""
    x, w, b = _conv_inputs(c, o, seed=c0 + c + o, shape=(2, 13, 37))
    buf = _t(np.random.default_rng(c0).random((2, 13, 37, 192), dtype=np.float32), dtype)
    buf[..., c0:c0 + c] = _t(x, dtype)
    buf = buf.to(cuda)
    w, b = _t(w).to(cuda), _t(b).to(cuda)
    ref = conv.conv3x3_torch(buf[..., c0:c0 + c], w, b, "lrelu")
    before = buf.clone()
    conv.conv3x3(buf[..., c0:c0 + c], w, b, "lrelu", out=buf[..., o0:o0 + o])
    assert torch.equal(buf[..., :o0], before[..., :o0])
    assert torch.equal(buf[..., o0 + o:], before[..., o0 + o:])
    scale = ref.float().abs().max().item()
    err = (buf[..., o0:o0 + o].float() - ref.float()).abs()
    if dtype == torch.float32:
        assert err.max().item() <= 1e-4 * scale
    else:
        assert err.max().item() <= 8e-3 * scale and err.mean().item() <= 1e-3 * scale


# ---------------------------------------------------------------- K7 attention


def _k7_gate(got, ref, dtype):
    """K7's gates of the depth route's card case: float32 max <= 1e-5; bf16
    max <= 1.6e-2 and mean <= 1e-3."""
    err = (got.float() - ref.float()).abs()
    if dtype == torch.float32:
        assert err.max().item() <= 1e-5
    else:
        assert err.max().item() <= 1.6e-2 and err.mean().item() <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [16, 32, 64, 128])
def test_cuda_vmem_attention_tiles_and_head_dims(cuda, dtype, d):
    """K7 at every head dim it is built for, on sequences that end off its
    tiles: N = 1, 65 (65 query rows, no multiple of 64; a last key tile of
    one key), 200 (no multiple of 128; a last key tile of 8 keys, or of 8
    at float32 D = 128's 32-key tiles) against the plain version, and query
    bands of 1, 77 and 129 rows against the 200 keys, each bit for bit the
    same rows of the whole-sequence call."""
    from visiondepth3d_tpu_torch.kernels import attention as kattention

    assert d in kattention.HEAD_DIMS
    gen = torch.Generator().manual_seed(d)
    for n in (1, 65, 200):
        q, k, v = (torch.randn(2, n, 3, d, generator=gen).to(cuda, dtype) for _ in range(3))
        whole = kattention.vmem_attention(q, k, v)
        _k7_gate(whole, kattention.vmem_attention_torch(q, k, v), dtype)
    for a, b in ((0, 1), (3, 80), (71, 200)):
        band = kattention.vmem_attention(q[:, a:b], k, v)
        _k7_gate(band, kattention.vmem_attention_torch(q[:, a:b], k, v), dtype)
        assert torch.equal(band, whole[:, a:b])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("heads", [12, 16])
def test_cuda_vmem_attention_vit_widths(cuda, dtype, heads):
    """K7 at the head counts of ViT-B (12) and ViT-L (16), which the depth
    route's opt-in now sends to it, at 1370 tokens (518^2 / 14^2 + 1):
    against its plain version under the gates of the depth route's card
    case (float32 max <= 1e-5; bf16 max <= 1.6e-2, mean <= 1e-3)."""
    from visiondepth3d_tpu_torch.kernels import attention as kattention

    gen = torch.Generator().manual_seed(heads)
    q, k, v = (torch.randn(2, 1370, heads, 64, generator=gen).to(cuda, dtype) for _ in range(3))
    got = kattention.vmem_attention(q, k, v)
    ref = kattention.vmem_attention_torch(q, k, v)
    err = (got.float() - ref.float()).abs()
    if dtype == torch.float32:
        assert err.max().item() <= 1e-5
    else:
        assert err.max().item() <= 1.6e-2 and err.mean().item() <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(280, 577, 16, 64), (32, 1370, 6, 64), (2, 2040, 20, 64),
                                   (24, 2040, 20, 64)])
def test_cuda_vmem_attention_route_shapes(cuda, dtype, shape):
    """K7 at the shapes the Depth Pro, VDA, Marigold and DepthCrafter depth
    routes give it under the opt-in: Depth Pro's patch encoder over 8 frames
    at 1536^2 (35 windows of 577 tokens a frame), VDA-Small's 32-frame window
    at 518^2, Marigold's UNet level 2 at 1080p (34 x 60 latents, 20 heads,
    batch 2), DepthCrafter's at the same level over a 24-frame window.
    Gates of the depth route's card case."""
    from visiondepth3d_tpu_torch.kernels import attention as kattention

    gen = torch.Generator().manual_seed(shape[0])
    q, k, v = (torch.randn(*shape, generator=gen).to(cuda, dtype) for _ in range(3))
    got = kattention.vmem_attention(q, k, v)
    ref = kattention.vmem_attention_torch(q, k, v)
    err = (got.float() - ref.float()).abs()
    if dtype == torch.float32:
        assert err.max().item() <= 1e-5
    else:
        assert err.max().item() <= 1.6e-2 and err.mean().item() <= 1e-3
