"""Port ops (visiondepth3d_tpu_torch/ops) against their JAX twins.

The same numpy inputs go through the JAX function on the CPU and through
its PyTorch counterpart with device="cpu". Tolerances: the u8/YUV
conversions and the bisection statistics are bit-exact (integer math, and
0/1 counts exact in float32); float stencils and resamplers agree to 1e-5
(float32 rounding in a different summation order).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visiondepth3d_tpu.ops import convert as jconvert
from visiondepth3d_tpu.ops import depth_shaping as jshaping
from visiondepth3d_tpu.ops import edges as jedges
from visiondepth3d_tpu.ops import filters as jfilters
from visiondepth3d_tpu.ops import formats as jformats
from visiondepth3d_tpu.ops import grade as jgrade
from visiondepth3d_tpu.ops import quantiles as jq
from visiondepth3d_tpu.ops import resize as jresize
from visiondepth3d_tpu.ops import subject as jsubject
from visiondepth3d_tpu.ops import warp as jwarp
from visiondepth3d_tpu_torch.ops import convert as tconvert
from visiondepth3d_tpu_torch.ops import depth_shaping as tshaping
from visiondepth3d_tpu_torch.ops import edges as tedges
from visiondepth3d_tpu_torch.ops import filters as tfilters
from visiondepth3d_tpu_torch.ops import formats as tformats
from visiondepth3d_tpu_torch.ops import grade as tgrade
from visiondepth3d_tpu_torch.ops import quantiles as tq
from visiondepth3d_tpu_torch.ops import resize as tresize
from visiondepth3d_tpu_torch.ops import subject as tsubject
from visiondepth3d_tpu_torch.ops import warp as twarp

EXACT = 0.0
F32 = 1e-5


def _rng(seed=0):
    return np.random.default_rng(seed)


def _depth(h=48, w=64, seed=0):
    yy, xx = np.mgrid[0:h, 0:w]
    d = 0.5 + 0.3 * np.sin(xx / 7.0 + seed) * np.cos(yy / 5.0) + 0.2 * (xx / w - 0.5)
    d = d + 0.02 * _rng(seed).random((h, w))
    return np.clip(d, 0, 1).astype(np.float32)


def _frame(h=48, w=64, seed=1):
    return _rng(seed).random((h, w, 3), dtype=np.float32)


def _check(got, want, tol):
    got = [got] if not isinstance(got, (tuple, list)) else list(got)
    want = [want] if not isinstance(want, (tuple, list)) else list(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g = g.detach().cpu().numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        w = np.asarray(w)
        assert g.shape == w.shape, (g.shape, w.shape)
        if tol == EXACT:
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g.astype(np.float64), w.astype(np.float64),
                                       atol=tol, rtol=0)


def _run(case):
    jax_fn, torch_fn, args, tol = case()
    want = jax_fn(*[jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args])
    got = torch_fn(*[torch.from_numpy(a) if isinstance(a, np.ndarray) else a for a in args])
    _check(got, want, tol)


# ------------------------------------------------------------------ convert

def _u8(shape, seed=2):
    return _rng(seed).integers(0, 256, shape, dtype=np.uint8)


CONVERT = {
    "u8_to_float": lambda: (jconvert.u8_to_float, tconvert.u8_to_float, [_u8((6, 8, 3))], EXACT),
    "float_to_u8_trunc": lambda: (jconvert.float_to_u8_trunc, tconvert.float_to_u8_trunc,
                                  [_rng(3).uniform(-0.2, 1.2, (6, 8, 3)).astype(np.float32)], EXACT),
    "float_to_u8_round": lambda: (jconvert.float_to_u8_round, tconvert.float_to_u8_round,
                                  [_rng(4).uniform(-0.2, 1.2, (6, 8, 3)).astype(np.float32)], EXACT),
    "round_half_even": lambda: (jconvert.float_to_u8_round, tconvert.float_to_u8_round,
                                [(np.arange(256, dtype=np.float32) + 0.5) / 255.0], EXACT),
    "quantize_u8": lambda: (jconvert.quantize_u8, tconvert.quantize_u8,
                            [_rng(5).random((6, 8, 3)).astype(np.float32)], EXACT),
    "yuv420_to_rgb": lambda: (jconvert.yuv420_to_rgb_u8, tconvert.yuv420_to_rgb_u8,
                              [_u8((2, 10, 12)), _u8((2, 5, 6), 3), _u8((2, 5, 6), 4)], EXACT),
    "rgb_to_yuv420": lambda: (jconvert.rgb_u8_to_yuv420, tconvert.rgb_u8_to_yuv420,
                              [_u8((2, 10, 12, 3))], EXACT),
}


@pytest.mark.parametrize("name", sorted(CONVERT))
def test_convert(name):
    _run(CONVERT[name])


# ------------------------------------------------------------------ resize

def _resize_case(kind, shape, out_hw, **kw):
    jfn = {"bilinear": jresize.resize_bilinear, "bicubic": jresize.resize_bicubic,
           "area": jresize.resize_area}[kind]
    tfn = {"bilinear": tresize.resize_bilinear, "bicubic": tresize.resize_bicubic,
           "area": tresize.resize_area}[kind]
    x = _rng(6).random(shape, dtype=np.float32)
    return lambda: (lambda a: jfn(a, out_hw, **kw), lambda a: tfn(a, out_hw, **kw), [x], F32)


RESIZE = {
    "bilinear_down_hwc": _resize_case("bilinear", (2, 40, 52, 3), (28, 28)),
    "bilinear_up_hw": _resize_case("bilinear", (3, 12, 20), (48, 64), channel_last=False),
    "bilinear_ac_nchw": _resize_case("bilinear", (1, 4, 6, 7), (12, 14), align_corners=True,
                                     channel_last=False),
    "bicubic_grid": _resize_case("bicubic", (5, 5, 8), (4, 6), channel_last=True),
    "area_down": _resize_case("area", (24, 30, 3), (10, 15)),
    "area_up": _resize_case("area", (10, 15, 3), (24, 30)),
    "pad_to_aspect": lambda: (lambda a: jresize.pad_to_aspect(a, 64, 48),
                              lambda a: tresize.pad_to_aspect(a, 64, 48),
                              [_frame(36, 64)], F32),
}


@pytest.mark.parametrize("name", sorted(RESIZE))
def test_resize(name):
    _run(RESIZE[name])


@pytest.mark.parametrize("in_hw,out_hw", [((540, 960), (405, 720)),
                                          ((1440, 2560), (1080, 1920)),
                                          ((2160, 3840), (1080, 1920)),
                                          ((64, 96), (48, 72))])
def test_resize_area_large_sizes_match_jax(in_hw, out_hw):
    """Above the JAX package's ``_MATRIX_LIMIT`` weights, resize_area is an
    integer-factor box mean or a 2-tap bilinear gather, not the area
    matrix; the port makes the same switch (the first two sizes differed by
    0.13 before it did)."""
    x = _rng(8).random((*in_hw, 3), dtype=np.float32)
    want = np.asarray(jresize.resize_area(jnp.asarray(x), out_hw))
    got = tresize.resize_area(torch.from_numpy(x), out_hw).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


# ------------------------------------------------------------------ filters

FILTERS = {
    **{f"box_blur_{k}": (lambda k=k: (lambda a: jfilters.box_blur(a, k),
                                      lambda a: tfilters.box_blur(a, k), [_depth()], F32))
       for k in (3, 5, 9, 15)},
    "box_blur_batched": lambda: (lambda a: jfilters.box_blur(a, 3),
                                 lambda a: tfilters.box_blur(a, 3),
                                 [_frame().transpose(2, 0, 1).copy()], F32),
    "sharpen": lambda: (lambda a: jfilters.sharpen(a, 1.0), lambda a: tfilters.sharpen(a, 1.0),
                        [_frame()], F32),
    "sharpen_kernel_sum_zero": lambda: (lambda a: jfilters.sharpen(a, -1.0),
                                        lambda a: tfilters.sharpen(a, -1.0), [_frame()], F32),
    "forward_diff_grad": lambda: (jfilters.forward_diff_grad, tfilters.forward_diff_grad,
                                  [_depth()], F32),
}


@pytest.mark.parametrize("name", sorted(FILTERS))
def test_filters(name):
    _run(FILTERS[name])


# ------------------------------------------------------------------ quantiles

def _masked(seed=7):
    x = _depth(seed=seed)
    return x, (x > 0.05) & (x < 0.95)


QUANTILES = {
    "bisect_pair": lambda: (lambda a: jq.bisect_quantile_01(a, jnp.asarray([0.02, 0.98])),
                            lambda a: tq.bisect_quantile_01(a, (0.02, 0.98)), [_depth()], EXACT),
    "bisect_scalar": lambda: (lambda a: jq.bisect_quantile_01(a, 0.5),
                              lambda a: tq.bisect_quantile_01(a, 0.5), [_depth(seed=3)], EXACT),
    "bisect_masked": lambda: (lambda a, m: jq.bisect_quantile_01(a, jnp.asarray([0.1, 0.9]), m),
                              lambda a, m: tq.bisect_quantile_01(a, (0.1, 0.9), m),
                              list(_masked()), EXACT),
    "bisect_constant": lambda: (lambda a: jq.bisect_quantile_01(a, jnp.asarray([0.05, 0.95])),
                                lambda a: tq.bisect_quantile_01(a, (0.05, 0.95)),
                                [np.full((20, 30), 0.37, np.float32)], EXACT),
    "quantile_01_hist": lambda: (lambda a: jq.quantile_01(a, jnp.asarray([0.05, 0.95])),
                                 lambda a: tq.quantile_01(a, (0.05, 0.95)), [_depth()], EXACT),
    "histogram_01": lambda: (lambda a: jq.histogram_01(a, 64), lambda a: tq.histogram_01(a, 64),
                             [_depth()], EXACT),
    "histogram_01_masked": lambda: (lambda a, m: jq.histogram_01(a, 64, m),
                                    lambda a, m: tq.histogram_01(a, 64, m),
                                    list(_masked(8)), EXACT),
    "hist_masked_median": lambda: (jq.hist_masked_median, tq.hist_masked_median,
                                   list(_masked(9)), EXACT),
    "exact_quantile": lambda: (lambda a: jq.exact_quantile(a, jnp.asarray([0.02, 0.98])),
                               lambda a: tq.exact_quantile(a, (0.02, 0.98)), [_depth()], 1e-6),
    "exact_quantile_masked": lambda: (
        lambda a, m: jq.exact_quantile(a, jnp.asarray([0.1, 0.9]), m),
        lambda a, m: tq.exact_quantile(a, (0.1, 0.9), m), list(_masked(10)), 1e-6),
    "exact_masked_median": lambda: (jq.exact_masked_median, tq.exact_masked_median,
                                    list(_masked(11)), EXACT),
}


@pytest.mark.parametrize("name", sorted(QUANTILES))
def test_quantiles(name):
    _run(QUANTILES[name])


# ------------------------------------------------------- subject, shaping

SUBJECT = {
    "estimate_subject_hist": lambda: (jsubject.estimate_subject_depth,
                                      tsubject.estimate_subject_depth, [_depth()], EXACT),
    "estimate_subject_exact": lambda: (lambda a: jsubject.estimate_subject_depth(a, "exact"),
                                       lambda a: tsubject.estimate_subject_depth(a, "exact"),
                                       [_depth(seed=2)], EXACT),
    "estimate_subject_few_valid": lambda: (jsubject.estimate_subject_depth,
                                           tsubject.estimate_subject_depth,
                                           [np.full((48, 64), 0.99, np.float32)], EXACT),
    "dynamic_parallax_scale": lambda: (jsubject.dynamic_parallax_scale,
                                       tsubject.dynamic_parallax_scale, [_depth()], F32),
    "motion_metric": lambda: (jsubject.motion_metric, tsubject.motion_metric,
                              [_depth(seed=1), _depth(seed=2)], F32),
    "shape_depth_for_pop": lambda: (
        lambda a: jshaping.shape_depth_for_pop(a, jnp.float32(0.4)),
        lambda a: tshaping.shape_depth_for_pop(a, torch.tensor(0.4)), [_depth()], F32),
    "shape_depth_degenerate": lambda: (
        lambda a: jshaping.shape_depth_for_pop(a, jnp.float32(0.4)),
        lambda a: tshaping.shape_depth_for_pop(a, torch.tensor(0.4)),
        [np.full((48, 64), 0.6, np.float32)], F32),
    "enhance_curvature": lambda: (lambda a: jshaping.enhance_curvature(a, 0.08),
                                  lambda a: tshaping.enhance_curvature(a, 0.08), [_depth()], F32),
}


@pytest.mark.parametrize("name", sorted(SUBJECT))
def test_subject_and_shaping(name):
    _run(SUBJECT[name])


# ------------------------------------------------------- edges, grade

EDGES = {
    "suppress_edge_mask": lambda: (
        lambda d, s: jedges.suppress_artifacts_with_edge_mask(d, s, 10.0),
        lambda d, s: tedges.suppress_artifacts_with_edge_mask(d, s, 10.0),
        [_depth(), (0.03 * _rng(12).standard_normal((48, 64))).astype(np.float32)], F32),
    "feather_shift_edges": lambda: (
        lambda a, o, d: jedges.feather_shift_edges(a, o, d, 9, 10.0),
        lambda a, o, d: tedges.feather_shift_edges(a, o, d, 9, 10.0),
        [_frame(seed=1), _frame(seed=2), _depth()], F32),
    "heal_missing_pixels": lambda: (
        lambda a, o: jedges.heal_missing_pixels(a, o, None, 0.5),
        lambda a, o: tedges.heal_missing_pixels(a, o, 0.5),
        [_frame(seed=3), _frame(seed=4)], F32),
    "color_grade_identity": lambda: (jgrade.apply_color_grade, tgrade.apply_color_grade,
                                     [_frame()], F32),
    "color_grade": lambda: (lambda a: jgrade.apply_color_grade(a, 1.3, 0.8, 0.05),
                            lambda a: tgrade.apply_color_grade(a, 1.3, 0.8, 0.05),
                            [_frame()], F32),
}


@pytest.mark.parametrize("name", sorted(EDGES))
def test_edges_and_grade(name):
    _run(EDGES[name])


# ------------------------------------------------------- warp, formats

def _shift(h=48, w=64, amp=0.05, seed=13):
    return (amp * (_rng(seed).random((h, w)) - 0.5)).astype(np.float32)


WARP = {
    "disparity_warp": lambda: (jwarp.disparity_warp, twarp.disparity_warp,
                               [_frame(), _shift()], F32),
    "stereo_warp_gather": lambda: (lambda f, d, s: jwarp.stereo_warp(f, d, s),
                                   lambda f, d, s: twarp.stereo_warp(f, d, s),
                                   [_frame(), _depth(), _shift()], F32),
    "stereo_warp_shifted_acc": lambda: (lambda f, d, s: jwarp.stereo_warp(f, d, s, 4),
                                        lambda f, d, s: twarp.stereo_warp(f, d, s, 4),
                                        [_frame(), _depth(), _shift(amp=0.2)], F32),
    "stereo_warp_border_clamp": lambda: (lambda f, d, s: jwarp.stereo_warp(f, d, s, 8),
                                         lambda f, d, s: twarp.stereo_warp(f, d, s, 8),
                                         [_frame(), _depth(), np.full((48, 64), 0.2, np.float32)],
                                         F32),
}


@pytest.mark.parametrize("name", sorted(WARP))
def test_warp(name):
    _run(WARP[name])


FORMATS = {
    "side_mask_left": lambda: (lambda a: jformats.apply_side_mask(a, jnp.float32(7.0), -1),
                               lambda a: tformats.apply_side_mask(a, torch.tensor(7.0),
                                                                  torch.tensor(-1.0)),
                               [_frame()], EXACT),
    "side_mask_right": lambda: (lambda a: jformats.apply_side_mask(a, jnp.float32(5.0), 1),
                                lambda a: tformats.apply_side_mask(a, torch.tensor(5.0),
                                                                   torch.tensor(1.0)),
                                [_frame()], EXACT),
    "side_mask_off": lambda: (lambda a: jformats.apply_side_mask(a, jnp.float32(5.0), 0),
                              lambda a: tformats.apply_side_mask(a, torch.tensor(5.0),
                                                                 torch.tensor(0.0)),
                              [_frame()], EXACT),
    "full_sbs": lambda: (
        lambda a, b: jformats.format_3d_output(*jformats.pack_per_eye(a, b, "Full-SBS", 64, 48),
                                               "Full-SBS"),
        lambda a, b: tformats.format_3d_output(*tformats.pack_per_eye(a, b, "Full-SBS", 64, 48),
                                               "Full-SBS"),
        [_frame(), _frame(seed=5)], F32),
    "half_sbs": lambda: (
        lambda a, b: jformats.format_3d_output(*jformats.pack_per_eye(a, b, "Half-SBS", 32, 48),
                                               "Half-SBS"),
        lambda a, b: tformats.format_3d_output(*tformats.pack_per_eye(a, b, "Half-SBS", 32, 48),
                                               "Half-SBS"),
        [_frame(), _frame(seed=5)], F32),
}


@pytest.mark.parametrize("name", sorted(FORMATS))
def test_formats(name):
    _run(FORMATS[name])


def test_unknown_format_packs_like_jax():
    """A format name outside FORMATS does not raise: as in the JAX package,
    the eyes are letterboxed and put side by side (the Full-SBS layout)."""
    a, b = _frame(), _frame(seed=5)
    want = jformats.format_3d_output(*jformats.pack_per_eye(jnp.asarray(a), jnp.asarray(b),
                                                            "Over-Under", 64, 48),
                                     "Over-Under")
    got = tformats.format_3d_output(*tformats.pack_per_eye(torch.from_numpy(a),
                                                           torch.from_numpy(b),
                                                           "Over-Under", 64, 48),
                                    "Over-Under")
    assert tuple(got.shape) == (48, 128, 3)
    _check(got, want, F32)
