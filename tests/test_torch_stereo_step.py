"""The port's stereo step against the JAX one over an 8-frame clip.

Both sides get the same frames and depth maps (numpy, from a seed) and run
the step frame by frame; the trackers are compared after every frame.

- parity config (exact quantiles, the reference's u8 truncations, gather
  warp), against the JAX step run op by op: trackers within 1e-6, outputs
  within 1e-5 except where a u8 truncation flipped. Parity mode floors
  values that often sit exactly on a u8 boundary (the grade and the sharpen
  of quantized pixels land on k/255), so a one-ulp difference between
  XLA's and PyTorch's float32 kernels moves such a value by exactly one u8
  step, and the step can carry through the frame's three truncation points.
  Allowed: a whole number of u8 steps, at most three, on at most 0.1 % of
  the values. (Under jit XLA also fuses multiply-adds, which flips about
  14 % of them.)
- shipped config (bisection quantiles, bf16 image plane, healing on):
  per-frame SSIM >= 0.99 and mean |d| <= one u8 step (the JAX CPU path
  keeps the warped image in float32 where the port rounds it to bf16).

The depth-of-field cases run ``render_chunk`` over the clip with
``dof_strength = 2.0`` on both sides, in both configurations and in a
Half-SBS geometry (the warp at half the eye's width, so DOF reads the
depth resized to the warp size), under the same gates, except that parity
mode allows four u8 steps: the focal plane differs by one float32 ulp
from the second frame on (inside the 1e-6 tracker gate), which moves the
DOF lerp weights of every blurred pixel by about 1e-7 and so flips a few
more truncations at the grade, and the sharpen's center weight of 3 turns
one such flip into three steps beside its own.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
torch.set_num_threads(1)

from visiondepth3d_tpu.state import init_trackers as jinit
from visiondepth3d_tpu.stereo import StereoParams as JParams
from visiondepth3d_tpu.stereo.step import render_chunk as jrender_chunk
from visiondepth3d_tpu.stereo.step import stereo_frame_step as jstep
from visiondepth3d_tpu_torch.state import init_trackers as tinit
from visiondepth3d_tpu_torch.stereo import StereoParams as TParams
from visiondepth3d_tpu_torch.stereo.step import render_chunk, stereo_frame_step

H, W, T = 64, 96, 8
TRACKER_FIELDS = ("initialized", "prev_depth", "prev_norm_depth", "norm_lo", "norm_hi",
                  "norm_init", "conv_val", "conv_init", "fg", "mg", "bg", "shift_init",
                  "fw_offset", "fw_counter", "bar_width", "focal", "focal_init")


def _clip(seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W]
    frames, depths = [], []
    for i in range(T):
        f = np.stack([0.5 + 0.4 * np.sin((xx + 3 * i) / (6.0 + c) + yy / 11.0)
                      for c in range(3)], -1)
        f = f + 0.05 * rng.random((H, W, 3))
        d = 0.45 + 0.25 * np.sin(xx / 13.0 + 0.2 * i) * np.cos(yy / 9.0) + 0.2 * (xx / W)
        box = (xx > 20 + 3 * i) & (xx < 50 + 3 * i) & (yy > 15) & (yy < 45)
        d = np.where(box, 0.15, d) + 0.01 * rng.random((H, W))
        frames.append(np.clip(f, 0, 1))
        depths.append(np.clip(d, 0, 1))
    return np.asarray(frames, np.float32), np.asarray(depths, np.float32)


def _ssim(a, b):
    """Mean SSIM of two [H, W, 3] images in [0, 1] on luma, 7x7 windows."""
    def box(x, k=7):
        c = np.cumsum(np.cumsum(np.pad(x, ((1, 0), (1, 0))), 0), 1)
        return (c[k:, k:] - c[:-k, k:] - c[k:, :-k] + c[:-k, :-k]) / (k * k)

    wts = np.array([0.299, 0.587, 0.114])
    x, y = a.astype(np.float64) @ wts, b.astype(np.float64) @ wts
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    mx, my = box(x), box(y)
    vx, vy, cxy = box(x * x) - mx * mx, box(y * y) - my * my, box(x * y) - mx * my
    return float((((2 * mx * my + c1) * (2 * cxy + c2))
                  / ((mx * mx + my * my + c1) * (vx + vy + c2))).mean())


CONFIGS = {
    "parity": dict(quantile_mode="exact", parity_quantize=True, warp_backend="gather"),
    "shipped": dict(enable_healing=True, image_dtype="bfloat16"),
}


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_stereo_step_matches_jax(config):
    kw = CONFIGS[config]
    jp = JParams(**kw).with_shift_bound(W)
    tp = TParams(**{**kw, "warp_backend": kw.get("warp_backend", "auto")}).with_shift_bound(W)
    frames, depths = _clip()
    step = jax.jit(lambda t, f, d: jstep(jp, t, f, d))
    if config == "parity":
        def step(t, f, d):  # op by op: no fused multiply-adds
            with jax.disable_jit():
                return jstep(jp, t, f, d)
    jt, tt = jinit(H, W), tinit(H, W, device="cpu")
    for i in range(T):
        jt, jout = step(jt, jnp.asarray(frames[i]), jnp.asarray(depths[i]))
        tt, tout = stereo_frame_step(tp, tt, torch.from_numpy(frames[i]),
                                     torch.from_numpy(depths[i]))
        _check_trackers(config, jt, tt, f"frame {i}")
        for name in ("left", "right"):
            _check_eye(config, np.asarray(getattr(jout, name), np.float32),
                       getattr(tout, name).float().numpy(), (i, name))


def _check_trackers(config, jt, tt, where):
    for name in TRACKER_FIELDS:
        a = np.asarray(getattr(jt, name)).astype(np.float64)
        b = getattr(tt, name).float().numpy().astype(np.float64)
        tol = 1e-6 if config == "parity" else 1e-4
        np.testing.assert_allclose(b, a, atol=tol, rtol=0, err_msg=f"{where} {name}")


def _check_eye(config, a, b, where, max_steps=3):
    if config == "parity":
        steps = np.abs(a - b) * 255.0
        flipped = steps > 255.0 * 1e-5
        assert np.abs(steps - np.round(steps)).max() <= 255.0 * 1e-5, where
        assert steps.max() <= max_steps + 1e-3, (where, steps.max())
        assert flipped.mean() <= 1e-3, (where, flipped.mean())
    else:
        assert np.abs(a - b).mean() <= 1.0 / 255.0, where
        assert _ssim(a, b) >= 0.99, where


DOF_CASES = {"parity": ("parity", None), "shipped": ("shipped", None),
             "shipped_half_sbs": ("shipped", (H, W // 2))}
T_DOF = 4  # frames of the clip the DOF cases run (the focal tracker moves from the second)


@pytest.mark.parametrize("case", sorted(DOF_CASES))
def test_render_chunk_dof_matches_jax(case):
    config, warp_hw = DOF_CASES[case]
    kw = dict(CONFIGS[config], dof_strength=2.0, warp_hw=warp_hw)
    width = W if warp_hw is None else warp_hw[1]
    jp = JParams(**kw).with_shift_bound(width)
    tp = TParams(**{**kw, "warp_backend": kw.get("warp_backend", "auto")}).with_shift_bound(width)
    frames, depths = (a[:T_DOF] for a in _clip(seed=2))
    if config == "parity":  # op by op: no fused multiply-adds
        with jax.disable_jit():
            jt, jout = jrender_chunk(jp, jinit(H, W), jnp.asarray(frames), jnp.asarray(depths))
    else:
        jt, jout = jax.jit(lambda t, f, d: jrender_chunk(jp, t, f, d))(
            jinit(H, W), jnp.asarray(frames), jnp.asarray(depths))
    tt, tout = render_chunk(tp, tinit(H, W, device="cpu"), torch.from_numpy(frames),
                            torch.from_numpy(depths))
    _check_trackers(config, jt, tt, "chunk end")
    assert tout.left.shape == (T_DOF, H, width, 3)
    for name in ("left", "right", "focal_depth"):
        a = np.asarray(getattr(jout, name), np.float32)
        b = getattr(tout, name).float().numpy()
        if name == "focal_depth":
            np.testing.assert_allclose(b, a, atol=1e-6 if config == "parity" else 1e-4)
            continue
        for i in range(T_DOF):
            _check_eye(config, a[i], b[i], (i, name), max_steps=4)


def test_render_chunk_carries_trackers():
    """render_chunk over the clip equals the step loop, and its trackers
    carry across two chunks."""
    p = TParams().with_shift_bound(W)
    frames, depths = (torch.from_numpy(a) for a in _clip(seed=1))
    t_all, out_all = render_chunk(p, tinit(H, W, device="cpu"), frames, depths)
    t_half, out_a = render_chunk(p, tinit(H, W, device="cpu"), frames[:4], depths[:4])
    t_half, out_b = render_chunk(p, t_half, frames[4:], depths[4:])
    assert out_all.left.shape == (T, H, W, 3)
    torch.testing.assert_close(torch.cat([out_a.left, out_b.left]), out_all.left,
                               atol=0, rtol=0)
    for f in dataclasses.fields(t_all):
        torch.testing.assert_close(getattr(t_half, f.name), getattr(t_all, f.name),
                                   atol=0, rtol=0)


def test_unported_dof_raises():
    """Depth of field is ported: the step runs it on the CPU. What still
    raises is asking for the kernel with CPU tensors, or a blur reach past
    the kernel's halo (dof_strength > 5)."""
    frame, depth = torch.rand(8, 8, 3), torch.rand(8, 8)
    _, out = stereo_frame_step(TParams(dof_strength=1.0), tinit(8, 8, device="cpu"), frame, depth)
    assert out.left.shape == (8, 8, 3)
    for dof_strength in (1.0, 5.5):
        with pytest.raises(ValueError):
            stereo_frame_step(TParams(dof_strength=dof_strength, dof_backend="cuda"),
                              tinit(8, 8, device="cpu"), frame, depth)


BLANK_CASES = {"parity": ("parity", None), "shipped": ("shipped", None),
               "shipped_half_sbs": ("shipped", (H, W // 2))}


@pytest.mark.parametrize("case", sorted(BLANK_CASES))
def test_blank_frame_passthrough(case):
    """A chunk with blank frames (1 and 2 of 5) through render_chunk on both
    sides, under the gates of test_stereo_step_matches_jax: every tracker
    after the chunk, both eyes of every frame. The floating-window and focal
    trackers must hold over the blank frames, the others still step (the
    convergence EMA and the bar easer too); a blank frame's two eyes are
    the warp-size source through the same side mask and sharpen, so they
    are equal, and a Half-SBS warp (half the eye's width) makes the source
    the resized frame."""
    config, warp_hw = BLANK_CASES[case]
    kw = dict(CONFIGS[config], warp_hw=warp_hw)
    width = W if warp_hw is None else warp_hw[1]
    jp = JParams(**kw).with_shift_bound(width)
    tp = TParams(**{**kw, "warp_backend": kw.get("warp_backend", "auto")}).with_shift_bound(width)
    frames, depths = (a[:5] for a in _clip(seed=3))
    blanks = np.array([False, True, True, False, False])
    if config == "parity":
        with jax.disable_jit():
            jt, jout = jrender_chunk(jp, jinit(H, W), jnp.asarray(frames), jnp.asarray(depths),
                                     jnp.asarray(blanks))
    else:
        jt, jout = jax.jit(lambda t, f, d, b: jrender_chunk(jp, t, f, d, b))(
            jinit(H, W), jnp.asarray(frames), jnp.asarray(depths), jnp.asarray(blanks))
    tt, tout = render_chunk(tp, tinit(H, W, device="cpu"), torch.from_numpy(frames),
                            torch.from_numpy(depths), torch.from_numpy(blanks))
    _check_trackers(config, jt, tt, "chunk end")
    assert tout.left.shape == (5, H, width, 3)
    for name in ("left", "right"):
        a = np.asarray(getattr(jout, name), np.float32)
        b = getattr(tout, name).float().numpy()
        for i in range(5):
            _check_eye(config, a[i], b[i], (i, name))
    for i in (1, 2):
        torch.testing.assert_close(tout.left[i], tout.right[i], atol=0, rtol=0)
    assert (tout.left[0] - tout.right[0]).abs().max() > 0.01
    # the frozen trackers against a run without blanks: frame 0 alone moves them
    t1, _ = render_chunk(tp, tinit(H, W, device="cpu"), torch.from_numpy(frames[:1]),
                         torch.from_numpy(depths[:1]))
    t3, _ = render_chunk(tp, tinit(H, W, device="cpu"), torch.from_numpy(frames[:3]),
                         torch.from_numpy(depths[:3]), torch.from_numpy(blanks[:3]))
    for name in ("fw_offset", "fw_counter", "focal", "focal_init"):
        torch.testing.assert_close(getattr(t3, name), getattr(t1, name), atol=0, rtol=0)
    assert not torch.equal(t3.conv_val, t1.conv_val)
    assert not torch.equal(t3.prev_depth, t1.prev_depth)
