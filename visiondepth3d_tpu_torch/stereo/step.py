"""The per-frame DIBR step and the chunk loop.

Counterpart of ``visiondepth3d_tpu/stereo/step.py``. Stage order: temporal
smooth, percentile-EMA normalization, shift smoother and dynamic parallax,
curvature, subject estimate, Pop-Control shaping, shift map with edge-mask
suppression, dual-eye warp, feather + heal, focal tracking and depth of
field, color grade, the blank-frame passthrough, floating-window bars,
sharpen. ``render_chunk`` runs the step frame by frame over a chunk,
carrying the trackers (a Python loop in place of ``lax.scan``); nothing in
the loop reads a device value on the host.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..kernels import dof as kdof
from ..kernels import postfx as kpostfx
from ..kernels import warp as kwarp
from ..ops import convert, dof, edges, filters, formats, grade, subject
from ..ops.depth_shaping import enhance_curvature, shape_depth_for_pop
from ..ops.resize import resize_bilinear
from ..state import trackers as trk
from .params import StereoParams

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class StereoFrameOut(NamedTuple):
    left: torch.Tensor  # [H, W, 3] float RGB in [0, 1]
    right: torch.Tensor
    shift_map: torch.Tensor  # [H, W] normalized disparity applied
    subject_depth: torch.Tensor  # scalar, post-shaping subject estimate
    focal_depth: torch.Tensor  # scalar, stabilized focal plane


def _maybe_quantize(x: torch.Tensor, p: StereoParams) -> torch.Tensor:
    return convert.quantize_u8(x) if p.parity_quantize else x


def compute_shift_map(p: StereoParams, t: trk.StereoTrackers, shaped: torch.Tensor,
                      subject_depth: torch.Tensor, fg, mg, bg):
    """Layer-weighted disparity with subject-anchored zero parallax."""
    width = shaped.shape[-1]
    half_width = width / 2.0
    fg_weight = torch.clamp((1.0 - shaped) ** 1.5, 0.0, 1.0)
    mg_weight = torch.clamp(1.0 - torch.abs(shaped - p.depth_pop_mid) * 3.0, 0.0, 1.0)
    bg_weight = torch.clamp(shaped, 0.0, 1.0)
    raw_shift = (fg_weight * fg * p.fg_pop_multiplier + mg_weight * mg
                 + bg_weight * bg * p.bg_push_multiplier)
    total_shift = (raw_shift * p.parallax_balance) / half_width

    if p.use_subject_tracking:
        adjusted = subject_depth * p.parallax_balance
        zero_parallax = ((-adjusted * fg * p.fg_pop_multiplier) + (-adjusted * mg)
                         + (adjusted * bg * p.bg_push_multiplier)) / half_width
        zero_parallax = zero_parallax * p.subject_lock_strength
        zero_parallax = zero_parallax - p.zero_parallax_strength
        if p.enable_floating_window:
            subject_weight = torch.clamp(1.0 - subject_depth * 2.0, 0.5, 1.0)
            zero_parallax = torch.clamp(zero_parallax * subject_weight, -0.35, 0.35)
            t, zero_parallax = trk.floating_window_update(t, zero_parallax, alpha=0.97,
                                                          threshold=0.0015)
        total_shift = total_shift - zero_parallax

    max_shift_norm = (width * p.max_pixel_shift_percent) / half_width
    total_shift = torch.clamp(total_shift, -max_shift_norm, max_shift_norm)
    # a convergence strength of exactly 0 is a no-op either way
    if p.enable_dynamic_convergence:
        convergence_bias = subject_depth * p.convergence_strength
    else:
        convergence_bias = p.convergence_strength
    total_shift = total_shift - convergence_bias / half_width

    if p.enable_edge_masking:
        mask_strength = min(max(p.feather_strength / 10.0, 0.05), 0.3)
        suppressed = edges.suppress_artifacts_with_edge_mask(shaped, total_shift,
                                                             p.feather_strength)
        return t, (1.0 - mask_strength) * total_shift + mask_strength * suppressed
    return t, total_shift


def _dispatch_warp(p: StereoParams, frame, shaped, final_shift):
    """"auto": the CUDA kernel for CUDA tensors, the plain version for CPU."""
    if p.warp_backend == "auto":
        return kwarp.stereo_warp(frame, shaped, final_shift, p.max_shift_px_bound)
    if p.warp_backend == "cuda":
        return kwarp.stereo_warp_cuda(frame, shaped, final_shift, p.max_shift_px_bound)
    if p.warp_backend == "torch":
        return kwarp.stereo_warp_torch(frame, shaped, final_shift, p.max_shift_px_bound)
    return kwarp.stereo_warp_torch(frame, shaped, final_shift, None)


def _dispatch_postfx(p: StereoParams, left, right, frame_i, dleft, dright):
    """Feather + heal: "auto" runs the CUDA kernel for CUDA tensors."""
    if not (p.enable_feathering or p.enable_healing):
        return left, right
    kw = dict(blur_ksize=p.blur_ksize, feather_strength=p.feather_strength,
              heal_strength=p.heal_strength, enable_feathering=p.enable_feathering,
              enable_healing=p.enable_healing)
    fn = {"auto": kpostfx.feather_heal, "cuda": kpostfx.feather_heal_cuda,
          "torch": kpostfx.feather_heal_torch}[p.postfx_backend]
    return fn(left, right, frame_i, dleft, dright, **kw)


def _dispatch_dof(p: StereoParams, left, right, depth_w, focal):
    """Depth of field on both eyes. Returns (left, right, graded): the
    kernel applies the color grade too, the plain ops leave it to the
    caller. "auto" runs the kernel for CUDA tensors."""
    if p.dof_backend == "cuda" or (p.dof_backend == "auto" and left.device.type == "cuda"):
        left, right = kdof.dof_grade_cuda(
            left, right, depth_w, focal, p.dof_strength, p.dof_focus_width, p.dof_levels,
            saturation=p.color_saturation, contrast=p.color_contrast,
            brightness=p.color_brightness)
        return left, right, True
    left, right = (dof.apply_dof(eye, depth_w, focal, p.dof_strength, p.dof_focus_width,
                                 p.dof_levels) for eye in (left, right))
    return left, right, False


def pixel_shift(p: StereoParams, t: trk.StereoTrackers, frame: torch.Tensor,
                depth: torch.Tensor, fg, mg, bg):
    """The DIBR core. frame: [H, W, 3], depth: [H, W].
    Returns (trackers, left, right, shift_map, subject_depth, frame_w): the
    last is the frame at the warp size in the image type, the source of the
    blank-frame passthrough."""
    if p.warp_hw is not None and tuple(p.warp_hw) != tuple(frame.shape[:2]):
        frame = resize_bilinear(frame, tuple(p.warp_hw))
        depth = resize_bilinear(depth, tuple(p.warp_hw))
    if p.enable_curvature:
        depth = enhance_curvature(depth, p.curvature_strength)
    depth = torch.clamp(depth, 0.0, 1.0)

    subj_raw = subject.estimate_subject_depth(depth, p.quantile_mode)
    shaped = shape_depth_for_pop(
        depth, subj_raw, stretch_lo=p.depth_stretch_lo, stretch_hi=p.depth_stretch_hi,
        depth_mid=p.depth_pop_mid, gamma=p.depth_pop_gamma,
        quantile_mode=p.quantile_mode)
    subject_depth = subject.estimate_subject_depth(shaped, p.quantile_mode)
    t, final_shift = compute_shift_map(p, t, shaped, subject_depth, fg, mg, bg)
    # image-plane ops run in p.image_dtype; the shift map and all depth
    # statistics above stay float32
    img_dt = _DTYPES[p.image_dtype]
    frame_i = frame.to(img_dt)
    left, right, dleft, dright = _dispatch_warp(p, frame_i, shaped.to(img_dt), final_shift)
    left, right = _dispatch_postfx(p, left, right, frame_i, dleft, dright)
    return t, left, right, final_shift, subject_depth, frame_i


def stereo_frame_step(p: StereoParams, t: trk.StereoTrackers, frame: torch.Tensor,
                      depth01: torch.Tensor, is_blank: torch.Tensor | None = None):
    """One frame through the stereo stage. frame: [H, W, 3] float RGB in
    [0, 1]; depth01: [H, W] in [0, 1]; is_blank: an optional 0-d bool
    tensor. A blank frame sends the warp-size source through both eyes and
    keeps the floating-window and focal trackers at their input values; the
    other trackers update as on any frame. Returns (trackers,
    StereoFrameOut)."""
    t_in = t

    t, depth_s = trk.temporal_depth_smooth(t, depth01, alpha=0.5)
    t, depth_n = trk.percentile_ema_normalize(t, depth_s, 0.02, 0.98, 0.92, p.quantile_mode)

    t, (fg, mg, bg) = trk.shift_smoother_update(t, p.fg_shift, p.mg_shift, p.bg_shift,
                                                alpha=0.15)
    dyn = (subject.dynamic_parallax_scale(depth_n, 0.90, 1.15)
           if p.enable_dynamic_parallax else 1.0)
    ipd = 1.0 if p.ipd_factor == 0.0 else p.ipd_factor
    fg, mg, bg = fg * dyn * ipd, mg * dyn * ipd, bg * dyn * ipd

    t, left, right, shift_map, subj, frame_w = pixel_shift(p, t, frame, depth_n, fg, mg, bg)
    left = _maybe_quantize(left, p)
    right = _maybe_quantize(right, p)

    candidate_focal = subject.estimate_subject_depth(depth_n, p.quantile_mode)
    motion = torch.where(t.initialized,
                         subject.motion_metric(t_in.prev_norm_depth, depth_n), 0.0)
    t, focal = trk.focal_tracker_update(t, candidate_focal, motion)
    graded = False
    if p.dof_strength > 0.0:
        # DOF reads the normalized depth at the warp size (Half-SBS warps
        # at another width than the eye)
        depth_w = resize_bilinear(depth_n, tuple(left.shape[:2]))
        left, right, graded = _dispatch_dof(p, left, right, depth_w, focal)

    if not graded:
        left = grade.apply_color_grade(left, p.color_saturation, p.color_contrast,
                                       p.color_brightness)
        right = grade.apply_color_grade(right, p.color_saturation, p.color_contrast,
                                        p.color_brightness)
    left = _maybe_quantize(left, p)
    right = _maybe_quantize(right, p)

    if is_blank is not None:
        # a device bool through torch.where: no host sync, and the kernels
        # above ran as on any frame
        left = torch.where(is_blank, frame_w, left)
        right = torch.where(is_blank, frame_w, right)
        t = t.replace(**{name: torch.where(is_blank, getattr(t_in, name), getattr(t, name))
                         for name in ("fw_offset", "fw_counter", "focal", "focal_init")})

    # floating-window side masks: bar geometry at the warp-stage width
    width = left.shape[1]
    subj_window = candidate_focal
    raw_zero = (-subj_window * fg - subj_window * mg + subj_window * bg) / (width / 2.0 + 1e-6)
    t, stable_zero = trk.convergence_ema_update(t, raw_zero, alpha=0.97)
    if p.enable_floating_window and p.use_subject_tracking:
        raw_bar = torch.floor(torch.abs(stable_zero) * width * 0.75)
        t, eased = trk.bar_easer_update(t, raw_bar, alpha=0.85)
        bar_width = torch.clamp(eased, 0.0, 80.0)
        side_sign = torch.where(stable_zero > 0.005, 1.0,
                                torch.where(stable_zero < -0.005, -1.0, 0.0))
        left = formats.apply_side_mask(left, bar_width, side_sign)
        right = formats.apply_side_mask(right, bar_width, side_sign)

    left = _maybe_quantize(filters.sharpen(left, p.sharpness_factor), p)
    right = _maybe_quantize(filters.sharpen(right, p.sharpness_factor), p)

    t = t.replace(prev_norm_depth=depth_n,
                  initialized=torch.ones((), dtype=torch.bool, device=depth_n.device))
    return t, StereoFrameOut(left, right, shift_map, subj, focal)


def render_chunk(p: StereoParams, t: trk.StereoTrackers, frames: torch.Tensor,
                 depths: torch.Tensor, blanks: torch.Tensor | None = None):
    """The stereo step over a [T, H, W, 3] chunk with [T, H, W] depths and
    optional [T] bool ``blanks``, frame by frame (the trackers make the
    frames sequential). Returns (trackers, StereoFrameOut with a leading T
    axis)."""
    outs = []
    for i in range(frames.shape[0]):
        t, out = stereo_frame_step(p, t, frames[i], depths[i],
                                   None if blanks is None else blanks[i])
        outs.append(out)
    return t, StereoFrameOut(*(torch.stack(xs) for xs in zip(*outs)))
