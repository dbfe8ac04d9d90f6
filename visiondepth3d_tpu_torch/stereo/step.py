"""The per-frame DIBR step and the chunk loop.

Counterpart of ``visiondepth3d_tpu/stereo/step.py``. Stage order: temporal
smooth, percentile-EMA normalization, shift smoother and dynamic parallax,
curvature, subject estimate, Pop-Control shaping, shift map with edge-mask
suppression, dual-eye warp, feather + heal, focal tracking and depth of
field, color grade, the blank-frame passthrough, floating-window bars,
sharpen. ``layout_step`` writes that order once, over plane layouts that
hold what differs between a frame on one device (``WholeFrame``: a plane
is one tensor, the one-device ops) and a frame in row bands
(``stereo/bands.py:RowBands``). ``render_chunk`` runs the step frame by
frame over a chunk, carrying the trackers (a Python loop in place of
``lax.scan``); nothing in the loop reads a device value on the host.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import torch

from ..kernels import dof as kdof
from ..kernels import postfx as kpostfx
from ..kernels import warp as kwarp
from ..ops import convert, dof, edges, filters, formats, grade
from ..ops.depth_shaping import enhance_curvature, shape_depth_apply
from ..ops.quantiles import quantile_01
from ..ops.resize import resize_bilinear
from ..ops.subject import dynamic_parallax_scale, estimate_subject_depth, motion_metric
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
    t, zero_parallax, convergence = shift_scalars(p, t, subject_depth, fg, mg, bg,
                                                  shaped.shape[-1])
    return t, shift_plane(p, shaped, fg, mg, bg, zero_parallax, convergence)


def shift_scalars(p: StereoParams, t: trk.StereoTrackers, subject_depth: torch.Tensor,
                  fg, mg, bg, width: int):
    """The frame-level terms of the shift map: (trackers, the zero-parallax
    offset or None without subject tracking, the convergence term)."""
    half_width = width / 2.0
    zero_parallax = None
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
    # a convergence strength of exactly 0 is a no-op either way
    if p.enable_dynamic_convergence:
        convergence_bias = subject_depth * p.convergence_strength
    else:
        convergence_bias = p.convergence_strength
    return t, zero_parallax, convergence_bias / half_width


def shift_plane(p: StereoParams, shaped: torch.Tensor, fg, mg, bg, zero_parallax,
                convergence) -> torch.Tensor:
    """The per-pixel shift map of ``shaped`` (a frame or a row band of it)
    from the frame-level terms of ``shift_scalars``."""
    width = shaped.shape[-1]
    half_width = width / 2.0
    fg_weight = torch.clamp((1.0 - shaped) ** 1.5, 0.0, 1.0)
    mg_weight = torch.clamp(1.0 - torch.abs(shaped - p.depth_pop_mid) * 3.0, 0.0, 1.0)
    bg_weight = torch.clamp(shaped, 0.0, 1.0)
    raw_shift = (fg_weight * fg * p.fg_pop_multiplier + mg_weight * mg
                 + bg_weight * bg * p.bg_push_multiplier)
    total_shift = (raw_shift * p.parallax_balance) / half_width
    if zero_parallax is not None:
        total_shift = total_shift - zero_parallax
    max_shift_norm = (width * p.max_pixel_shift_percent) / half_width
    total_shift = torch.clamp(total_shift, -max_shift_norm, max_shift_norm)
    total_shift = total_shift - convergence

    if p.enable_edge_masking:
        mask_strength = min(max(p.feather_strength / 10.0, 0.05), 0.3)
        suppressed = edges.suppress_artifacts_with_edge_mask(shaped, total_shift,
                                                             p.feather_strength)
        return (1.0 - mask_strength) * total_shift + mask_strength * suppressed
    return total_shift


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


def _clamp01(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x, 0.0, 1.0)


def _dof_grade(p: StereoParams, left, right, depth_w, focal):
    """Depth of field and the color grade of both eyes."""
    left, right, graded = _dispatch_dof(p, left, right, depth_w, focal)
    if graded:
        return left, right
    return color_grade(p, left), color_grade(p, right)


class WholeFrame:
    """The one-device plane layout: a plane is one tensor ([H, W] or
    [H, W, 3]), a frame-level value stays where it is, and the statistics
    are the one-device ops."""

    quantile_pair = staticmethod(quantile_01)
    subject = staticmethod(estimate_subject_depth)
    parallax = staticmethod(dynamic_parallax_scale)
    motion = staticmethod(motion_metric)
    curvature = staticmethod(enhance_curvature)

    def map(self, fn, *planes):
        return fn(*planes)

    def scalar(self, x):
        return x

    crop = scalar

    def width(self, plane) -> int:
        return plane.shape[1]

    def to_warp(self, p: StereoParams, eye, frame, depth):
        """The frame and the normalized depth at ``p.warp_hw`` (a resize to
        the size a plane has already returns it)."""
        hw = tuple(p.warp_hw or frame.shape[:2])
        return resize_bilinear(frame, hw), resize_bilinear(depth, hw)

    def trackers(self, t: trk.StereoTrackers):
        return t, t.prev_depth, t.prev_norm_depth

    def pack(self, t: trk.StereoTrackers, prev_depth, prev_norm_depth) -> trk.StereoTrackers:
        return t.replace(prev_depth=prev_depth, prev_norm_depth=prev_norm_depth)


def pixel_shift(p: StereoParams, t: trk.StereoTrackers, frame: torch.Tensor,
                depth: torch.Tensor):
    """The DIBR core at p's shifts. frame: [H, W, 3], depth: [H, W].
    Returns (trackers, left, right, shift_map, subject_depth)."""
    one = WholeFrame()
    return _pixel_shift(p, one, one, t, frame, depth, p.fg_shift, p.mg_shift, p.bg_shift)[:5]


def _pixel_shift(p: StereoParams, eye, lay, t: trk.StereoTrackers, frame, depth, fg, mg, bg):
    """``pixel_shift`` over ``layout_step``'s layouts (``lay`` the warp
    size's), at the shifts fg, mg, bg (floats, or 0-d tensors on the
    trackers' device). Returns (trackers, left, right, shift_map,
    subject_depth, frame_i, dof_depth): frame_i is the frame at the warp size
    in the image type, the source of the blank-frame passthrough; dof_depth
    the depth at the warp size, which the depth of field reads (None
    without it)."""
    frame, depth = lay.to_warp(p, eye, frame, depth)
    dof_depth = depth if p.dof_strength > 0.0 else None
    if p.enable_curvature:
        depth = lay.curvature(depth, p.curvature_strength)
    depth = lay.map(_clamp01, depth)

    subj_raw = lay.subject(depth, p.quantile_mode)
    # ops.depth_shaping.shape_depth_for_pop, at the whole frame's quantiles
    d = lay.map(_clamp01, depth)
    q = lay.quantile_pair(d, (p.depth_stretch_lo, p.depth_stretch_hi), mode=p.quantile_mode)
    shaped = lay.map(partial(shape_depth_apply, depth_mid=p.depth_pop_mid,
                             gamma=p.depth_pop_gamma),
                     d, lay.scalar(q[0]), lay.scalar(q[1]), lay.scalar(subj_raw))
    del d, q
    subject_depth = lay.subject(shaped, p.quantile_mode)
    t, zero_parallax, convergence = shift_scalars(p, t, subject_depth, fg, mg, bg,
                                                  lay.width(shaped))
    final_shift = lay.map(partial(shift_plane, p), shaped,
                          *map(lay.scalar, (fg, mg, bg, zero_parallax, convergence)))
    # image-plane ops run in p.image_dtype; the shift map and all depth
    # statistics above stay float32
    to_image = partial(torch.Tensor.to, dtype=_DTYPES[p.image_dtype])
    frame_i = lay.map(to_image, frame)
    left, right, dleft, dright = lay.map(partial(_dispatch_warp, p), frame_i,
                                         lay.map(to_image, shaped), final_shift)
    left, right = lay.map(partial(_dispatch_postfx, p), left, right, frame_i, dleft, dright)
    return t, left, right, final_shift, subject_depth, frame_i, dof_depth


def color_grade(p: StereoParams, x: torch.Tensor) -> torch.Tensor:
    return grade.apply_color_grade(x, p.color_saturation, p.color_contrast, p.color_brightness)


def stereo_frame_step(p: StereoParams, t: trk.StereoTrackers, frame: torch.Tensor,
                      depth01: torch.Tensor, is_blank: torch.Tensor | None = None):
    """One frame through the stereo stage. frame: [H, W, 3] float RGB in
    [0, 1]; depth01: [H, W] in [0, 1]; is_blank: an optional 0-d bool
    tensor. A blank frame sends the warp-size source through both eyes and
    keeps the floating-window and focal trackers at their input values; the
    other trackers update as on any frame. Returns (trackers,
    StereoFrameOut)."""
    one = WholeFrame()
    return layout_step(p, one, one, t, frame, depth01, is_blank)


def layout_step(p: StereoParams, eye, warp, t, frame, depth01, is_blank=None):
    """``stereo_frame_step`` over two plane layouts: ``eye`` holds the
    eye-size planes (``depth01``, the trackers' planes), ``warp`` the
    warp-size ones; ``frame`` is what ``warp.to_warp`` takes. Returns
    (trackers, StereoFrameOut of ``warp``'s planes, cropped)."""
    ts, prev_depth, prev_norm_depth = eye.trackers(t)
    t_in = ts

    quantize = partial(_maybe_quantize, p=p)

    def sharpen(x):
        return _maybe_quantize(filters.sharpen(x, p.sharpness_factor), p)

    depth_s = eye.map(partial(trk.smooth_plane, alpha=0.5), eye.scalar(ts.initialized),
                      prev_depth, depth01)
    d = eye.map(_clamp01, depth_s)
    q = eye.quantile_pair(d, (0.02, 0.98), mode=p.quantile_mode)
    ts, lo, hi, degenerate = trk.percentile_ema_update(ts, q[0], q[1], 0.92)
    depth_n = eye.map(trk.percentile_ema_apply, d, eye.scalar(lo), eye.scalar(hi),
                      eye.scalar(degenerate))
    # the clamped plane ends here, before the warp's planes are made: a
    # plane held longer moves the caching allocator's peak
    del d, q

    ts, (fg, mg, bg) = trk.shift_smoother_update(ts, p.fg_shift, p.mg_shift, p.bg_shift,
                                                 alpha=0.15)
    dyn = eye.parallax(depth_n, 0.90, 1.15) if p.enable_dynamic_parallax else 1.0
    ipd = 1.0 if p.ipd_factor == 0.0 else p.ipd_factor
    fg, mg, bg = fg * dyn * ipd, mg * dyn * ipd, bg * dyn * ipd

    ts, left, right, shift_map, subj, frame_i, depth_w = _pixel_shift(p, eye, warp, ts, frame,
                                                                      depth_n, fg, mg, bg)
    left, right = warp.map(quantize, left), warp.map(quantize, right)

    candidate_focal = eye.subject(depth_n, p.quantile_mode)
    motion = torch.where(ts.initialized, eye.motion(prev_norm_depth, depth_n), 0.0)
    ts, focal = trk.focal_tracker_update(ts, candidate_focal, motion)
    if p.dof_strength > 0.0:
        # DOF reads the normalized depth at the warp size (Half-SBS warps
        # at another width than the eye)
        left, right = warp.map(partial(_dof_grade, p), left, right, depth_w, warp.scalar(focal))
    else:
        grade_eye = partial(color_grade, p)
        left, right = warp.map(grade_eye, left), warp.map(grade_eye, right)
    left, right = warp.map(quantize, left), warp.map(quantize, right)

    if is_blank is not None:
        # a device bool through torch.where: no host sync, and the kernels
        # above ran as on any frame; the floating-window and focal
        # trackers keep their input values
        blank = warp.scalar(is_blank)
        left = warp.map(torch.where, blank, frame_i, left)
        right = warp.map(torch.where, blank, frame_i, right)
        ts = ts.replace(**{name: torch.where(is_blank, getattr(t_in, name), getattr(ts, name))
                           for name in ("fw_offset", "fw_counter", "focal", "focal_init")})

    # floating-window side masks: the convergence EMA and the bar easer, the
    # bar geometry at the warp-stage width
    width = warp.width(left)
    raw_zero = ((-candidate_focal * fg - candidate_focal * mg + candidate_focal * bg)
                / (width / 2.0 + 1e-6))
    ts, stable_zero = trk.convergence_ema_update(ts, raw_zero, alpha=0.97)
    if p.enable_floating_window and p.use_subject_tracking:
        raw_bar = torch.floor(torch.abs(stable_zero) * width * 0.75)
        ts, eased = trk.bar_easer_update(ts, raw_bar, alpha=0.85)
        bar_width = warp.scalar(torch.clamp(eased, 0.0, 80.0))
        side_sign = warp.scalar(torch.where(stable_zero > 0.005, 1.0,
                                            torch.where(stable_zero < -0.005, -1.0, 0.0)))
        left = warp.map(formats.apply_side_mask, left, bar_width, side_sign)
        right = warp.map(formats.apply_side_mask, right, bar_width, side_sign)

    left = warp.crop(warp.map(sharpen, left))
    right = warp.crop(warp.map(sharpen, right))
    ts = ts.replace(initialized=torch.ones((), dtype=torch.bool, device=ts.initialized.device))
    return (eye.pack(ts, depth_s, depth_n),
            StereoFrameOut(left, right, warp.crop(shift_map), subj, focal))


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
