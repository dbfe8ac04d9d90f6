"""The stereo step over row bands of the frame (the ``sp`` mesh axis).

Counterpart of ``visiondepth3d_tpu/parallel/dp.py:render_chunk_spatial``,
where GSPMD partitions the jitted step over frame rows and inserts the halo
exchanges and the statistics' reductions itself. Here each band is a
tensor on its device (``parallel/halo.BandLayout``) and every exchange is
written out; the port's kernels are device-local, so K1, K2, K3/K4's band
forms and K6 run on each band. Per frame:

1. The pointwise and tracker stages run on each band's own rows: the
   temporal filter, the percentile normalization, the dynamic parallax
   scale, the focal and motion statistics.
2. Every statistic is the whole frame's. K3's and K4's band forms count
   each band's rows (K4's its share of the crop, in frame rows) into
   integer histograms, summed on the lead device and finished there: bit
   for bit the one-device statistics. The two float means (parallax,
   motion) concatenate the bands' row sums on the lead in band order and
   sum them, as the one-device forms do (``ops/subject.py``).
3. The scalar trackers live on the lead; each frame-level scalar is copied
   to the band devices that need it. The [H, W] planes (``prev_depth``,
   ``prev_norm_depth``) stay row-sharded.
4. The normalized depth is exchanged once with the halo (``stereo_halo``:
   the reach of the edge mask, K2, K6 and the sharpen); the curvature
   (with the band's slice of the frame's ramp), the shaping, the shift map,
   K1, K2, the depth of field, the grade, the side masks and the sharpen
   run on the padded band, which is then cropped to its own rows. The
   frame's halo rows are split off the chunk once. Edge bands have no
   outer halo, so the image border is treated exactly as on one device.
5. The eyes and the shift map are gathered on the lead per chunk.

A render whose warp size differs from the eye size (Half-SBS) resizes each
frame's image and normalized depth to the warp size on the lead, the same
op on the same whole plane as one device, and splits the result into
warp-size bands: a resize mixes rows, and the whole-plane op keeps the
output identical.
"""

from __future__ import annotations

import dataclasses

import torch

from ..kernels.dof import dof_reach
from ..ops import filters, formats, subject
from ..ops.depth_shaping import enhance_curvature, shape_depth_apply
from ..ops.quantiles import quantile_pair_bands
from ..ops.resize import resize_bilinear
from ..parallel.halo import BandLayout, lead_cat
from ..state import trackers as trk
from .params import StereoParams
from .step import (_DTYPES, StereoFrameOut, _dispatch_dof, _dispatch_postfx, _dispatch_warp,
                   _maybe_quantize, color_grade, hold_on_blank, shift_plane, shift_scalars,
                   side_mask_terms)


def stereo_halo(p: StereoParams) -> int:
    """Rows a band needs from each neighbour: the reach of the stencil chain
    from the exchanged depth to the output (the edge mask's gradient and
    5 x 5 blur, K2's feather + heal, K6's blur stack, the sharpen)."""
    halo = 1  # sharpen
    if p.enable_edge_masking:
        halo += 3
    if p.enable_feathering or p.enable_healing:
        halo += 5 + p.blur_ksize // 2
    if p.dof_strength > 0.0:
        halo += dof_reach(p.dof_strength, p.dof_levels)
    return halo


@dataclasses.dataclass
class BandTrackers:
    """The trackers of a row-banded render: the scalars on the lead device
    (``lead``, whose planes are empty) and the [H, W] planes as bands."""

    lead: trk.StereoTrackers
    prev_depth: list
    prev_norm_depth: list


def init_band_trackers(layout: BandLayout, width: int) -> BandTrackers:
    lead = trk.init_trackers(0, width, device=layout.lead)

    def planes():
        return [torch.zeros((r1 - r0, width), dtype=torch.float32, device=d)
                for (r0, r1), d in zip(layout.bounds, layout.devices)]

    return BandTrackers(lead, planes(), planes())


def stereo_frame_step_bands(p: StereoParams, bt: BandTrackers, eye: BandLayout,
                            warp: BandLayout, frame_w: list, depth01: list,
                            is_blank: torch.Tensor | None = None):
    """``stereo_frame_step`` on a frame held as row bands. ``eye``: the
    bands at the eye size (``depth01``, each band's own rows); ``warp``: at
    the warp size (``frame_w``, each band padded with its halo; the same
    layout as ``eye`` unless the warp size differs). Returns (trackers,
    StereoFrameOut whose left, right and shift_map are lists of each band's
    own rows and whose scalars are on the lead)."""
    lead = eye.lead
    t = t_in = bt.lead

    def bands(x):
        return eye.to_devices(x) if isinstance(x, torch.Tensor) else [x] * len(eye.devices)

    row0s = [r0 for r0, _ in eye.bounds]
    init = bands(t.initialized)
    depth_s = [trk.smooth_plane(i, pd, d, 0.5)
               for i, pd, d in zip(init, bt.prev_depth, depth01)]
    d = [torch.clamp(x, 0.0, 1.0) for x in depth_s]
    q = quantile_pair_bands(d, (0.02, 0.98), lead, p.quantile_mode)
    t, lo, hi, degenerate = trk.percentile_ema_update(t, q[0], q[1], 0.92)
    depth_n = [trk.percentile_ema_apply(x, a, b, c)
               for x, a, b, c in zip(d, bands(lo), bands(hi), bands(degenerate))]

    t, (fg, mg, bg) = trk.shift_smoother_update(t, p.fg_shift, p.mg_shift, p.bg_shift,
                                                alpha=0.15)
    dyn = (subject.dynamic_parallax_scale_bands(depth_n, row0s, eye.height, lead, 0.90, 1.15)
           if p.enable_dynamic_parallax else 1.0)
    ipd = 1.0 if p.ipd_factor == 0.0 else p.ipd_factor
    fg, mg, bg = fg * dyn * ipd, mg * dyn * ipd, bg * dyn * ipd

    # the normalized depth at the warp size, each band with its halo
    if warp is eye:
        depth_w = eye.exchange(depth_n)
    else:
        depth_w = warp.split(resize_bilinear(eye.gather(depth_n), (warp.height, warp.width)),
                             padded=True)

    # pixel_shift on the padded bands; statistics on their own rows
    wrow0s = [r0 for r0, _ in warp.bounds]
    depth = depth_w
    if p.enable_curvature:
        depth = [enhance_curvature(x, p.curvature_strength, warp.padded_bounds(b)[0],
                                   warp.height) for b, x in enumerate(depth)]
    depth = [torch.clamp(x, 0.0, 1.0) for x in depth]
    subj_raw = subject.estimate_subject_depth_bands(warp.crop(depth), wrow0s, warp.height, lead,
                                                    p.quantile_mode)
    dc = [torch.clamp(x, 0.0, 1.0) for x in depth]
    q = quantile_pair_bands(warp.crop(dc), (p.depth_stretch_lo, p.depth_stretch_hi), lead,
                            p.quantile_mode)
    shaped = [shape_depth_apply(x, a, b, s, depth_mid=p.depth_pop_mid, gamma=p.depth_pop_gamma)
              for x, a, b, s in zip(dc, bands(q[0]), bands(q[1]), bands(subj_raw))]
    subject_depth = subject.estimate_subject_depth_bands(warp.crop(shaped), wrow0s, warp.height,
                                                         lead, p.quantile_mode)
    t, zero_parallax, convergence = shift_scalars(p, t, subject_depth, fg, mg, bg, warp.width)
    final_shift = [shift_plane(p, s, *args) for s, *args in
                   zip(shaped, bands(fg), bands(mg), bands(bg), bands(zero_parallax),
                       bands(convergence))]
    img_dt = _DTYPES[p.image_dtype]
    frame_i = [f.to(img_dt) for f in frame_w]
    left, right = [], []
    for f, s, sh in zip(frame_i, shaped, final_shift):
        el, er, dl, dr = _dispatch_warp(p, f, s.to(img_dt), sh)
        el, er = _dispatch_postfx(p, el, er, f, dl, dr)
        left.append(_maybe_quantize(el, p))
        right.append(_maybe_quantize(er, p))

    candidate_focal = subject.estimate_subject_depth_bands(depth_n, row0s, eye.height, lead,
                                                           p.quantile_mode)
    motion = torch.where(t.initialized,
                         subject.motion_metric_bands(bt.prev_norm_depth, depth_n, lead), 0.0)
    t, focal = trk.focal_tracker_update(t, candidate_focal, motion)
    graded = False
    if p.dof_strength > 0.0:
        done = [_dispatch_dof(p, a, b, dw, f)
                for a, b, dw, f in zip(left, right, depth_w, bands(focal))]
        left, right, graded = [x[0] for x in done], [x[1] for x in done], done[0][2]
    if not graded:
        left, right = [color_grade(p, x) for x in left], [color_grade(p, x) for x in right]
    left = [_maybe_quantize(x, p) for x in left]
    right = [_maybe_quantize(x, p) for x in right]

    if is_blank is not None:
        blank = bands(is_blank)
        left = [torch.where(k, f, x) for k, f, x in zip(blank, frame_i, left)]
        right = [torch.where(k, f, x) for k, f, x in zip(blank, frame_i, right)]
        t = hold_on_blank(t, t_in, is_blank)

    t, bars = side_mask_terms(p, t, candidate_focal, fg, mg, bg, warp.width)
    if bars is not None:
        bw, ss = bands(bars[0]), bands(bars[1])
        left = [formats.apply_side_mask(x, a, b) for x, a, b in zip(left, bw, ss)]
        right = [formats.apply_side_mask(x, a, b) for x, a, b in zip(right, bw, ss)]

    left = warp.crop([_maybe_quantize(filters.sharpen(x, p.sharpness_factor), p) for x in left])
    right = warp.crop([_maybe_quantize(filters.sharpen(x, p.sharpness_factor), p)
                       for x in right])

    t = t.replace(initialized=torch.ones((), dtype=torch.bool, device=lead))
    bt = BandTrackers(t, depth_s, depth_n)
    return bt, StereoFrameOut(left, right, warp.crop(final_shift), subject_depth, focal)


def render_chunk_bands(p: StereoParams, bt: BandTrackers, frames: torch.Tensor, depths,
                       eye: BandLayout, blanks: torch.Tensor | None = None):
    """``render_chunk`` with frame rows in the bands of ``eye``: frames
    [T, H, W, 3] and optional [T] bool blanks (on the lead in the renders);
    depths [T, H, W], or a list of frame groups [T_g, H, W] (the chunk's
    frames in order, each group on the device that inferred it). Each band
    takes its rows straight from where they are. Returns (trackers,
    StereoFrameOut with a leading T axis, on the lead)."""
    h, w = frames.shape[1:3]
    warp_hw = tuple(p.warp_hw) if p.warp_hw is not None else (h, w)
    warp = eye if warp_hw == (h, w) else BandLayout.make(warp_hw[0], eye.devices, eye.halo,
                                                         warp_hw[1])
    groups = list(depths) if isinstance(depths, (list, tuple)) else [depths]
    d_bands = [torch.cat([g[:, r0:r1].to(dev, non_blocking=True) for g in groups])
               for (r0, r1), dev in zip(eye.bounds, eye.devices)]
    f_bands = warp.split(frames, h_axis=1, padded=True) if warp is eye else None
    outs = []
    for i in range(frames.shape[0]):
        fw = ([f[i] for f in f_bands] if f_bands is not None
              else warp.split(resize_bilinear(frames[i], warp_hw), padded=True))
        bt, out = stereo_frame_step_bands(p, bt, eye, warp, fw, [d[i] for d in d_bands],
                                          None if blanks is None else blanks[i])
        outs.append(out)

    def gather(k):
        return lead_cat([torch.stack([getattr(o, k)[b] for o in outs])
                         for b in range(len(eye.devices))], eye.lead, dim=1)

    return bt, StereoFrameOut(gather("left"), gather("right"), gather("shift_map"),
                              torch.stack([o.subject_depth for o in outs]),
                              torch.stack([o.focal_depth for o in outs]))
