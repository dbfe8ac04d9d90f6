"""The banded plane layout of the stereo step (the ``sp`` mesh axis).

Counterpart of ``visiondepth3d_tpu/parallel/dp.py:render_chunk_spatial``,
where GSPMD partitions the jitted step over frame rows and inserts the halo
exchanges and the statistics' reductions itself. Here the step is the one
a frame on one device runs (``stereo/step.py:layout_step``), over
``RowBands``: a plane is a list of row bands, each a tensor on its device
(``parallel/halo.BandLayout``), and every exchange is written out. The
port's kernels are device-local, so K1, K2, K3/K4's band forms and K6 run
on each band.

- Every statistic is the whole frame's. K3's and K4's band forms count
  each band's own rows (K4's its share of the crop, in frame rows) into
  integer histograms, summed on the lead device and finished there: bit
  for bit the one-device statistics. The two float means (parallax,
  motion) concatenate the bands' row sums on the lead in band order and
  sum them, as the one-device forms do (``ops/subject.py``).
- The scalar trackers live on the lead (``BandTrackers.lead``); each
  frame-level scalar is copied to the band devices that need it. The
  [H, W] tracker planes stay row-sharded.
- The normalized depth is exchanged once per frame with the halo
  (``stereo_halo``: the reach of the edge mask, K2, K6 and the sharpen),
  and the frame's halo rows are split off the chunk once. From the
  curvature (each band with its slice of the frame's ramp) to the sharpen
  every stage runs on the padded bands, which are then cropped to their
  own rows. Edge bands have no outer halo, so the image border is treated
  exactly as on one device. The eyes and the shift map are gathered on the
  lead per chunk.
- A render whose warp size differs from the eye size (Half-SBS) resizes
  each frame's image and normalized depth to the warp size on the lead,
  the same op on the same whole plane as one device, and splits the result
  into warp-size bands: a resize mixes rows, and the whole-plane op keeps
  the output identical.
"""

from __future__ import annotations

import dataclasses

import torch

from ..kernels.dof import dof_reach
from ..ops import subject
from ..ops.depth_shaping import enhance_curvature
from ..ops.quantiles import quantile_pair_bands
from ..ops.resize import resize_bilinear
from ..parallel.halo import BandLayout, lead_cat
from ..state import trackers as trk
from .params import StereoParams
from .step import StereoFrameOut, layout_step


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


@dataclasses.dataclass(frozen=True)
class RowBands:
    """The banded plane layout of ``stereo.step``: a plane is a list of
    ``layout``'s row bands, each holding its own rows or, when ``padded``,
    its rows and their halo (the warp-size planes)."""

    layout: BandLayout
    padded: bool = False

    def map(self, fn, *planes):
        """fn band by band; a function that returns a tuple gives a tuple
        of planes."""
        out = [fn(*bands) for bands in zip(*planes)]
        return tuple(map(list, zip(*out))) if isinstance(out[0], tuple) else out

    def scalar(self, x):
        """x on every band's device (a Python value or None as it is)."""
        if isinstance(x, torch.Tensor):
            return self.layout.to_devices(x)
        return [x] * len(self.layout.devices)

    def crop(self, planes):
        return self.layout.crop(planes) if self.padded else planes

    def width(self, planes) -> int:
        return self.layout.width

    def _frame(self, planes):
        """A band form's arguments: each band's own rows, the frame row it
        starts at, the frame's height, the lead."""
        return (self.crop(planes), [r0 for r0, _ in self.layout.bounds], self.layout.height,
                self.layout.lead)

    def quantile_pair(self, planes, q, mode):
        return quantile_pair_bands(self.crop(planes), q, self.layout.lead, mode)

    def subject(self, planes, mode):
        return subject.estimate_subject_depth_bands(*self._frame(planes), mode)

    def parallax(self, planes, min_scale: float, max_scale: float):
        return subject.dynamic_parallax_scale_bands(*self._frame(planes), min_scale, max_scale)

    def motion(self, prev, curr):
        return subject.motion_metric_bands(prev, curr, self.layout.lead)

    def curvature(self, planes, strength: float):
        """The dome, each band with its rows' slice of the frame's ramp."""
        out = []
        for b, x in enumerate(planes):
            r0 = self.layout.padded_bounds(b)[0] if self.padded else self.layout.bounds[b][0]
            out.append(enhance_curvature(x, strength, r0, self.layout.height))
        return out

    def to_warp(self, p: StereoParams, eye: "RowBands", frame, depth):
        """At the eye size ``frame`` comes as padded bands; at another warp
        size it is the whole frame on the lead."""
        if self.layout is eye.layout:
            return frame, eye.layout.exchange(depth)
        hw = (self.layout.height, self.layout.width)
        return (self.layout.split(resize_bilinear(frame, hw), padded=True),
                self.layout.split(resize_bilinear(eye.layout.gather(depth), hw), padded=True))

    def trackers(self, bt: BandTrackers):
        return bt.lead, bt.prev_depth, bt.prev_norm_depth

    def pack(self, t: trk.StereoTrackers, prev_depth, prev_norm_depth) -> BandTrackers:
        return BandTrackers(t, prev_depth, prev_norm_depth)


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
    eye_planes, warp_planes = RowBands(eye), RowBands(warp, padded=True)
    outs = []
    for i in range(frames.shape[0]):
        frame = [f[i] for f in f_bands] if f_bands is not None else frames[i]
        bt, out = layout_step(p, eye_planes, warp_planes, bt, frame, [d[i] for d in d_bands],
                              None if blanks is None else blanks[i])
        outs.append(out)

    def gather(k):
        return lead_cat([torch.stack([getattr(o, k)[b] for o in outs])
                         for b in range(len(eye.devices))], eye.lead, dim=1)

    return bt, StereoFrameOut(gather("left"), gather("right"), gather("shift_map"),
                              torch.stack([o.subject_depth for o in outs]),
                              torch.stack([o.focal_depth for o in outs]))
