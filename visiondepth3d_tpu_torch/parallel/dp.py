"""Frame-level data parallelism: segment-parallel video rendering.

Counterpart of ``visiondepth3d_tpu/parallel/dp.py``. The EMA trackers make
frames sequential, so the data-parallel scheme that keeps their local
semantics cuts the video into G contiguous segments, gives each ``dp``
device one segment, and runs the stereo step on each segment on its own
(each segment's trackers warm up from scratch, exactly like starting a
render at a scene boundary). Segment boundaries snap to scene cuts when
they are known, so the warm-up lands on a cut.

Where the JAX package vmaps the chunk over the segment axis under a ``dp``
sharding, each segment here runs on its device in turn: every segment's
launches are enqueued before any result is read, so distinct cards
overlap. ``render_chunk_spatial`` splits a chunk's frame rows over the
``sp`` axis instead (``stereo/bands.py``).
"""

from __future__ import annotations

import torch

from ..state import StereoTrackers, init_trackers
from ..stereo import StereoParams
from ..stereo.step import StereoFrameOut, render_chunk
from .halo import BandLayout
from .mesh import Mesh


def _segment_devices(g: int, mesh: Mesh | None, default) -> list[torch.device]:
    if mesh is None:
        return [torch.device(default)] * g
    devs = [mesh.devices[i % mesh.shape["dp"], 0, 0] for i in range(g)]
    return [torch.device(d) for d in devs]


def init_trackers_batch(g: int, height: int, width: int, devices="cpu") -> list[StereoTrackers]:
    """G fresh tracker states; ``devices``: one device for all, or a list of
    G (segment g's trackers live on devices[g])."""
    if not isinstance(devices, (list, tuple)):
        devices = [devices] * g
    if len(devices) != g:
        raise ValueError(f"{len(devices)} devices for {g} segments")
    return [init_trackers(height, width, device=torch.device(d)) for d in devices]


def render_segments(params: StereoParams, trackers: list[StereoTrackers],
                    frames: torch.Tensor, depths: torch.Tensor, mesh: Mesh | None = None):
    """Render G contiguous segments: frames [G, T, H, W, 3], depths [G, T, H,
    W]; segment g runs on the mesh's dp device g (on the inputs' device
    without a mesh), its trackers moved there. Returns (G trackers, G
    StereoFrameOut), each on its segment's device."""
    g = frames.shape[0]
    if len(trackers) != g or depths.shape[0] != g:
        raise ValueError(f"{len(trackers)} trackers, {g} frame and {depths.shape[0]} depth "
                         f"segments")
    if mesh is not None and g != mesh.shape["dp"]:
        raise ValueError(f"{g} segments on a dp={mesh.shape['dp']} mesh")
    new_tr: list[StereoTrackers] = []
    outs: list[StereoFrameOut] = []
    for i, dev in enumerate(_segment_devices(g, mesh, frames.device)):
        tr = trackers[i].replace(**{k: v.to(dev, non_blocking=True)
                                    for k, v in vars(trackers[i]).items()})
        t, out = render_chunk(params, tr, frames[i].to(dev, non_blocking=True),
                              depths[i].to(dev, non_blocking=True))
        new_tr.append(t)
        outs.append(out)
    return new_tr, outs


def segment_bounds(total_frames: int, g: int,
                   scene_cuts: list[int] | None = None) -> list[tuple[int, int]]:
    """Split [0, total) into G contiguous spans, snapping to scene cuts when
    they are within 10% of the even split point."""
    even = [round(i * total_frames / g) for i in range(g + 1)]
    if scene_cuts:
        tol = max(1, total_frames // (g * 10))
        for i in range(1, g):
            best = min(scene_cuts, key=lambda c: abs(c - even[i]), default=None)
            if best is not None and abs(best - even[i]) <= tol:
                even[i] = best
    return [(even[i], even[i + 1]) for i in range(g)]


def spatial_layout(params: StereoParams, height: int, width: int, mesh: Mesh,
                   segment: int = 0) -> BandLayout:
    """The row bands of a [height, width] frame over segment ``segment``'s
    ``sp`` devices, with the stereo step's halo."""
    from ..stereo.bands import stereo_halo

    return BandLayout.make(height, list(mesh.devices[segment, :, 0]), stereo_halo(params),
                           width)


def render_chunk_spatial(params: StereoParams, trackers, frames: torch.Tensor,
                         depths: torch.Tensor, mesh: Mesh, blanks: torch.Tensor | None = None):
    """A stereo chunk with frame rows split over the first segment's ``sp``
    devices: frames [T, H, W, 3], depths [T, H, W]. ``trackers``: a
    ``stereo.bands.BandTrackers`` of ``spatial_layout``'s bands
    (``stereo.bands.init_band_trackers``). Equal to ``render_chunk`` on the
    whole frames. Returns (trackers, StereoFrameOut on the lead device)."""
    from ..stereo.bands import render_chunk_bands

    layout = spatial_layout(params, frames.shape[1], frames.shape[2], mesh)
    return render_chunk_bands(params, trackers, frames, depths, layout, blanks)
