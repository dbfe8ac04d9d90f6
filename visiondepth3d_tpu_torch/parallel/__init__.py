"""Multi-device execution over a list of torch devices (see ``mesh``):
segment data parallelism (``dp``), row bands with halo exchanges
(``halo``, the ``sp`` axis), Megatron splits of the ViT blocks (``tp``)
and the two-stage depth/stereo pipeline (``pp``)."""

from .dp import init_trackers_batch, render_chunk_spatial, render_segments, segment_bounds
from .halo import BandLayout, band_bounds, crop_halo_rows, halo_exchange_rows
from .mesh import AXES, Mesh, make_mesh, replicas, replicate
from .pp import TwoStagePipeline

__all__ = ["AXES", "Mesh", "make_mesh", "replicate", "replicas", "init_trackers_batch",
           "render_segments", "segment_bounds", "render_chunk_spatial", "TwoStagePipeline",
           "BandLayout", "band_bounds", "halo_exchange_rows", "crop_halo_rows"]
