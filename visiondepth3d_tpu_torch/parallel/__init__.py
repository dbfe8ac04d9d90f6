"""Multi-device execution over a list of torch devices (see ``mesh``):
segment data parallelism (``dp``) and the two-stage depth/stereo pipeline
(``pp``). Row sharding (``halo``) and tensor sharding (``tp``) are not
ported yet (ROADMAP Queue 1 item 6b)."""

from .dp import init_trackers_batch, render_chunk_spatial, render_segments, segment_bounds
from .mesh import AXES, Mesh, make_mesh, replicas, replicate
from .pp import TwoStagePipeline

__all__ = ["AXES", "Mesh", "make_mesh", "replicate", "replicas", "init_trackers_batch",
           "render_segments", "segment_bounds", "render_chunk_spatial", "TwoStagePipeline"]
