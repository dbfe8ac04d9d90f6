from .geometry import RenderGeometry, resolve_geometry
from .stereo_pipeline import RenderConfig, make_chunk_fn, render_stereo_video

__all__ = ["RenderGeometry", "resolve_geometry", "RenderConfig", "make_chunk_fn",
           "render_stereo_video"]
