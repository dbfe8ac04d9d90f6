from .geometry import ASPECT_RATIOS, RenderGeometry, resolve_geometry
from .stereo_pipeline import RenderConfig, RenderProgress, make_chunk_fn, render_stereo_video
from .depth_pipeline import DepthConfig, render_depth_video_file
from .image_pipeline import process_image, process_images_in_folder, process_videos_in_folder
from .resume import clear_checkpoint, load_checkpoint, save_checkpoint

__all__ = ["ASPECT_RATIOS", "RenderGeometry", "resolve_geometry", "RenderConfig",
           "RenderProgress", "make_chunk_fn", "render_stereo_video", "DepthConfig",
           "render_depth_video_file", "process_image", "process_images_in_folder",
           "process_videos_in_folder", "clear_checkpoint", "load_checkpoint", "save_checkpoint"]
