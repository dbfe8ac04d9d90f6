from .params import StereoParams, pop_controls_locked_to_defaults
from .step import StereoFrameOut, pixel_shift, render_chunk, stereo_frame_step

__all__ = ["StereoParams", "pop_controls_locked_to_defaults", "StereoFrameOut", "pixel_shift",
           "render_chunk", "stereo_frame_step"]
