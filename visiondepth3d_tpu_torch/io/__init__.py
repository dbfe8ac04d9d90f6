"""Media I/O of the port.

The port's own copies of ``visiondepth3d_tpu/io/{y4m,video,ffmpeg,depth_io,blackdetect,
letterbox}.py`` and of the C++ y4m library (``native/vd3d_media.cpp``), which
``y4m.py`` builds with g++ at first use into ``_build/``. Nothing here imports
the JAX package.
"""

from .blackdetect import detect_blank_frames, frame_is_blank
from .depth_io import (Depth16Reader, Depth16Writer, depth01_to_u16, normalize_to_u8,
                       open_depth_reader, save_depth_npz)
from .ffmpeg import have_ffmpeg, have_ffprobe, is_av1_encoded, validate_codec
from .letterbox import (LetterboxTracker, crop_by_bars, detect_letterbox_multiframe,
                        detect_letterbox_single, is_near_black_frame, is_scene_cut,
                        reinsert_bars)
from .video import open_video, open_writer
from .y4m import Y4MPlaneReader, Y4MReader, Y4MWriter

__all__ = ["detect_blank_frames", "frame_is_blank", "Depth16Reader", "Depth16Writer",
           "depth01_to_u16", "normalize_to_u8", "open_depth_reader", "save_depth_npz",
           "have_ffmpeg", "have_ffprobe", "is_av1_encoded", "validate_codec",
           "LetterboxTracker", "crop_by_bars", "detect_letterbox_multiframe",
           "detect_letterbox_single", "is_near_black_frame", "is_scene_cut", "reinsert_bars",
           "open_video", "open_writer", "Y4MPlaneReader", "Y4MReader", "Y4MWriter"]
