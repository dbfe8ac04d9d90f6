"""Media I/O of the port.

The port's own copies of ``visiondepth3d_tpu/io/{y4m,video,ffmpeg,depth_io,blackdetect}.py``
and of the C++ y4m library (``native/vd3d_media.cpp``), which ``y4m.py``
builds with g++ at first use into ``_build/``. Nothing here imports the JAX
package.
"""

from .depth_io import open_depth_reader
from .video import open_video, open_writer
from .y4m import Y4MPlaneReader, Y4MReader, Y4MWriter

__all__ = ["open_depth_reader", "open_video", "open_writer", "Y4MPlaneReader",
           "Y4MReader", "Y4MWriter"]
