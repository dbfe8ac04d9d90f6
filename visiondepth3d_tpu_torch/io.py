"""Media I/O of the port.

The JAX package's ``io`` subpackage, shared rather than copied: it uses
numpy and the small C++ y4m library (``visiondepth3d_tpu/native``, built
with g++ at first use), and neither it nor ``visiondepth3d_tpu/__init__.py``
imports jax.
"""

from visiondepth3d_tpu.io.depth_io import open_depth_reader
from visiondepth3d_tpu.io.video import open_video, open_writer
from visiondepth3d_tpu.io.y4m import Y4MPlaneReader, Y4MReader, Y4MWriter

__all__ = ["open_depth_reader", "open_video", "open_writer", "Y4MPlaneReader",
           "Y4MReader", "Y4MWriter"]
