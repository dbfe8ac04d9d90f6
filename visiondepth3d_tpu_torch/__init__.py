"""VisionDepth3D on PyTorch and CUDA: the 2D->3D render path and the frame
tools for one GPU.

The port of ``visiondepth3d_tpu`` (the JAX package, kept as the reference
the port is tested against). It imports torch and numpy, never jax and
nothing of the JAX package:

- ``io``        media I/O: y4m (its own copy of the C++ library, built with
                g++ at first use), ffmpeg pipes, depth streams;
- ``ops``       per-frame stereo math and resampling as tensor functions;
- ``kernels``   hand-written CUDA kernels (sm_90a) for the warp, the
                feather + heal pass, the two depth statistics and the 3x3
                conv, each beside its plain PyTorch version;
- ``state``     the cross-frame EMA trackers;
- ``stereo``    the per-frame DIBR step and the chunk loop;
- ``depth``     Depth Anything V2 (DINOv2 + DPT) as ``nn.Module``s;
- ``enhance``   the frame tools: Real-ESRGAN (RRDBNet) and RIFE (IFNet);
- ``pipeline``  the fused render route, video in -> packed 3D video out;
- ``utils``     the ONNX initializer reader;
- ``preview``   single-frame diagnostic renders, the session-file watch
                loop and its web page;
- ``serve``     the web control surface: a job server over every route;
- ``cli``       ``vd3d-torch``: every subcommand of ``vd3d`` but ``bench``.

Entry points run on the CUDA card unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
