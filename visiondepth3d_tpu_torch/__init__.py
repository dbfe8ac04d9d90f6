"""VisionDepth3D on PyTorch and CUDA: the 2D->3D render path for one GPU.

The port of ``visiondepth3d_tpu`` (the JAX package, kept as the reference
the port is tested against). It imports torch and numpy, never jax:

- ``ops``       per-frame stereo math as plain tensor functions;
- ``kernels``   hand-written CUDA kernels (sm_90a) for the warp, the
                feather + heal pass and the two depth statistics, each
                beside its plain PyTorch version;
- ``state``     the cross-frame EMA trackers;
- ``stereo``    the per-frame DIBR step and the chunk loop;
- ``depth``     Depth Anything V2 (DINOv2 + DPT) as ``nn.Module``s;
- ``pipeline``  the fused render route, video in -> packed 3D video out;
- ``cli``       ``vd3d-torch render``.

Media I/O (``io``) is the JAX package's ``visiondepth3d_tpu.io``, shared:
it uses numpy and a small C++ library, not jax.
"""

__version__ = "0.1.0"
