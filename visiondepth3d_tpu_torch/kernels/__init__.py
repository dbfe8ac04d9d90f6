"""Hand-written CUDA kernels for Hopper (sm_90a), each beside its plain
PyTorch version.

| wrapper                        | source          | replaces (TPU kernel)                     |
| ------------------------------ | --------------- | ----------------------------------------- |
| ``warp.stereo_warp``           | csrc/warp.cu    | ops/pallas_warp.py:_warp_kernel           |
| ``postfx.feather_heal``        | csrc/postfx.cu  | ops/pallas_postfx.py:_postfx_kernel       |
| ``stats.quantile_pair``        | csrc/stats.cu   | ops/pallas_stats.py:_qpair_kernel         |
| ``stats.subject_stats``        | csrc/stats.cu   | ops/pallas_stats.py:_subject_kernel       |
| ``conv.conv3x3``               | csrc/conv.cu    | ops/pallas_conv.py:_conv3_kernel          |

Each dispatcher sends a CUDA tensor to the kernel and a CPU tensor to the
plain version (``*_torch``); there is no fallback from a failed build or
launch. The sources build at first use (``_lib.build_library``).
"""

from ._lib import KERNELS, build_library, launch_counts, reset_launch_counts

__all__ = ["KERNELS", "build_library", "launch_counts", "reset_launch_counts"]
