"""Hand-written CUDA kernels for Hopper (sm_90a), each beside its plain
PyTorch version.

| wrapper                      | source            | replaces (TPU kernel, ops/...)       |
| ---------------------------- | ----------------- | ------------------------------------ |
| ``warp.stereo_warp``         | csrc/warp.cu      | pallas_warp.py:stereo_warp_pallas    |
| ``postfx.feather_heal``      | csrc/postfx.cu    | pallas_postfx.py:feather_heal_pallas |
| ``stats.quantile_pair``      | csrc/stats.cu     | pallas_stats.py:quantile_pair_pallas |
| ``stats.subject_stats``      | csrc/stats.cu     | pallas_stats.py:subject_stats_pallas |
| ``conv.conv3x3``             | csrc/conv.cu      | pallas_conv.py:conv3x3_pallas        |
| ``dof.dof_grade``            | csrc/dof.cu       | pallas_dof.py:dof_grade_pallas       |
| ``attention.vmem_attention`` | csrc/attention.cu | pallas_attention.py:vmem_attention   |

K3 and K4 have band forms for a frame held as row bands
(``stats.quantile_hist_band`` / ``quantile_pair_finish`` and
``stats.subject_hist_band`` / ``subject_stats_finish``, csrc/stats.cu).
Each dispatcher sends a CUDA tensor to the kernel and a CPU tensor to the
plain version (``*_torch``); there is no fallback from a failed build or
launch. The sources build at first use (``_lib.build_library``).
"""

from ._lib import KERNELS, build_library, launch_counts, reset_launch_counts

__all__ = ["KERNELS", "build_library", "launch_counts", "reset_launch_counts"]
