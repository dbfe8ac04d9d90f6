"""The stereo parameter schema.

Counterpart of ``visiondepth3d_tpu/stereo/params.py`` as a plain
dataclass: the same fields, defaults and meaning. Two dispatch fields take
the port's values:

- ``warp_backend``: "auto" (the CUDA kernel for CUDA tensors, the plain
  version for CPU tensors), "cuda" (the kernel; CUDA tensors only),
  "torch" (the plain shifted accumulation, or the gather without a bound),
  "gather" (the plain gather);
- ``postfx_backend``: "auto", "cuda" or "torch", the same way;
- ``dof_backend``: "auto" (the fused depth of field + grade kernel for CUDA
  tensors, the plain ``apply_dof`` per eye then the grade for CPU
  tensors), "cuda" (the kernel) or "torch" (the plain ops).
"""

from __future__ import annotations

import dataclasses
import math

WARP_BACKENDS = ("auto", "cuda", "torch", "gather")
POSTFX_BACKENDS = ("auto", "cuda", "torch")
DOF_BACKENDS = ("auto", "cuda", "torch")


@dataclasses.dataclass(frozen=True)
class StereoParams:
    fg_shift: float = 8.0
    mg_shift: float = -3.0
    bg_shift: float = -6.0
    sharpness_factor: float = 1.0
    feather_strength: float = 10.0
    max_pixel_shift_percent: float = 0.02
    parallax_balance: float = 0.8
    zero_parallax_strength: float = 0.0
    convergence_strength: float = 0.0
    ipd_factor: float = 1.0
    depth_pop_gamma: float = 0.85
    depth_pop_mid: float = 0.50
    depth_stretch_lo: float = 0.05
    depth_stretch_hi: float = 0.95
    fg_pop_multiplier: float = 1.20
    bg_push_multiplier: float = 1.10
    subject_lock_strength: float = 1.00
    color_saturation: float = 1.0
    color_contrast: float = 1.0
    color_brightness: float = 0.0
    heal_strength: float = 0.5
    curvature_strength: float = 0.08

    # warp-stage resize target; None keeps the input resolution
    warp_hw: tuple | None = None
    # bound (pixels) on the disparity magnitude, from with_shift_bound()
    max_shift_px_bound: int | None = None
    warp_backend: str = "auto"
    postfx_backend: str = "auto"
    dof_backend: str = "auto"
    blur_ksize: int = 9
    dof_strength: float = 0.0
    use_subject_tracking: bool = True
    enable_floating_window: bool = True
    enable_edge_masking: bool = True
    enable_feathering: bool = True
    enable_dynamic_convergence: bool = True
    enable_healing: bool = False
    enable_curvature: bool = True
    enable_dynamic_parallax: bool = True
    quantile_mode: str = "hist"
    # dtype of the image-plane ops; depth statistics, trackers and the
    # positional warp math always stay float32
    image_dtype: str = "float32"
    parity_quantize: bool = False
    dof_focus_width: float = 0.35
    dof_levels: int = 5

    def __post_init__(self):
        if self.warp_backend not in WARP_BACKENDS:
            raise ValueError(f"warp_backend {self.warp_backend!r} not in {WARP_BACKENDS}")
        if self.postfx_backend not in POSTFX_BACKENDS:
            raise ValueError(
                f"postfx_backend {self.postfx_backend!r} not in {POSTFX_BACKENDS}")
        if self.dof_backend not in DOF_BACKENDS:
            raise ValueError(f"dof_backend {self.dof_backend!r} not in {DOF_BACKENDS}")
        if self.quantile_mode not in ("hist", "exact"):
            raise ValueError(f"quantile_mode {self.quantile_mode!r}")
        if self.image_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"image_dtype {self.image_dtype!r}")

    def replace(self, **kwargs) -> "StereoParams":
        return dataclasses.replace(self, **kwargs)

    def with_shift_bound(self, width: int) -> "StereoParams":
        """The disparity bound in pixels: the shift clamp (pct * width) plus
        a sub-pixel allowance for the convergence bias."""
        return self.replace(
            max_shift_px_bound=int(math.ceil(self.max_pixel_shift_percent * width)) + 2)


def pop_controls_locked_to_defaults(p: StereoParams) -> StereoParams:
    """``p`` with the reference render path's fixed pop constants (gamma
    0.85, mid 0.50, stretch 0.05 / 0.95, pop 1.20, push 1.10, subject lock
    1.00), for golden parity runs."""
    return p.replace(depth_pop_gamma=0.85, depth_pop_mid=0.50, depth_stretch_lo=0.05,
                     depth_stretch_hi=0.95, fg_pop_multiplier=1.20, bg_push_multiplier=1.10,
                     subject_lock_strength=1.00)
