"""Per-frame stereo math as plain PyTorch tensor functions.

The names the JAX package's ``ops`` exports, at the same path. Importing
this package builds no kernel: the wrappers in ``kernels/`` build theirs at
the first launch on a CUDA tensor.
"""

from .convert import (bgr_to_rgb, depth_frame_to_01, float_to_u8_round, float_to_u8_trunc,
                      quantize_u8, rgb_to_gray, u8_to_float)
from .depth_shaping import enhance_curvature, midtone_shape, shape_depth_for_pop, signed_pow
from .dof import apply_dof
from .edges import feather_shift_edges, heal_missing_pixels, suppress_artifacts_with_edge_mask
from .filters import box_blur, forward_diff_grad, gaussian_blur, grad_magnitude, sharpen
from .formats import (FORMATS, anaglyph_red_cyan, apply_side_mask, format_3d_output,
                      interlaced, pack_per_eye)
from .grade import apply_color_grade
from .quantiles import (exact_masked_median, exact_quantile, hist_quantile, histogram_01,
                        masked_median_01, quantile_01)
from .resize import pad_to_aspect, resize_area, resize_bilinear
from .subject import dynamic_parallax_scale, estimate_subject_depth, motion_metric
from .warp import disparity_warp, stereo_warp

__all__ = ["bgr_to_rgb", "depth_frame_to_01", "float_to_u8_round", "float_to_u8_trunc",
           "quantize_u8", "rgb_to_gray", "u8_to_float", "enhance_curvature", "midtone_shape",
           "shape_depth_for_pop", "signed_pow", "apply_dof", "feather_shift_edges",
           "heal_missing_pixels", "suppress_artifacts_with_edge_mask", "box_blur",
           "forward_diff_grad", "gaussian_blur", "grad_magnitude", "sharpen", "FORMATS",
           "anaglyph_red_cyan", "apply_side_mask", "format_3d_output", "interlaced",
           "pack_per_eye", "apply_color_grade", "exact_masked_median", "exact_quantile",
           "hist_quantile", "histogram_01", "masked_median_01", "quantile_01", "pad_to_aspect",
           "resize_area", "resize_bilinear", "dynamic_parallax_scale", "estimate_subject_depth",
           "motion_metric", "disparity_warp", "stereo_warp"]
