"""The frame tools: Real-ESRGAN upscaling and RIFE interpolation."""

from .esrgan import (ESRGAN_CATALOG, ESRGANConfig, RRDBNet, blend_images, convert_esrgan,
                     load_esrgan_weights)
from .pipeline import EnhanceConfig, init_enhance_params, run_merged_pipeline
from .rife import IFNet, IFNetConfig, convert_rife, interpolate_pairs, load_rife_weights

__all__ = ["ESRGAN_CATALOG", "ESRGANConfig", "RRDBNet", "blend_images", "convert_esrgan",
           "load_esrgan_weights", "EnhanceConfig", "init_enhance_params",
           "run_merged_pipeline", "IFNet", "IFNetConfig", "convert_rife", "interpolate_pairs",
           "load_rife_weights"]
