"""Diffusion depth: the schedulers, the SD VAE, the SD2 UNet and the
Marigold pipeline, the CLIP vision tower, the spatio-temporal UNet and the
DepthCrafter pipeline, with their checkpoint loaders."""

from .clip_vision import CLIP_TINY, CLIPVisionConfig, CLIPVisionEncoder
from .depthcrafter import DepthCrafterPipeline
from .loaders import (build_random_depthcrafter, build_random_marigold, load_depthcrafter,
                      load_diffusers_state, load_diffusion_pipeline, load_marigold,
                      tiny_depthcrafter, tiny_marigold)
from .marigold import MarigoldPipeline
from .schedulers import DDIMSchedule, EulerSchedule, svd_precondition
from .unet2d import UNET2D_TINY, UNet2DCondition, UNet2DConfig
from .unet_st import UNET_ST_TINY, UNetSpatioTemporal, UNetSTConfig
from .vae import VAE_TINY, AutoencoderKL, VAEConfig

__all__ = ["AutoencoderKL", "CLIPVisionConfig", "CLIPVisionEncoder", "CLIP_TINY",
           "DDIMSchedule", "DepthCrafterPipeline", "EulerSchedule", "MarigoldPipeline",
           "UNET2D_TINY", "UNET_ST_TINY", "UNet2DCondition", "UNet2DConfig",
           "UNetSTConfig", "UNetSpatioTemporal", "VAEConfig", "VAE_TINY",
           "build_random_depthcrafter", "build_random_marigold", "load_depthcrafter",
           "load_diffusers_state", "load_diffusion_pipeline", "load_marigold",
           "svd_precondition", "tiny_depthcrafter", "tiny_marigold"]
