"""Diffusion depth: the schedulers, the SD VAE, the SD2 UNet and the
Marigold pipeline with its checkpoint loader (DepthCrafter is not ported
yet: ROADMAP Queue 1 item 3)."""

from .loaders import (build_random_marigold, load_diffusers_state, load_diffusion_pipeline,
                      load_marigold, tiny_marigold)
from .marigold import MarigoldPipeline
from .schedulers import DDIMSchedule, EulerSchedule, svd_precondition
from .unet2d import UNET2D_TINY, UNet2DCondition, UNet2DConfig
from .vae import VAE_TINY, AutoencoderKL, VAEConfig

__all__ = ["AutoencoderKL", "DDIMSchedule", "EulerSchedule", "MarigoldPipeline", "UNET2D_TINY",
           "UNet2DCondition", "UNet2DConfig", "VAEConfig", "VAE_TINY", "build_random_marigold",
           "load_diffusers_state", "load_diffusion_pipeline", "load_marigold",
           "svd_precondition", "tiny_marigold"]
