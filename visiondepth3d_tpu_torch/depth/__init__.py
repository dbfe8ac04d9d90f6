from .configs import DA_TINY, DA_V2_SMALL, DPTConfig, ViTConfig
from .dpt import DepthAnything
from .model import DepthPredictor, build_random, snap_hw

__all__ = ["DA_TINY", "DA_V2_SMALL", "DPTConfig", "ViTConfig", "DepthAnything",
           "DepthPredictor", "build_random", "snap_hw"]
