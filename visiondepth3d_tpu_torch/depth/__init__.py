from .configs import DA_TINY, DA_V2_BASE, DA_V2_LARGE, DA_V2_SMALL, DPTConfig, ViTConfig
from .dpt import DepthAnything
from .model import DepthPredictor, build_random, snap_hw
from .registry import CATALOG, load_predictor

__all__ = ["DA_TINY", "DA_V2_BASE", "DA_V2_LARGE", "DA_V2_SMALL", "DPTConfig", "ViTConfig",
           "DepthAnything", "DepthPredictor", "build_random", "snap_hw", "CATALOG",
           "load_predictor"]
