"""Model configurations for the depth zoo (a copy of
``visiondepth3d_tpu/depth/configs.py``, whose package imports jax).

The reference's model catalog (render_depth.py:686-726) spans 25+ HF ids;
architecturally they collapse into a few families. This module defines the
config dataclasses for the ViT/DINOv2 + DPT family that covers Depth
Anything V1/V2 (small/base/large), Distill-Any-Depth, and the DPT-style
heads; diffusion models (Marigold/DepthCrafter) live in depth/diffusion.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    hidden_size: int = 384
    num_layers: int = 12
    num_heads: int = 6
    mlp_ratio: int = 4
    patch_size: int = 14
    layer_norm_eps: float = 1e-6
    layerscale: bool = True
    use_cls_token: bool = True
    num_register_tokens: int = 0
    image_size: int = 518  # pretraining grid for position embeddings


@dataclasses.dataclass(frozen=True)
class DPTConfig:
    """DepthAnything-style DPT neck + head (modeling_depth_anything.py)."""

    backbone: ViTConfig = ViTConfig()
    out_indices: tuple = (9, 10, 11, 12)  # 1-based encoder block outputs
    reassemble_factors: tuple = (4, 2, 1, 0.5)
    neck_hidden_sizes: tuple = (48, 96, 192, 384)
    fusion_hidden_size: int = 64
    head_hidden_size: int = 32
    depth_estimation_type: str = "relative"  # or "metric"
    max_depth: float = 1.0


VIT_S = ViTConfig(hidden_size=384, num_layers=12, num_heads=6)
VIT_B = ViTConfig(hidden_size=768, num_layers=12, num_heads=12)
VIT_L = ViTConfig(hidden_size=1024, num_layers=24, num_heads=16)

DA_V2_SMALL = DPTConfig(
    backbone=VIT_S,
    out_indices=(9, 10, 11, 12),
    neck_hidden_sizes=(48, 96, 192, 384),
    fusion_hidden_size=64,
)
DA_V2_BASE = DPTConfig(
    backbone=VIT_B,
    out_indices=(9, 10, 11, 12),
    neck_hidden_sizes=(96, 192, 384, 768),
    fusion_hidden_size=128,
)
DA_V2_LARGE = DPTConfig(
    backbone=VIT_L,
    out_indices=(21, 22, 23, 24),
    neck_hidden_sizes=(256, 512, 1024, 1024),
    fusion_hidden_size=256,
)

# metric variants: sigmoid head scaled by the dataset max depth
# (modeling_depth_anything.py depth_estimation_type="metric")
DA_V2_METRIC_INDOOR = dataclasses.replace(
    DA_V2_LARGE, depth_estimation_type="metric", max_depth=20.0
)
DA_V2_METRIC_OUTDOOR = dataclasses.replace(
    DA_V2_LARGE, depth_estimation_type="metric", max_depth=80.0
)

# Tiny config for offline parity tests against transformers-torch
DA_TINY = DPTConfig(
    backbone=ViTConfig(hidden_size=32, num_layers=4, num_heads=2, patch_size=14,
                       image_size=70),
    out_indices=(1, 2, 3, 4),
    neck_hidden_sizes=(16, 24, 32, 40),
    fusion_hidden_size=16,
    head_hidden_size=8,
)
