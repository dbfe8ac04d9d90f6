"""DPT with a BEiT backbone (Intel/dpt-beit-large-512, MiDaS v3.1).

Counterpart of ``visiondepth3d_tpu/depth/dpt_beit.py``: the BEiT trunk of
``depth/beit.py`` under the classic DPT neck and head of
``depth/dpt_classic.py``. Parameter names follow HF
``DPTForDepthEstimation`` with a BEiT backbone (``backbone.*``, ``neck.*``,
``head.head.{0,2,4}``).
"""

from __future__ import annotations

import dataclasses

from torch import nn

from .beit import BEIT_LARGE_512, BEIT_TINY, BEiTBackbone, BEiTConfig
from .dpt_classic import DPTHead, DPTNeck


@dataclasses.dataclass(frozen=True)
class DPTBEiTConfig:
    backbone: BEiTConfig = BEIT_LARGE_512
    out_indices: tuple = (6, 12, 18, 24)
    reassemble_factors: tuple = (4, 2, 1, 0.5)
    neck_hidden_sizes: tuple = (256, 512, 1024, 1024)
    fusion_hidden_size: int = 256


DPT_BEIT_LARGE_512 = DPTBEiTConfig()
DPT_BEIT_TINY = DPTBEiTConfig(
    backbone=BEIT_TINY,
    out_indices=(1, 2, 3, 4),
    neck_hidden_sizes=(16, 24, 32, 40),
    fusion_hidden_size=16,
)

# HF keys the port's model does not hold: the first fusion layer's residual
# unit, which has no residual input to act on.
UNUSED_HF_KEYS = ("neck.fusion_stage.layers.0.residual_layer1.",)


class DPTBEiT(nn.Module):
    """BEiT + DPT neck/head: [B, 3, H, W] ImageNet-normalized pixels ->
    [B, H, W] relative inverse depth."""

    def __init__(self, cfg: DPTBEiTConfig = DPT_BEIT_LARGE_512, fast_head: bool = False):
        super().__init__()
        self.cfg = cfg
        self.backbone = BEiTBackbone(cfg.backbone, cfg.out_indices)
        self.neck = DPTNeck(cfg, cfg.backbone.hidden_size)
        self.head = DPTHead(cfg.fusion_hidden_size, fast_head)

    def forward(self, pixels):
        feats, grid = self.backbone(pixels)
        fused, _ = self.neck(feats, grid)
        return self.head(fused[-1])
