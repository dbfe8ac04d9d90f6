"""DPT neck + depth head (Depth Anything variant).

Counterpart of ``visiondepth3d_tpu/depth/dpt.py``. Parameter names follow
HF ``DepthAnythingForDepthEstimation`` (``neck.reassemble_stage``,
``neck.convs``, ``neck.fusion_stage``, ``head``). Interpolation
conventions are kept exactly: fusion upsampling is bilinear
align_corners=True, residual size adaptation align_corners=False, the
head's upsample align_corners=True to (grid * patch). Convolutions are
``nn.Conv2d`` / ``nn.ConvTranspose2d`` on NCHW tensors.

``fast_head=True`` runs head.conv2/conv3 at the fused-feature resolution and
upsamples the one-channel depth last (same parameters, fewer FLOPs); False
keeps the HF op order.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.resize import resize_bilinear
from .configs import DPTConfig
from .dinov2 import Dinov2Backbone


def _conv3(cin: int, cout: int, bias: bool = True, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, stride=stride, padding=1, bias=bias)


class ReassembleLayer(nn.Module):
    def __init__(self, hidden: int, channels: int, factor: float):
        super().__init__()
        self.projection = nn.Conv2d(hidden, channels, 1)
        if factor > 1:
            f = int(factor)
            self.resize = nn.ConvTranspose2d(channels, channels, f, stride=f)
        elif factor < 1:
            self.resize = _conv3(channels, channels, stride=int(1 / factor))
        else:
            self.resize = nn.Identity()

    def forward(self, x):
        return self.resize(self.projection(x))


class ReassembleStage(nn.Module):
    def __init__(self, cfg: DPTConfig):
        super().__init__()
        self.layers = nn.ModuleList(
            ReassembleLayer(cfg.backbone.hidden_size, ch, f)
            for ch, f in zip(cfg.neck_hidden_sizes, cfg.reassemble_factors))


class PreActResidual(nn.Module):
    def __init__(self, features: int):
        super().__init__()
        self.convolution1 = _conv3(features, features)
        self.convolution2 = _conv3(features, features)

    def forward(self, x):
        h = self.convolution1(F.relu(x))
        return x + self.convolution2(F.relu(h))


class FeatureFusionLayer(nn.Module):
    """The first (deepest) layer has no residual input, so no residual_layer1."""

    def __init__(self, features: int, has_residual: bool):
        super().__init__()
        self.projection = nn.Conv2d(features, features, 1)
        if has_residual:
            self.residual_layer1 = PreActResidual(features)
        self.residual_layer2 = PreActResidual(features)

    def forward(self, x, residual=None, size=None):
        if residual is not None:
            if residual.shape[2:] != x.shape[2:]:
                residual = resize_bilinear(residual, tuple(x.shape[2:]),
                                           align_corners=False, channel_last=False)
            x = x + self.residual_layer1(residual)
        x = self.residual_layer2(x)
        target = tuple(size) if size is not None else (x.shape[2] * 2, x.shape[3] * 2)
        x = resize_bilinear(x, target, align_corners=True, channel_last=False)
        return self.projection(x)


class FusionStage(nn.Module):
    def __init__(self, cfg: DPTConfig):
        super().__init__()
        self.layers = nn.ModuleList(
            FeatureFusionLayer(cfg.fusion_hidden_size, has_residual=i > 0)
            for i in range(len(cfg.neck_hidden_sizes)))


class Neck(nn.Module):
    def __init__(self, cfg: DPTConfig):
        super().__init__()
        self.reassemble_stage = ReassembleStage(cfg)
        self.convs = nn.ModuleList(
            _conv3(ch, cfg.fusion_hidden_size, bias=False) for ch in cfg.neck_hidden_sizes)
        self.fusion_stage = FusionStage(cfg)

    def forward(self, feats, grid_hw):
        gh, gw = grid_hw
        maps = []
        for feat, layer, conv in zip(feats, self.reassemble_stage.layers, self.convs):
            tokens = feat[:, 1:]  # drop cls
            fm = tokens.transpose(1, 2).reshape(tokens.shape[0], -1, gh, gw)
            maps.append(conv(layer(fm)))
        rev = maps[::-1]
        fused = None
        for idx, (hs, layer) in enumerate(zip(rev, self.fusion_stage.layers)):
            size = rev[idx + 1].shape[2:] if idx != len(rev) - 1 else None
            fused = layer(hs, None, size) if fused is None else layer(fused, hs, size)
        return fused


class Head(nn.Module):
    def __init__(self, cfg: DPTConfig, fast_head: bool):
        super().__init__()
        f = cfg.fusion_hidden_size
        self.cfg = cfg
        self.fast_head = fast_head
        self.conv1 = _conv3(f, f // 2)
        self.conv2 = _conv3(f // 2, cfg.head_hidden_size)
        self.conv3 = nn.Conv2d(cfg.head_hidden_size, 1, 1)

    def forward(self, x, grid_hw):
        gh, gw = grid_hw
        p = self.cfg.backbone.patch_size
        x = self.conv1(x)
        if not self.fast_head:
            x = resize_bilinear(x, (gh * p, gw * p), align_corners=True, channel_last=False)
        x = self.conv3(F.relu(self.conv2(x)))
        x = F.relu(x) if self.cfg.depth_estimation_type == "relative" else torch.sigmoid(x)
        x = x[:, 0] * self.cfg.max_depth  # [B, h, w]
        if self.fast_head:
            x = resize_bilinear(x, (gh * p, gw * p), align_corners=True, channel_last=False)
        return x


class DepthAnything(nn.Module):
    """DINOv2 backbone + DPT neck/head: [B, 3, H, W] ImageNet-normalized
    pixels -> [B, H, W] relative depth (H, W multiples of the patch)."""

    def __init__(self, cfg: DPTConfig, fast_head: bool = False):
        super().__init__()
        self.cfg = cfg
        self.backbone = Dinov2Backbone(cfg.backbone, cfg.out_indices)
        self.neck = Neck(cfg)
        self.head = Head(cfg, fast_head)

    def forward(self, pixels):
        feats, grid = self.backbone(pixels)
        return self.head(self.neck(feats, grid), grid)
