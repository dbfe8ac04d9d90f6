"""BiT / ResNetV2 backbone: weight-standardized convs and GroupNorm.

Counterpart of ``visiondepth3d_tpu/depth/bit.py``, the convolutional stem
of MiDaS 3.0 "hybrid" (Intel/dpt-hybrid-midas), per HF ``modeling_bit.py``
with the DPT-hybrid configuration (non-preactivation bottleneck layers,
TF-"SAME" padding, a dynamically padded stem max-pool):
- every conv standardizes its weight per output channel over (in, kh, kw),
  with the biased variance and eps 1e-8, before convolving;
- TF-"SAME" padding: ceil(n / stride) outputs, the padding split with the
  extra pixel after (asymmetric on stride 2), so ``F.pad`` then conv;
- bottleneck: 1x1 -> GN/ReLU -> 3x3 (stride) -> GN/ReLU -> 1x1 -> GN, plus
  a 1x1 conv + GN shortcut on each stage's first layer; ReLU after the add;
- stage strides (1, 2, 2, ...) after the /4 stem; mid width
  ``make_div(out * 0.25)``.

Parameter names follow HF ``BitBackbone`` (``embedder.convolution``,
``embedder.norm``, ``encoder.stages.{s}.layers.{l}.{conv,norm}{1,2,3}``,
``.downsample.{conv,norm}``).
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn


def make_div(value, divisor: int = 8) -> int:
    new_value = max(divisor, int(value + divisor / 2) // divisor * divisor)
    if new_value < 0.9 * value:
        new_value += divisor
    return new_value


@dataclasses.dataclass(frozen=True)
class BitConfig:
    embedding_size: int = 64
    hidden_sizes: tuple = (256, 512, 1024)
    depths: tuple = (3, 4, 9)
    num_groups: int = 32
    width_factor: int = 1
    output_stride: int = 32


def same_pads(h: int, w: int, k: int, stride: int) -> tuple[int, int, int, int]:
    """TF-"SAME" padding as ``F.pad``'s (left, right, top, bottom)."""
    def one(n):
        total = max((math.ceil(n / stride) - 1) * stride + k - n, 0)
        return total // 2, total - total // 2
    (top, bottom), (left, right) = one(h), one(w)
    return left, right, top, bottom


class WSConv2d(nn.Conv2d):
    """Weight-standardized conv without bias, TF-"SAME" padding."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1, eps: float = 1e-8):
        super().__init__(cin, cout, k, stride=stride, bias=False)
        self.eps = eps

    def forward(self, x):
        w = self.weight
        wf = w.float()
        mean = wf.mean(dim=(1, 2, 3), keepdim=True).to(w.dtype)
        var = wf.var(dim=(1, 2, 3), unbiased=False, keepdim=True).to(w.dtype)
        w = (w - mean) * torch.rsqrt(var + self.eps)
        pads = same_pads(x.shape[2], x.shape[3], self.kernel_size[0], self.stride[0])
        return F.conv2d(F.pad(x, pads), w, None, self.stride)


class BitDownsample(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int, groups: int):
        super().__init__()
        self.conv = WSConv2d(cin, cout, 1, stride)
        self.norm = nn.GroupNorm(groups, cout, eps=1e-5)

    def forward(self, x):
        return self.norm(self.conv(x))


class BitBottleneck(nn.Module):
    def __init__(self, cfg: BitConfig, cin: int, cout: int, stride: int, is_first: bool):
        super().__init__()
        mid = make_div(cout * 0.25)
        g = cfg.num_groups
        if is_first:
            self.downsample = BitDownsample(cin, cout, stride, g)
        self.conv1 = WSConv2d(cin, mid, 1)
        self.norm1 = nn.GroupNorm(g, mid, eps=1e-5)
        self.conv2 = WSConv2d(mid, mid, 3, stride)
        self.norm2 = nn.GroupNorm(g, mid, eps=1e-5)
        self.conv3 = WSConv2d(mid, cout, 1)
        self.norm3 = nn.GroupNorm(g, cout, eps=1e-5)

    def forward(self, x):
        shortcut = self.downsample(x) if hasattr(self, "downsample") else x
        h = F.relu(self.norm1(self.conv1(x)))
        h = F.relu(self.norm2(self.conv2(h)))
        return F.relu(self.norm3(self.conv3(h)) + shortcut)


class BitEmbeddings(nn.Module):
    def __init__(self, cfg: BitConfig):
        super().__init__()
        self.convolution = WSConv2d(3, cfg.embedding_size, 7, 2)
        self.norm = nn.GroupNorm(cfg.num_groups, cfg.embedding_size, eps=1e-5)

    def forward(self, pixels):
        x = F.relu(self.norm(self.convolution(pixels)))
        # SAME 3x3 / 2 max-pool; -inf padding (the input is >= 0, so HF's
        # zero padding picks the same values)
        return F.max_pool2d(F.pad(x, same_pads(x.shape[2], x.shape[3], 3, 2),
                                  value=float("-inf")), 3, 2)


class BitStage(nn.Module):
    def __init__(self, layers):
        super().__init__()
        self.layers = nn.ModuleList(layers)

    def forward(self, x):
        for layer in self.layers:
            x = layer(x)
        return x


class BitEncoder(nn.Module):
    def __init__(self, cfg: BitConfig):
        super().__init__()
        stages, cin, current_stride = [], cfg.embedding_size, 4
        for si, (depth, hidden) in enumerate(zip(cfg.depths, cfg.hidden_sizes)):
            cout = make_div(hidden * cfg.width_factor)
            stride = 1 if si == 0 else 2
            if current_stride >= cfg.output_stride and stride != 1:
                raise NotImplementedError("dilated BiT stages (output_stride reached) are not "
                                          "part of the DPT-hybrid configuration")
            current_stride *= stride
            stages.append(BitStage(BitBottleneck(cfg, cin if li == 0 else cout, cout,
                                                 stride if li == 0 else 1, li == 0)
                                   for li in range(depth)))
            cin = cout
        self.stages = nn.ModuleList(stages)


class BitBackbone(nn.Module):
    """Stem + stages: every stage's output map (NCHW)."""

    def __init__(self, cfg: BitConfig = BitConfig()):
        super().__init__()
        self.embedder = BitEmbeddings(cfg)
        self.encoder = BitEncoder(cfg)

    def forward(self, pixels):
        x = self.embedder(pixels)
        feats = []
        for stage in self.encoder.stages:
            x = stage(x)
            feats.append(x)
        return feats
