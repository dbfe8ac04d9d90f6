"""MiDaS v2.1-small: EfficientNet-Lite3 backbone + MidasNet-small decoder.

Counterpart of ``visiondepth3d_tpu/depth/midas_v2.py``, the reference
dropdown's "Midas-V2" entry (an export of isl-org MiDaS
``midas_v21_small_256``):
- backbone: timm ``tf_efficientnet_lite3`` (no squeeze-excite, ReLU6, a
  depthwise conv per block), tapped per ``LITE_TAPS`` at strides 4/8/16/32;
- decoder: the bias-free 3x3 ``layerX_rn`` convs to 64/128/256/512, the
  channel-halving fusion blocks with pre-activation residual units, and
  the head (3x3 -> upsample to the input -> 3x3 -> ReLU -> 1x1 -> ReLU).

BatchNorm (eps 1e-3) is folded into the convolutions when a checkpoint is
converted (``convert_midas_small``), so the modules are plain convs with
biases. Every conv pads k // 2 on each side, as the JAX package's does.
Parameter names: ``pretrained.conv_stem``, ``pretrained.blocks.{s}.{j}``
with timm's ``conv_dw``/``conv_pw``(/``conv_pwl``), and the isl-org
decoder names (``scratch.layer{i}_rn``, ``scratch.refinenet{n}
.resConfUnit{1,2}.conv{1,2}``, ``.out_conv``, ``scratch.output_conv
.{0,2,4}``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.resize import resize_bilinear

# (expand_ratio, out_channels, repeats, stride, kernel) per stage;
# EfficientNet-Lite3 = B0 table scaled w=1.2/d=1.4 with first/last repeats
# and stem/head channels fixed (the "lite" modifications).
LITE3_STAGES = (
    (1, 24, 1, 1, 3),
    (6, 32, 3, 2, 3),
    (6, 48, 3, 2, 5),
    (6, 96, 5, 2, 3),
    (6, 136, 5, 1, 5),
    (6, 232, 6, 2, 5),
    (6, 384, 1, 1, 3),
)
# MidasNet_small layer1-4 grouping: stages [0,1], [2], [3,4], [5,6]
LITE_TAPS = ((0, 1), (2,), (3, 4), (5, 6))
BN_EPS = 1e-3  # EfficientNet's (TF) BatchNorm epsilon


@dataclasses.dataclass(frozen=True)
class MidasV2Config:
    stages: tuple = LITE3_STAGES
    taps: tuple = LITE_TAPS
    stem_channels: int = 32
    features: int = 64
    expand: bool = True  # fusion widths 1x/2x/4x/8x of features

    @property
    def tap_channels(self):
        return tuple(self.stages[g[-1]][1] for g in self.taps)

    @property
    def fusion_channels(self):
        if self.expand:
            return tuple(self.features * 2**i for i in range(len(self.taps)))
        return (self.features,) * len(self.taps)


MIDAS_V2_SMALL = MidasV2Config()
MIDAS_V2_TINY = MidasV2Config(
    stages=((1, 8, 1, 1, 3), (6, 8, 2, 2, 3), (6, 12, 1, 2, 5),
            (6, 16, 2, 2, 3), (6, 16, 1, 1, 5), (6, 24, 2, 2, 5),
            (6, 32, 1, 1, 3)),
    stem_channels=8,
    features=8,
)


def _conv(cin: int, cout: int, k: int, stride: int = 1, bias: bool = True,
          groups: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride=stride, padding=k // 2, bias=bias, groups=groups)


def relu6(x):
    return F.relu6(x)


class MBConvLite(nn.Module):
    """Inverted residual without squeeze-excite (the lite variant); an
    expand ratio of 1 is the depthwise-separable block of stage 0."""

    def __init__(self, cin: int, cout: int, expand: int, stride: int, kernel: int):
        super().__init__()
        self.residual = stride == 1 and cin == cout
        mid = cin * expand
        if expand != 1:  # timm InvertedResidual: conv_pw, conv_dw, conv_pwl
            self.conv_pw = _conv(cin, mid, 1)
            self.conv_dw = _conv(mid, mid, kernel, stride, groups=mid)
            self.conv_pwl = _conv(mid, cout, 1)
        else:  # timm DepthwiseSeparableConv: conv_dw, conv_pw
            self.conv_dw = _conv(cin, cin, kernel, stride, groups=cin)
            self.conv_pw = _conv(cin, cout, 1)

    def forward(self, x):
        if hasattr(self, "conv_pwl"):
            h = relu6(self.conv_pw(x))
            h = self.conv_pwl(relu6(self.conv_dw(h)))
        else:
            h = self.conv_pw(relu6(self.conv_dw(x)))
        return h + x if self.residual else h


class EfficientNetLite(nn.Module):
    def __init__(self, cfg: MidasV2Config):
        super().__init__()
        self.cfg = cfg
        self.conv_stem = _conv(3, cfg.stem_channels, 3, stride=2)
        blocks, cin = [], cfg.stem_channels
        for e, c, n, s, k in cfg.stages:
            stage = []
            for j in range(n):
                stage.append(MBConvLite(cin, c, e, s if j == 0 else 1, k))
                cin = c
            blocks.append(nn.Sequential(*stage))
        self.blocks = nn.ModuleList(blocks)

    def forward(self, pixels):
        """The feature maps after the last stage of each tap group."""
        x = relu6(self.conv_stem(pixels))
        last = {g[-1] for g in self.cfg.taps}
        taps = []
        for si, stage in enumerate(self.blocks):
            x = stage(x)
            if si in last:
                taps.append(x)
        return taps


class ResidualConvUnit(nn.Module):
    """Pre-activation residual unit (ResidualConvUnit_custom, ReLU, no BN)."""

    def __init__(self, ch: int):
        super().__init__()
        self.conv1 = _conv(ch, ch, 3)
        self.conv2 = _conv(ch, ch, 3)

    def forward(self, x):
        return self.conv2(F.relu(self.conv1(F.relu(x)))) + x


class FusionBlock(nn.Module):
    """FeatureFusionBlock_custom: skip add, residual unit, bilinear resize
    (align_corners True), 1x1 ``out_conv`` (halving channels)."""

    def __init__(self, ch: int, out_ch: int, has_skip: bool):
        super().__init__()
        if has_skip:
            self.resConfUnit1 = ResidualConvUnit(ch)
        self.resConfUnit2 = ResidualConvUnit(ch)
        self.out_conv = _conv(ch, out_ch, 1)

    def forward(self, x, skip, out_hw):
        if skip is not None:
            x = x + self.resConfUnit1(skip)
        x = resize_bilinear(self.resConfUnit2(x), out_hw, align_corners=True,
                            channel_last=False)
        return self.out_conv(x)


class Scratch(nn.Module):
    def __init__(self, cfg: MidasV2Config):
        super().__init__()
        fus, taps = cfg.fusion_channels, cfg.tap_channels
        n = len(cfg.taps)
        for i in range(n):
            self.add_module(f"layer{i + 1}_rn", _conv(taps[i], fus[i], 3, bias=False))
        # refinenet{n} is the deepest (no skip input); each halves its
        # channels, refinenet1 down to ``features``
        for i in range(n):
            out = cfg.features if i == 0 else fus[i - 1]
            self.add_module(f"refinenet{i + 1}", FusionBlock(fus[i], out, has_skip=i < n - 1))
        self.output_conv = nn.Sequential(
            _conv(cfg.features, cfg.features // 2, 3), nn.Identity(),
            _conv(cfg.features // 2, 32, 3), nn.ReLU(), _conv(32, 1, 1), nn.ReLU())


class MidasNetSmall(nn.Module):
    """[B, 3, H, W] ImageNet-normalized pixels (H, W multiples of 32) ->
    [B, H, W] relative inverse depth."""

    def __init__(self, cfg: MidasV2Config = MIDAS_V2_SMALL):
        super().__init__()
        self.cfg = cfg
        self.pretrained = EfficientNetLite(cfg)
        self.scratch = Scratch(cfg)

    def forward(self, pixels):
        rn = [getattr(self.scratch, f"layer{i + 1}_rn")(t)
              for i, t in enumerate(self.pretrained(pixels))]
        y = None
        for d in range(len(rn) - 1, -1, -1):  # deepest first
            out_hw = rn[d - 1].shape[2:] if d > 0 else (rn[0].shape[2] * 2,
                                                        rn[0].shape[3] * 2)
            block = getattr(self.scratch, f"refinenet{d + 1}")
            y = block(rn[d], None, tuple(out_hw)) if y is None else block(y, rn[d],
                                                                          tuple(out_hw))
        conv0, _, conv2, _, conv4, _ = self.scratch.output_conv
        y = resize_bilinear(conv0(y), tuple(pixels.shape[2:]), align_corners=True,
                            channel_last=False)
        return F.relu(conv4(F.relu(conv2(y))))[:, 0]


def fold_bn(w: np.ndarray, conv_bias, bn, eps: float = BN_EPS):
    """BatchNorm (gamma, beta, mean, var) folded into a conv's OIHW weight
    and bias, as the JAX package's ``_fold_bn``."""
    gamma, beta, mean, var = bn
    scale = gamma / np.sqrt(var + eps)
    b = (conv_bias if conv_bias is not None else 0.0) - mean
    return w * scale[:, None, None, None], b * scale + beta


def _read_source(source) -> dict:
    if not (isinstance(source, str) or hasattr(source, "__fspath__")):
        return source
    p = str(source)
    if p.endswith(".onnx"):
        from ..utils.onnx_reader import read_onnx_initializers

        return read_onnx_initializers(p)
    if p.endswith(".safetensors"):
        from .convert import load_safetensors

        return load_safetensors(p)
    raw = torch.load(p, map_location="cpu", weights_only=True)
    return raw.get("model", raw) if isinstance(raw, dict) else raw


def convert_midas_small(source, cfg: MidasV2Config = MIDAS_V2_SMALL) -> dict[str, torch.Tensor]:
    """isl-org ``midas_v21_small_256`` weights (a state dict, or a ``.pt``,
    ``.safetensors`` or ``.onnx`` file's) -> the port's state dict, every
    BatchNorm folded into its conv (eps 1e-3).

    Checkpoint names: ``pretrained.layer{L}.{idx}`` where the layer
    Sequentials unpack (conv_stem, bn1, act1, stage0, stage1), (stage2,),
    (stage3, stage4), (stage5, stage6); timm block keys are
    conv_dw/bn1/conv_pw/bn2 in stage 0 and conv_pw/bn1/conv_dw/bn2/
    conv_pwl/bn3 elsewhere; the decoder's are the port's.
    """
    g = {k: np.array(v.float().numpy() if isinstance(v, torch.Tensor) else v,
                     dtype=np.float32) for k, v in _read_source(source).items()}
    sd: dict[str, torch.Tensor] = {}

    def folded(dst, conv, bn):
        w, b = fold_bn(g[f"{conv}.weight"], g.get(f"{conv}.bias"),
                       tuple(g[f"{bn}.{n}"] for n in ("weight", "bias", "running_mean",
                                                      "running_var")))
        sd[f"{dst}.weight"] = torch.from_numpy(np.ascontiguousarray(w, np.float32))
        sd[f"{dst}.bias"] = torch.from_numpy(np.ascontiguousarray(b, np.float32))

    stage_prefix = {}
    for li, group in enumerate(cfg.taps):
        base = 3 if li == 0 else 0  # layer1 carries conv_stem, bn1, act1 first
        for off, si in enumerate(group):
            stage_prefix[si] = f"pretrained.layer{li + 1}.{base + off}"
    folded("pretrained.conv_stem", "pretrained.layer1.0", "pretrained.layer1.1")
    for si, (e, _, n, _, _) in enumerate(cfg.stages):
        for j in range(n):
            src, dst = f"{stage_prefix[si]}.{j}", f"pretrained.blocks.{si}.{j}"
            convs = (("conv_dw", "bn1"), ("conv_pw", "bn2")) if e == 1 else \
                (("conv_pw", "bn1"), ("conv_dw", "bn2"), ("conv_pwl", "bn3"))
            for conv, bn in convs:
                folded(f"{dst}.{conv}", f"{src}.{conv}", f"{src}.{bn}")
    deepest = f"scratch.refinenet{len(cfg.taps)}.resConfUnit1."  # no skip input: unused
    for k, v in g.items():
        if k.startswith("scratch.") and not k.startswith(deepest):
            sd[k] = torch.from_numpy(v)
    return sd
