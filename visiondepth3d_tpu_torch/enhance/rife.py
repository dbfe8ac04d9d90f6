"""RIFE-style frame interpolation (IFNet) as ``nn.Module``s.

Counterpart of ``visiondepth3d_tpu/enhance/rife.py``: a coarse-to-fine
pyramid of flow blocks, each refining bidirectional flow and an occlusion
mask at increasing resolution, with backward warping between levels.
Tensors are NHWC floats in [0, 1]. The layout and names are practical-RIFE
v4.x's, so a checkpoint converted by ``convert_rife`` loads with
``load_state_dict``:

  block0 input  = [img0, img1, timestep]                      (7 ch)
  blockN input  = [warped0, warped1, timestep, mask, flow/s]  (12 ch)
  per block: conv0 = 2 stride-2 conv+PReLU; convblock = n_res residual
  convs; lastconv = ConvTranspose(4*tail) + PixelShuffle(2) -> 4 flow +
  1 mask (+ ignored feature channels) at the block's input resolution.

Two residual-conv variants (``res_prelu``):
  False: leaky_relu(conv(x) * beta + x, 0.2)   (v4.6-style raw conv)
  True:  x + prelu(conv(x)) * beta             (conv() helper style)

The stride-1 convs are ``esrgan.Conv3x3`` (the hand kernel K5 on a CUDA
tensor); the stride-2 convs and the transpose conv are ``F.conv2d`` /
``F.conv_transpose2d``, as the JAX package leaves them to XLA.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.flow_warp import flow_warp_batch
from ..ops.resize import resize_bilinear
from .esrgan import Conv3x3

_DEFAULT_CS = (192, 128, 96, 64)
_DEFAULT_SCALES = (8, 4, 2, 1)


def _resize(x, hw):
    return resize_bilinear(x, hw, align_corners=False, channel_last=True)


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


class PReLU(nn.Module):
    """Per-channel PReLU on NHWC input; parameter ``weight`` [C] as
    ``nn.PReLU`` names it (initialised to 0.25)."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.full((channels,), 0.25))

    def forward(self, x):
        return torch.where(x >= 0, x, self.weight.to(x.dtype) * x)


class StridedConv(nn.Module):
    """3x3 conv at stride 2, padding 1, on NHWC input (``F.conv2d``)."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, 3, 3))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x):
        y = F.conv2d(_nchw(x), self.weight.to(x.dtype), self.bias.to(x.dtype),
                     stride=2, padding=1)
        return _nhwc(y)


class ConvPReLU(nn.Sequential):
    """conv (children "0") + PReLU ("1"), practical-RIFE's ``conv()``."""

    def __init__(self, cin: int, cout: int, stride: int = 1):
        conv = Conv3x3(cin, cout) if stride == 1 else StridedConv(cin, cout)
        super().__init__(conv, PReLU(cout))


class ResConv(nn.Module):
    """One residual conv of the IFBlock trunk; both v4.x flavours."""

    def __init__(self, c: int, res_prelu: bool = False):
        super().__init__()
        self.res_prelu = res_prelu
        self.conv = ConvPReLU(c, c) if res_prelu else Conv3x3(c, c)
        self.beta = nn.Parameter(torch.ones(1, c, 1, 1))

    def forward(self, x):
        beta = self.beta.reshape(-1).to(x.dtype)
        h = self.conv(x)
        if self.res_prelu:
            return x + h * beta
        return F.leaky_relu(h * beta + x, 0.2)


def pixel_shuffle(x: torch.Tensor, r: int) -> torch.Tensor:
    """torch PixelShuffle in NHWC: [B, H, W, C*r*r] -> [B, H*r, W*r, C],
    input channel c * r^2 + i * r + j -> output (i, j) offset of channel c."""
    b, h, w, crr = x.shape
    c = crr // (r * r)
    x = x.reshape(b, h, w, c, r, r).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(b, h * r, w * r, c)


class TransposeConv(nn.Module):
    """ConvTranspose2d(k=4, s=2, p=1) on NHWC input; weight [in, out, 4, 4]."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cin, cout, 4, 4))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x):
        y = F.conv_transpose2d(_nchw(x), self.weight.to(x.dtype), self.bias.to(x.dtype),
                               stride=2, padding=1)
        return _nhwc(y)


class IFBlock(nn.Module):
    def __init__(self, cin: int, c: int, n_res: int = 8, tail_out: int = 5,
                 res_prelu: bool = False):
        super().__init__()
        self.conv0 = nn.Sequential(ConvPReLU(cin, c // 2, 2), ConvPReLU(c // 2, c, 2))
        self.convblock = nn.Sequential(*[ResConv(c, res_prelu) for _ in range(n_res)])
        self.lastconv = nn.Sequential(TransposeConv(c, 4 * tail_out))

    def forward(self, x):
        """[B, h, w, C_in] -> [B, h, w, tail_out] raw deltas (4 unscaled flow
        + 1 mask logit + any extra feature channels)."""
        return pixel_shuffle(self.lastconv(self.convblock(self.conv0(x))), 2)


class IFNet(nn.Module):
    """Coarse-to-fine interpolation network (practical-RIFE v4.x layout);
    ``cs`` is the per-block trunk width, coarsest first."""

    def __init__(self, cs: tuple = _DEFAULT_CS, scales: tuple = _DEFAULT_SCALES,
                 n_res: int = 8, tail_out: int = 5, res_prelu: bool = False):
        super().__init__()
        if len(cs) != len(scales):
            raise ValueError(f"{len(cs)} block widths for {len(scales)} scales")
        self.scales = tuple(scales)
        for i, c in enumerate(cs):
            setattr(self, f"block{i}", IFBlock(7 if i == 0 else 12, c, n_res, tail_out,
                                               res_prelu))

    def forward(self, img0: torch.Tensor, img1: torch.Tensor, timestep: float = 0.5):
        """img0/img1 [B, H, W, 3] in [0, 1] -> the frame at ``timestep`` in
        (0, 1), [B, H, W, 3]."""
        b, h, w, _ = img0.shape
        flow = mask = None
        warped0, warped1 = img0, img1
        for i, s in enumerate(self.scales):
            hs, ws = h // s, w // s
            t = torch.full((b, hs, ws, 1), timestep, dtype=img0.dtype, device=img0.device)
            if flow is None:
                inp = torch.cat([_resize(img0, (hs, ws)), _resize(img1, (hs, ws)), t], dim=-1)
            else:
                inp = torch.cat([_resize(warped0, (hs, ws)), _resize(warped1, (hs, ws)), t,
                                 _resize(mask, (hs, ws)), _resize(flow, (hs, ws)) / s], dim=-1)
            y = _resize(getattr(self, f"block{i}")(inp), (h, w))
            dflow = y[..., :4] * float(s)
            flow = dflow if flow is None else flow + dflow
            mask = y[..., 4:5]  # overwritten per level, as upstream
            warped0 = flow_warp_batch(img0, flow[..., 0:2])
            warped1 = flow_warp_batch(img1, flow[..., 2:4])
        m = torch.sigmoid(mask)
        return torch.clamp(warped0 * m + warped1 * (1.0 - m), 0.0, 1.0)


@dataclasses.dataclass(frozen=True)
class IFNetConfig:
    cs: tuple = _DEFAULT_CS
    scales: tuple = _DEFAULT_SCALES
    n_res: int = 8
    tail_out: int = 5
    res_prelu: bool = False

    def build(self) -> IFNet:
        return IFNet(cs=self.cs, scales=self.scales, n_res=self.n_res,
                     tail_out=self.tail_out, res_prelu=self.res_prelu)


@torch.no_grad()
def interpolate_pairs(model: IFNet, frames01: torch.Tensor, multiplier: int = 2):
    """[T, H, W, 3] -> [(T-1)*mult + 1, H, W, 3] with mult-1 in-betweens per
    original pair (run_rife batching analog, merged_pipeline.py:204-219)."""
    img0, img1 = frames01[:-1], frames01[1:]
    mids = [model(img0, img1, k / multiplier) for k in range(1, multiplier)]
    seq = []
    for i in range(frames01.shape[0] - 1):
        seq.append(frames01[i])
        seq.extend(m[i] for m in mids)
    seq.append(frames01[-1])
    return torch.stack(seq)


@torch.no_grad()
def rife_apply(params_and_cfg, img0: torch.Tensor, img1: torch.Tensor,
               t: float = 0.5) -> torch.Tensor:
    """The frame at time t between two [H, W, 3] images in [0, 1], on
    img0's device. ``params_and_cfg``: the (state dict, IFNetConfig) pair
    ``load_rife_weights`` returns, a bare state dict (the default
    geometry), or a built ``IFNet``."""
    dev = img0.device
    if isinstance(params_and_cfg, IFNet):
        model = params_and_cfg
    else:
        state, cfg = (params_and_cfg if isinstance(params_and_cfg, tuple)
                      else (params_and_cfg, IFNetConfig()))
        with dev:
            model = cfg.build()
        model.load_state_dict(state)
    return model.to(dev).eval()(img0[None], img1[None], t)[0]


# ------------------------------------------------------------------ weights

def _strip_prefix(state: dict) -> dict:
    out = {}
    for k, v in state.items():
        for pre in ("module.", "flownet."):
            if k.startswith(pre):
                k = k[len(pre):]
        out[k] = v
    return out


def infer_rife_config(state: dict) -> IFNetConfig:
    """The IFNet geometry of a practical-RIFE state dict."""
    state = _strip_prefix(state)
    blocks = sorted({int(k.split(".")[0][5:]) for k in state
                     if k.startswith("block") and not k.startswith("block_tea")})
    if not blocks or blocks != list(range(len(blocks))):
        raise ValueError(f"unrecognized RIFE checkpoint: block keys {blocks!r}")
    n = len(blocks)
    res_prelu = any(".conv.0.weight" in k for k in state)
    cs, n_res, tail_out = [], 0, None
    for i in blocks:
        cs.append(int(state[f"block{i}.conv0.1.0.weight"].shape[0]))  # [c, c/2, 3, 3]
        ks = [int(k.split(".")[2]) for k in state if k.startswith(f"block{i}.convblock.")]
        n_res = max(ks) + 1
        tail_out = int(state[f"block{i}.lastconv.0.weight"].shape[1]) // 4  # [c, 4*tail, 4, 4]
    # 4 blocks -> (8, 4, 2, 1) per v4.x; 3 blocks -> (4, 2, 1)
    scales = (8, 4, 2, 1) if n == 4 else tuple(2 ** (n - 1 - j) for j in range(n))
    return IFNetConfig(cs=tuple(cs), scales=scales, n_res=n_res, tail_out=tail_out,
                       res_prelu=res_prelu)


def convert_rife(state: dict) -> tuple[dict[str, torch.Tensor], IFNetConfig]:
    """practical-RIFE IFNet state dict (torch tensors or numpy; also the
    name-preserving ONNX export's initializer table) -> (a float32 state
    dict for ``IFNetConfig.build()``, the config). Teacher blocks
    (block_tea) and any other unused keys are dropped."""
    state = _strip_prefix(state)
    cfg = infer_rife_config(state)
    out = {}
    for k, ref in cfg.build().state_dict().items():
        if k not in state:
            raise KeyError(f"RIFE checkpoint lacks {k!r} for {cfg}")
        v = state[k]
        v = v.detach().cpu() if isinstance(v, torch.Tensor) else torch.from_numpy(
            np.array(v, dtype=np.float32))
        out[k] = v.to(torch.float32).reshape(ref.shape)
    return out, cfg


def load_rife_weights(path, scales=None) -> tuple[dict[str, torch.Tensor], IFNetConfig]:
    """RIFE weights from .pth/.pkl (torch), .safetensors or .onnx; the
    geometry comes from the checkpoint itself (``scales`` is taken, as in
    the JAX package, and not used)."""
    p = str(path)
    if p.endswith(".onnx"):
        from ..utils.onnx_reader import read_onnx_initializers

        state = read_onnx_initializers(p)
    elif p.endswith(".safetensors"):
        from ..depth.convert import load_safetensors

        state = load_safetensors(p)
    else:
        raw = torch.load(p, map_location="cpu", weights_only=True)
        state = dict(raw.state_dict() if hasattr(raw, "state_dict") else raw)
    return convert_rife(state)
