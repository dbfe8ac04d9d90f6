"""Video Depth Anything (VDA): Depth Anything with temporal attention over a
window of frames, run in overlapping windows.

Counterpart of ``visiondepth3d_tpu/depth/vda.py``: the port's DINOv2
backbone and DPT neck and head (``dinov2.py``, ``dpt.py``, under their
Depth Anything names), with a ``TemporalAttentionBlock`` on each tapped
stage's tokens, attending over the T frames of the window at each token
position. ``VDAPredictor`` runs clips longer than the window in windows of
T with stride T - overlap, fits each window's scale and shift to the
previous one on their overlap and cross-fades them linearly, all on the
predictor's device.

``convert_vda`` is the port's copy of the JAX package's upstream key map:
the ``pretrained.*`` keys (original DINOv2 names, fused qkv) and the
``head.*`` keys of ``depth-anything/Video-Depth-Anything`` onto the port's
names; a temporal block that upstream has no shape-compatible attention
for starts as the identity, as in the JAX package.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import DEFAULT_DEVICE, resolve_device
from .configs import DPTConfig, ViTConfig
from .dinov2 import Dinov2Backbone
from .dpt import Head, Neck
from .model import _DTYPES, IMAGENET_MEAN, IMAGENET_STD


@dataclasses.dataclass(frozen=True)
class VDAConfig:
    """VDA-Small: ViT-S/14 with neck (48, 96, 192, 384), fusion 64, a
    32-frame window with 8 frames of overlap, 4 temporal heads (the JAX
    package's ``VDAConfig()``)."""

    base: DPTConfig = DPTConfig()
    window: int = 32
    overlap: int = 8
    temporal_heads: int = 4


VDA_TINY = VDAConfig(
    base=DPTConfig(
        backbone=ViTConfig(hidden_size=32, num_layers=4, num_heads=2, patch_size=14,
                           image_size=70),
        out_indices=(1, 2, 3, 4), neck_hidden_sizes=(16, 24, 32, 40), fusion_hidden_size=16,
        head_hidden_size=8),
    window=4, overlap=2, temporal_heads=2)


class TemporalAttentionBlock(nn.Module):
    """Self-attention over the T frames at each token position (SDPA, as the
    JAX package calls ``jax.nn.dot_product_attention`` directly)."""

    def __init__(self, c: int, heads: int):
        super().__init__()
        self.heads = heads
        self.hd = max(c // heads, 1)
        inner = heads * self.hd
        self.norm = nn.LayerNorm(c, eps=1e-6)
        self.q = nn.Linear(c, inner)
        self.k = nn.Linear(c, inner)
        self.v = nn.Linear(c, inner)
        self.proj = nn.Linear(inner, c)

    def forward(self, x, t: int):  # [B * T, N, C]
        bt, n, c = x.shape
        b = bt // t
        y = x.reshape(b, t, n, c).transpose(1, 2).reshape(b * n, t, c)
        h = self.norm(y)

        def split(z):  # [B * N, T, inner] -> [B * N, heads, T, hd]
            return z.reshape(b * n, t, self.heads, self.hd).transpose(1, 2)

        att = F.scaled_dot_product_attention(split(self.q(h)), split(self.k(h)), split(self.v(h)))
        y = y + self.proj(att.transpose(1, 2).reshape(b * n, t, self.heads * self.hd))
        return y.reshape(b, n, t, c).transpose(1, 2).reshape(bt, n, c)


class VideoDepthAnything(nn.Module):
    """[B, T, 3, H, W] ImageNet-normalized frames -> [B, T, H, W] depth."""

    def __init__(self, cfg: VDAConfig = VDAConfig()):
        super().__init__()
        self.cfg = cfg
        base = cfg.base
        self.backbone = Dinov2Backbone(base.backbone, base.out_indices)
        self.temporal = nn.ModuleList(TemporalAttentionBlock(base.backbone.hidden_size,
                                                             cfg.temporal_heads)
                                      for _ in base.out_indices)
        self.neck = Neck(base)
        self.head = Head(base, fast_head=False)

    def forward(self, frames):
        b, t = frames.shape[:2]
        feats, grid = self.backbone(frames.flatten(0, 1))
        mixed = [torch.cat([f[:, :1], block(f[:, 1:], t)], dim=1)  # the class token unmixed
                 for f, block in zip(feats, self.temporal)]
        depth = self.head(self.neck(mixed, grid), grid)
        return depth.reshape(b, t, *depth.shape[1:])


def _align_scale_shift(pred: torch.Tensor, ref: torch.Tensor):
    """Closed-form least squares (a, b) with pred * a + b ~= ref, as 0-d
    float64 tensors on the inputs' device ((1, 0) when the fit is singular)."""
    p, r = pred.reshape(-1).double(), ref.reshape(-1).double()
    n = p.numel()
    sp, sr = p.sum(), r.sum()
    det = n * (p * p).sum() - sp * sp
    singular = det.abs() < 1e-9
    a = (n * (p * r).sum() - sp * sr) / torch.where(singular, torch.ones_like(det), det)
    a = torch.where(singular, torch.ones_like(a), a)
    b = torch.where(singular, torch.zeros_like(a), (sr - a * sp) / n)
    return a, b


class VDAPredictor:
    """Windowed video inference on one device: [T, H, W, 3] float RGB in
    [0, 1] (H, W multiples of the patch) -> [T, H, W] float32 raw depth,
    temporally aligned. A bfloat16 predictor casts the weights once."""

    def __init__(self, model: VideoDepthAnything, dtype: str = "float32",
                 device=DEFAULT_DEVICE):
        if dtype not in _DTYPES:
            raise ValueError(f"dtype {dtype!r} not in {tuple(_DTYPES)}")
        self.cfg = model.cfg
        self.dtype = dtype
        self.device = resolve_device(device)
        self.model = model.to(device=self.device, dtype=_DTYPES[dtype]).eval()
        self._mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=self.device)
        self._std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=self.device)

    def _window(self, x: torch.Tensor) -> torch.Tensor:  # [win, S, S, 3] -> [win, S, S]
        x = x.to(_DTYPES[self.dtype]).permute(0, 3, 1, 2)[None]
        return self.model(x)[0].float()

    @torch.no_grad()
    def __call__(self, frames01: torch.Tensor) -> torch.Tensor:
        x = (frames01.to(device=self.device, dtype=torch.float32) - self._mean) / self._std
        t = x.shape[0]
        win, ov = self.cfg.window, self.cfg.overlap
        if t <= win:
            pad = win - t
            xw = torch.cat([x, x[-1:].expand(pad, *x.shape[1:])]) if pad else x
            return self._window(xw)[:t]
        starts = list(range(0, t - win, win - ov)) + [t - win]
        out = torch.zeros((t, x.shape[1], x.shape[2]), dtype=torch.float32, device=self.device)
        weight = torch.zeros((t, 1, 1), dtype=torch.float32, device=self.device)
        prev = None
        for s in starts:
            d = self._window(x[s: s + win])
            if prev is not None:  # scale/shift-align to the previous window on the overlap
                ov_n = max(1, min(prev[0] + win - s, win))
                a, b = _align_scale_shift(d[:ov_n], prev[1][-ov_n:])
                d = (d * a + b).float()
            ramp = torch.ones(win, dtype=torch.float32)
            if s > 0:
                k = min(ov, win)
                ramp[:k] = torch.from_numpy(np.linspace(0.0, 1.0, k, endpoint=False)
                                            .astype(np.float32)) + 1e-3
            ramp = ramp.to(self.device)[:, None, None]
            out[s: s + win] += d * ramp
            weight[s: s + win] += ramp
            prev = (s, d)
        return out / torch.clamp(weight, min=1e-8)


def _load_source(source) -> dict:
    """A state dict (tensors or arrays), or a .safetensors / .pth / .onnx
    path -> {name: float32 numpy array}."""
    if isinstance(source, str) or hasattr(source, "__fspath__"):
        path = str(source)
        if path.endswith(".onnx"):
            from ..utils.onnx_reader import read_onnx_initializers

            source = read_onnx_initializers(path)
        elif path.endswith(".safetensors"):
            from .convert import load_safetensors

            source = load_safetensors(path)
        else:
            raw = torch.load(path, map_location="cpu", weights_only=True)
            source = raw.get("model", raw) if isinstance(raw, dict) else raw
    return {k: (v.float().numpy() if isinstance(v, torch.Tensor) else np.asarray(v, np.float32))
            for k, v in source.items()}


def convert_vda(source, cfg: VDAConfig) -> dict[str, torch.Tensor]:
    """An upstream Video-Depth-Anything checkpoint -> the port's state dict
    (the JAX package's ``convert_vda`` key map)."""
    g = _load_source(source)
    sd: dict[str, np.ndarray] = {}
    bb = cfg.base.backbone
    hid = bb.hidden_size

    def copy(dst, src, bias=True):
        sd[f"{dst}.weight"] = g[f"{src}.weight"]
        if bias:
            sd[f"{dst}.bias"] = g[f"{src}.bias"]

    emb = "backbone.embeddings"
    sd[f"{emb}.cls_token"] = g["pretrained.cls_token"]
    sd[f"{emb}.position_embeddings"] = g["pretrained.pos_embed"]
    copy(f"{emb}.patch_embeddings.projection", "pretrained.patch_embed.proj")
    copy("backbone.layernorm", "pretrained.norm")
    for i in range(bb.num_layers):
        src, dst = f"pretrained.blocks.{i}", f"backbone.encoder.layer.{i}"
        qkv_w, qkv_b = g[f"{src}.attn.qkv.weight"], g[f"{src}.attn.qkv.bias"]
        for j, name in enumerate(("query", "key", "value")):
            sd[f"{dst}.attention.attention.{name}.weight"] = qkv_w[j * hid: (j + 1) * hid]
            sd[f"{dst}.attention.attention.{name}.bias"] = qkv_b[j * hid: (j + 1) * hid]
        copy(f"{dst}.attention.output.dense", f"{src}.attn.proj")
        for n in ("norm1", "norm2", "mlp.fc1", "mlp.fc2"):
            copy(f"{dst}.{n}", f"{src}.{n}")
        if bb.layerscale:
            sd[f"{dst}.layer_scale1.lambda1"] = g[f"{src}.ls1.gamma"]
            sd[f"{dst}.layer_scale2.lambda1"] = g[f"{src}.ls2.gamma"]

    dpt = cfg.base
    for i, factor in enumerate(dpt.reassemble_factors):
        dst = f"neck.reassemble_stage.layers.{i}"
        copy(f"{dst}.projection", f"head.projects.{i}")
        if factor != 1:
            copy(f"{dst}.resize", f"head.resize_layers.{i}")
        sd[f"neck.convs.{i}.weight"] = g[f"head.scratch.layer{i + 1}_rn.weight"]
    n_fuse = len(dpt.neck_hidden_sizes)
    for idx in range(n_fuse):  # fusion layer 0 = the deepest = refinenet{n}
        src, dst = f"head.scratch.refinenet{n_fuse - idx}", f"neck.fusion_stage.layers.{idx}"
        copy(f"{dst}.projection", f"{src}.out_conv")
        units = (("residual_layer1", "resConfUnit1"),) if idx > 0 else ()
        for mine, theirs in units + (("residual_layer2", "resConfUnit2"),):
            copy(f"{dst}.{mine}.convolution1", f"{src}.{theirs}.conv1")
            copy(f"{dst}.{mine}.convolution2", f"{src}.{theirs}.conv2")
    copy("head.conv1", "head.scratch.output_conv1")
    copy("head.conv2", "head.scratch.output_conv2.0")
    copy("head.conv3", "head.scratch.output_conv2.2")

    heads = cfg.temporal_heads
    inner = heads * max(hid // heads, 1)
    rng = np.random.default_rng(0)  # the JAX package's draws for identity blocks
    for i in range(len(dpt.out_indices)):
        dst = f"temporal.{i}"
        for cand in (f"head.motion_modules.{i}.temporal_transformer.transformer_blocks.0"
                     f".attention_blocks.0", f"head.motion_modules.{i}.attention_blocks.0"):
            if f"{cand}.to_q.weight" in g and g[f"{cand}.to_q.weight"].shape[1] == hid:
                copy(f"{dst}.norm", cand.rsplit(".", 1)[0] + ".norms.0")
                for mine, theirs in (("q", "to_q"), ("k", "to_k"), ("v", "to_v"),
                                     ("proj", "to_out.0")):
                    copy(f"{dst}.{mine}", f"{cand}.{theirs}")
                break
        else:  # identity: a zero output projection leaves the tokens as they are
            sd[f"{dst}.norm.weight"] = np.ones(hid, np.float32)
            sd[f"{dst}.norm.bias"] = np.zeros(hid, np.float32)
            for mine in ("q", "k", "v"):
                sd[f"{dst}.{mine}.weight"] = rng.normal(0, hid ** -0.5, (hid, inner)).T
                sd[f"{dst}.{mine}.bias"] = np.zeros(inner, np.float32)
            sd[f"{dst}.proj.weight"] = np.zeros((hid, inner), np.float32)
            sd[f"{dst}.proj.bias"] = np.zeros(hid, np.float32)
    return {k: torch.from_numpy(np.ascontiguousarray(v, dtype=np.float32))
            for k, v in sd.items()}
