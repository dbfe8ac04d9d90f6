"""Depth Anything (V1/V2): a DINOv2 ViT encoder, the DPT neck and the
relative-depth head, as a plain forward over a state dict in the upstream
(HF ``DepthAnythingForDepthEstimation``) names.

Written from the published architecture (Yang et al., "Depth Anything V2",
2024; HF ``modeling_depth_anything.py`` and ``modeling_dinov2.py``), with
the render's conventions: fusion upsampling bilinear with aligned corners,
the residual's size adaptation without, the head's upsample to the patch
grid times the patch with aligned corners before its last two convolutions
(the upstream op order), attention as softmax(q k^T / sqrt(d)) v written
out. ``predict_01`` is the render's use of it: the frames resized to the
inference size, ImageNet-normalized, the depth normalized per frame to
[0, 1] and resized to the eye.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import resize
from .precision import Mat

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
GROUP = 2  # frames through the model at a time: Large's activations for two fit beside the run


def model_cfg(conf: dict) -> dict:
    """The sizes of an HF ``config.json`` the forward reads."""
    bb = conf["backbone_config"]
    return {"hidden": bb["hidden_size"], "layers": bb["num_hidden_layers"],
            "heads": bb["num_attention_heads"], "mlp_ratio": bb["mlp_ratio"],
            "patch": bb["patch_size"], "image_size": bb["image_size"],
            "eps": bb["layer_norm_eps"], "layerscale": bb["layerscale_value"],
            "out_indices": tuple(bb["out_indices"]), "neck": tuple(conf["neck_hidden_sizes"]),
            "factors": tuple(conf["reassemble_factors"]), "fusion": conf["fusion_hidden_size"],
            "head_hidden": conf["head_hidden_size"], "kind": conf["depth_estimation_type"],
            "max_depth": float(conf.get("max_depth") or 1.0)}


def param_specs(cfg: dict) -> list[tuple[str, tuple, str, float]]:
    """(name, shape, init, scale) of every weight, in the upstream names.
    init: ``normal`` N(0, 1) times scale (fan_in^-1/2 for a product's
    weight, 0.02 for the class token and position embeddings), ``fill``
    the constant scale (norm gains and biases, layer-scale gains)."""
    c, p, f = cfg["hidden"], cfg["patch"], cfg["fusion"]
    side = cfg["image_size"] // p
    out: list = []

    def w(name, shape, fan_in):
        out.append((name, tuple(shape), "normal", fan_in ** -0.5))

    def const(name, shape, value):
        out.append((name, tuple(shape), "fill", float(value)))

    def norm(name, n):
        const(f"{name}.weight", (n,), 1.0)
        const(f"{name}.bias", (n,), 0.0)

    def lin(name, cout, cin):  # a Linear: (out, in)
        w(f"{name}.weight", (cout, cin), cin)
        const(f"{name}.bias", (cout,), 0.0)

    def conv(name, cout, cin, k):  # a Conv2d: (out, in, k, k)
        w(f"{name}.weight", (cout, cin, k, k), cin * k * k)
        const(f"{name}.bias", (cout,), 0.0)

    e = "backbone.embeddings"
    out.append((f"{e}.cls_token", (1, 1, c), "normal", 0.02))
    out.append((f"{e}.position_embeddings", (1, side * side + 1, c), "normal", 0.02))
    w(f"{e}.patch_embeddings.projection.weight", (c, 3, p, p), 3 * p * p)
    const(f"{e}.patch_embeddings.projection.bias", (c,), 0.0)
    for i in range(cfg["layers"]):
        b = f"backbone.encoder.layer.{i}"
        norm(f"{b}.norm1", c)
        for k in ("query", "key", "value"):
            lin(f"{b}.attention.attention.{k}", c, c)
        lin(f"{b}.attention.output.dense", c, c)
        const(f"{b}.layer_scale1.lambda1", (c,), cfg["layerscale"])
        norm(f"{b}.norm2", c)
        lin(f"{b}.mlp.fc1", c * cfg["mlp_ratio"], c)
        lin(f"{b}.mlp.fc2", c, c * cfg["mlp_ratio"])
        const(f"{b}.layer_scale2.lambda1", (c,), cfg["layerscale"])
    norm("backbone.layernorm", c)
    for i, (ch, fac) in enumerate(zip(cfg["neck"], cfg["factors"])):
        r = f"neck.reassemble_stage.layers.{i}"
        conv(f"{r}.projection", ch, c, 1)
        if fac > 1:  # transposed conv, weight (in, out, k, k): each output sums ch inputs
            w(f"{r}.resize.weight", (ch, ch, int(fac), int(fac)), ch)
            const(f"{r}.resize.bias", (ch,), 0.0)
        elif fac < 1:
            conv(f"{r}.resize", ch, ch, 3)
    for i, ch in enumerate(cfg["neck"]):
        w(f"neck.convs.{i}.weight", (f, ch, 3, 3), 9 * ch)
    for i in range(len(cfg["neck"])):
        fl = f"neck.fusion_stage.layers.{i}"
        conv(f"{fl}.projection", f, f, 1)
        for res in (("residual_layer1", "residual_layer2") if i > 0 else ("residual_layer2",)):
            for cv in ("convolution1", "convolution2"):
                conv(f"{fl}.{res}.{cv}", f, f, 3)
    conv("head.conv1", f // 2, f, 3)
    conv("head.conv2", cfg["head_hidden"], f // 2, 3)
    conv("head.conv3", 1, cfg["head_hidden"], 1)
    return out


def _attention(mm: Mat, x, sd, pre, heads):
    b, n, c = x.shape
    d = c // heads

    def proj(k):
        return mm.linear(x, sd[f"{pre}.attention.attention.{k}.weight"],
                         sd[f"{pre}.attention.attention.{k}.bias"]
                         ).reshape(b, n, heads, d).transpose(1, 2)

    q, k, v = proj("query"), proj("key"), proj("value")
    att = torch.softmax(mm.matmul(q, k.transpose(-1, -2)) * (1.0 / math.sqrt(d)), dim=-1)
    out = mm.matmul(att, v).transpose(1, 2).reshape(b, n, c)
    return mm.linear(out, sd[f"{pre}.attention.output.dense.weight"],
                     sd[f"{pre}.attention.output.dense.bias"])


def _ln(x, sd, name, eps):
    return F.layer_norm(x, (x.shape[-1],), sd[f"{name}.weight"], sd[f"{name}.bias"], eps)


def _conv(mm: Mat, x, sd, name, stride=1, padding=None, bias=True):
    wgt = sd[f"{name}.weight"]
    pad = wgt.shape[-1] // 2 if padding is None else padding
    return mm.conv2d(x, wgt, sd[f"{name}.bias"] if bias else None, stride=stride, padding=pad)


def backbone(mm: Mat, sd: dict, cfg: dict, pixels: torch.Tensor):
    """[B, 3, H, W] normalized pixels -> (the final-LayerNorm tokens after
    each block of ``out_indices``, the patch grid)."""
    p, eps = cfg["patch"], cfg["eps"]
    gh, gw = pixels.shape[2] // p, pixels.shape[3] // p
    e = "backbone.embeddings"
    x = _conv(mm, pixels, sd, f"{e}.patch_embeddings.projection", stride=p, padding=0)
    x = x.flatten(2).transpose(1, 2)
    x = torch.cat([sd[f"{e}.cls_token"].expand(x.shape[0], -1, -1), x], dim=1)
    pos = sd[f"{e}.position_embeddings"]
    side = int(round((pos.shape[1] - 1) ** 0.5))
    if (gh, gw) != (side, side):
        grid = resize.bicubic(mm, pos[0, 1:].reshape(side, side, -1), (gh, gw), hwc=True)
        pos = torch.cat([pos[:, :1], grid.reshape(1, gh * gw, -1)], dim=1)
    x = x + pos
    feats = []
    for i in range(cfg["layers"]):
        b = f"backbone.encoder.layer.{i}"
        x = x + sd[f"{b}.layer_scale1.lambda1"] * _attention(
            mm, _ln(x, sd, f"{b}.norm1", eps), sd, b, cfg["heads"])
        h = mm.linear(_ln(x, sd, f"{b}.norm2", eps), sd[f"{b}.mlp.fc1.weight"],
                      sd[f"{b}.mlp.fc1.bias"])
        h = mm.linear(F.gelu(h), sd[f"{b}.mlp.fc2.weight"], sd[f"{b}.mlp.fc2.bias"])
        x = x + sd[f"{b}.layer_scale2.lambda1"] * h
        if i + 1 in cfg["out_indices"]:
            feats.append(_ln(x, sd, "backbone.layernorm", eps))
    return feats, (gh, gw)


def _bilinear_nchw(mm, x, size, align):
    return resize.bilinear(mm, x, tuple(size), hwc=False, align_corners=align)


def _preact(mm, x, sd, name):
    h = _conv(mm, F.relu(x), sd, f"{name}.convolution1")
    return x + _conv(mm, F.relu(h), sd, f"{name}.convolution2")


def neck_head(mm: Mat, sd: dict, cfg: dict, feats, grid) -> torch.Tensor:
    gh, gw = grid
    maps = []
    for i, (feat, fac) in enumerate(zip(feats, cfg["factors"])):
        tokens = feat[:, 1:]
        fm = tokens.transpose(1, 2).reshape(tokens.shape[0], -1, gh, gw)
        r = f"neck.reassemble_stage.layers.{i}"
        fm = _conv(mm, fm, sd, f"{r}.projection", padding=0)
        if fac > 1:
            fm = mm.conv_transpose2d(fm, sd[f"{r}.resize.weight"], sd[f"{r}.resize.bias"],
                                     stride=int(fac))
        elif fac < 1:
            fm = _conv(mm, fm, sd, f"{r}.resize", stride=int(1 / fac))
        maps.append(_conv(mm, fm, sd, f"neck.convs.{i}", bias=False))
    rev = maps[::-1]
    fused = None
    for idx, hs in enumerate(rev):
        fl = f"neck.fusion_stage.layers.{idx}"
        size = tuple(rev[idx + 1].shape[2:]) if idx != len(rev) - 1 else None
        if fused is None:
            x = hs
        else:
            x, res = fused, hs
            if res.shape[2:] != x.shape[2:]:
                res = _bilinear_nchw(mm, res, x.shape[2:], False)
            x = x + _preact(mm, res, sd, f"{fl}.residual_layer1")
        x = _preact(mm, x, sd, f"{fl}.residual_layer2")
        x = _bilinear_nchw(mm, x, size or (x.shape[2] * 2, x.shape[3] * 2), True)
        fused = _conv(mm, x, sd, f"{fl}.projection", padding=0)
    p = cfg["patch"]
    x = _conv(mm, fused, sd, "head.conv1")
    x = _bilinear_nchw(mm, x, (gh * p, gw * p), True)
    x = _conv(mm, F.relu(_conv(mm, x, sd, "head.conv2")), sd, "head.conv3", padding=0)
    x = F.relu(x) if cfg["kind"] == "relative" else torch.sigmoid(x)
    return x[:, 0] * cfg["max_depth"]


def forward(mm: Mat, sd: dict, cfg: dict, pixels: torch.Tensor) -> torch.Tensor:
    """[B, 3, H, W] normalized pixels -> [B, H, W] depth."""
    feats, grid = backbone(mm, sd, cfg, pixels)
    return neck_head(mm, sd, cfg, feats, grid)


def predict_01(mm: Mat, sd: dict, cfg: dict, frames01: torch.Tensor, size: int,
               out_hw) -> torch.Tensor:
    """[T, H, W, 3] RGB in [0, 1] -> [T, out_h, out_w] depth in [0, 1], the
    model run on ``GROUP`` frames at a time (to bound the memory)."""
    p = cfg["patch"]
    s = max(p, (size // p) * p)
    mean = torch.tensor(IMAGENET_MEAN, dtype=frames01.dtype, device=frames01.device)
    std = torch.tensor(IMAGENET_STD, dtype=frames01.dtype, device=frames01.device)
    outs = []
    for i in range(0, frames01.shape[0], GROUP):
        x = resize.bilinear(mm, frames01[i:i + GROUP], (s, s), hwc=True)
        x = (x - mean) / std
        d = forward(mm, sd, cfg, x.permute(0, 3, 1, 2))
        lo = torch.amin(d, dim=(1, 2), keepdim=True)
        hi = torch.amax(d, dim=(1, 2), keepdim=True)
        d01 = (d - lo) / torch.clamp(hi - lo, min=1e-6)
        outs.append(resize.bilinear(mm, d01, tuple(out_hw), hwc=False))
    return torch.cat(outs)
