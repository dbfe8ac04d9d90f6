"""Apple Depth Pro: a multi-scale patched DINOv2 encoder, an image encoder,
a DPT-style fusion with transposed-conv upsampling, the depth head and the
field-of-view head, as a plain forward over a state dict in transformers'
``DepthProForDepthEstimation`` names.

Written from the published architecture (Bochkovskii et al., "Depth Pro:
Sharp Monocular Metric Depth in Less Than a Second", arXiv:2410.02073) and
transformers' ``modeling_depth_pro.py``: the image rescaled to each of
``scaled_images_ratios``, each scale cut into ``patch_size`` windows that
overlap by its ratio (row-major, each window's batch contiguous), every
window of every scale through the patch encoder (a DINOv2), the windows
merged back with ``merge_padding_value`` (divided by the scale's ratio, at
most a quarter of the window's grid) trimmed at the inner seams, the raw
outputs of the ``intermediate_hook_ids`` blocks (0-based) of the full-size
windows merged likewise; a second DINOv2 on the image at its size; the
features upsampled by 1x1 projections and 2x transposed convolutions, the
image's fused with the lowest scale's, projected to ``fusion_hidden_size``
by 3x3 convolutions; the fusion stage lowest resolution first (pre-activated
residual units, a 2x transposed convolution each step); the head (3x3, 2x
transposed, 3x3, ReLU, 1x1, ReLU). Attention is softmax(q k^T / sqrt(d)) v
written out, GELU the exact one.

Departures: every resampling (the rescales, the merged features' resize to
the base grid, the FOV head's) is the render's bilinear resize as weight
matrices (``resize.py``, align_corners False) where transformers calls
``F.interpolate``; a position-embedding regrid, which the published sizes
never need, is ``resize.bicubic``. ``predict_01`` is the render's use of
the model: the frames resized to the inference size, normalized by HF's
0.5 / 0.5 statistics, the depth normalized per frame to [0, 1] and resized
to the eye; the field of view is not computed there (the render discards
it).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import resize
from .depth_anything import _attention, _conv, _ln
from .precision import Mat

STANDARD_MEAN = (0.5, 0.5, 0.5)
STANDARD_STD = (0.5, 0.5, 0.5)
GROUP = 2  # frames through the model at a time: two frames' activations fit beside the run


def _vit_cfg(c: dict) -> dict:
    return {"hidden": c["hidden_size"], "layers": c["num_hidden_layers"],
            "heads": c["num_attention_heads"], "mlp_ratio": c["mlp_ratio"],
            "patch": c["patch_size"], "image_size": c["image_size"],
            "eps": c["layer_norm_eps"], "layerscale": c["layerscale_value"]}


def model_cfg(conf: dict) -> dict:
    """The sizes of an HF ``config.json`` the forward reads."""
    return {"patch_model": _vit_cfg(conf["patch_model_config"]),
            "image_model": _vit_cfg(conf["image_model_config"]),
            "fov_model": _vit_cfg(conf["fov_model_config"]),
            "window": conf["patch_size"], "ratios": tuple(conf["scaled_images_ratios"]),
            "overlaps": tuple(conf["scaled_images_overlap_ratios"]),
            "dims": tuple(conf["scaled_images_feature_dims"]),
            "hooks": tuple(conf["intermediate_hook_ids"]),
            "inter": tuple(conf["intermediate_feature_dims"]),
            "fusion": conf["fusion_hidden_size"], "merge_pad": conf["merge_padding_value"],
            "fov_layers": conf["num_fov_head_layers"], "use_fov": bool(conf["use_fov_model"])}


def param_specs(cfg: dict) -> list[tuple[str, tuple, str, float]]:
    """(name, shape, init, scale) of every weight, in transformers' names
    (without the encoders' unused masked-image tokens). init: ``normal``
    N(0, 1) times scale (fan_in^-1/2 for a product's weight, 0.02 for the
    class tokens and position embeddings), ``fill`` the constant scale
    (norm gains and biases, layer-scale gains)."""
    f = cfg["fusion"]
    out: list = []

    def w(name, shape, fan_in):
        out.append((name, tuple(shape), "normal", fan_in ** -0.5))

    def const(name, shape, value):
        out.append((name, tuple(shape), "fill", float(value)))

    def bias(name, n):
        const(f"{name}.bias", (n,), 0.0)

    def lin(name, cout, cin):  # a Linear: (out, in)
        w(f"{name}.weight", (cout, cin), cin)
        bias(name, cout)

    def conv(name, cout, cin, k, has_bias=True):  # a Conv2d: (out, in, k, k)
        w(f"{name}.weight", (cout, cin, k, k), cin * k * k)
        if has_bias:
            bias(name, cout)

    def deconv(name, cin, cout, has_bias):  # 2x2, stride 2: each output sums cin inputs
        w(f"{name}.weight", (cin, cout, 2, 2), cin)
        if has_bias:
            bias(name, cout)

    def vit(pre, v):
        c, p = v["hidden"], v["patch"]
        side = v["image_size"] // p
        e = f"{pre}.embeddings"
        out.append((f"{e}.cls_token", (1, 1, c), "normal", 0.02))
        out.append((f"{e}.position_embeddings", (1, side * side + 1, c), "normal", 0.02))
        conv(f"{e}.patch_embeddings.projection", c, 3, p)
        for i in range(v["layers"]):
            b = f"{pre}.encoder.layer.{i}"
            const(f"{b}.norm1.weight", (c,), 1.0)
            bias(f"{b}.norm1", c)
            for k in ("query", "key", "value"):
                lin(f"{b}.attention.attention.{k}", c, c)
            lin(f"{b}.attention.output.dense", c, c)
            const(f"{b}.layer_scale1.lambda1", (c,), v["layerscale"])
            const(f"{b}.norm2.weight", (c,), 1.0)
            bias(f"{b}.norm2", c)
            lin(f"{b}.mlp.fc1", c * v["mlp_ratio"], c)
            lin(f"{b}.mlp.fc2", c, c * v["mlp_ratio"])
            const(f"{b}.layer_scale2.lambda1", (c,), v["layerscale"])
        const(f"{pre}.layernorm.weight", (c,), 1.0)
        bias(f"{pre}.layernorm", c)

    def preact(name):
        for cv in ("convolution1", "convolution2"):
            conv(f"{name}.{cv}", f, f, 3)

    vit("depth_pro.encoder.patch_encoder.model", cfg["patch_model"])
    vit("depth_pro.encoder.image_encoder.model", cfg["image_model"])
    hid, dims, inter = cfg["patch_model"]["hidden"], cfg["dims"], cfg["inter"]
    up = "depth_pro.neck.feature_upsample"
    deconv(f"{up}.image_block.layers.0", cfg["image_model"]["hidden"], dims[0], True)
    for i, d in enumerate(dims):
        conv(f"{up}.scaled_images.{i}.layers.0", d, hid, 1, has_bias=False)
        deconv(f"{up}.scaled_images.{i}.layers.1", d, d, False)
    for i, d in enumerate(inter):
        mid = f if i == 0 else d
        conv(f"{up}.intermediate.{i}.layers.0", mid, hid, 1, has_bias=False)
        for j in range(2 + i):
            deconv(f"{up}.intermediate.{i}.layers.{j + 1}", mid if j == 0 else d, d, False)
    conv("depth_pro.neck.fuse_image_with_low_res", dims[0], 2 * dims[0], 1)
    all_dims = dims + inter
    for i, d in enumerate(all_dims):
        if not (i == len(all_dims) - 1 and d == f):
            conv(f"depth_pro.neck.feature_projection.projections.{i}", f, d, 3, has_bias=False)
    for i in range(len(all_dims)):
        name = (f"fusion_stage.intermediate.{i}" if i < len(all_dims) - 1
                else "fusion_stage.final")
        preact(f"{name}.residual_layer1")
        preact(f"{name}.residual_layer2")
        if i < len(all_dims) - 1:
            deconv(f"{name}.deconv", f, f, False)
        conv(f"{name}.projection", f, f, 1)
    conv("head.layers.0", f // 2, f, 3)
    deconv("head.layers.1", f // 2, f // 2, True)
    conv("head.layers.2", 32, f // 2, 3)
    conv("head.layers.4", 1, 32, 1)
    if cfg["use_fov"]:
        fv = cfg["fov_model"]
        vit("fov_model.fov_encoder.model", fv)
        lin("fov_model.fov_encoder.neck", f // 2, fv["hidden"])
        conv("fov_model.conv", f // 2, f, 3)
        n = cfg["fov_layers"]
        for i in range(n):
            conv(f"fov_model.head.layers.{2 * i}", math.ceil(f / 2 ** (i + 2)),
                 math.ceil(f / 2 ** (i + 1)), 3)
        k = int((cfg["image_model"]["image_size"] // cfg["image_model"]["patch"] - 1) / 2 ** n + 1)
        conv(f"fov_model.head.layers.{2 * n}", 1, math.ceil(f / 2 ** (n + 1)), k)
    return out


def vit(mm: Mat, sd: dict, v: dict, pre: str, pixels: torch.Tensor, hooks=()):
    """A DINOv2 over [B, 3, H, W] -> (the tokens after the final LayerNorm,
    [the raw outputs of the blocks in ``hooks``, 0-based])."""
    p, eps = v["patch"], v["eps"]
    gh, gw = pixels.shape[2] // p, pixels.shape[3] // p
    e = f"{pre}.embeddings"
    x = _conv(mm, pixels, sd, f"{e}.patch_embeddings.projection", stride=p, padding=0)
    x = x.flatten(2).transpose(1, 2)
    x = torch.cat([sd[f"{e}.cls_token"].expand(x.shape[0], -1, -1), x], dim=1)
    pos = sd[f"{e}.position_embeddings"]
    side = int(round((pos.shape[1] - 1) ** 0.5))
    if (gh, gw) != (side, side):
        grid = resize.bicubic(mm, pos[0, 1:].reshape(side, side, -1), (gh, gw), hwc=True)
        pos = torch.cat([pos[:, :1], grid.reshape(1, gh * gw, -1)], dim=1)
    x = x + pos
    tapped = {}
    for i in range(v["layers"]):
        b = f"{pre}.encoder.layer.{i}"
        x = x + sd[f"{b}.layer_scale1.lambda1"] * _attention(
            mm, _ln(x, sd, f"{b}.norm1", eps), sd, b, v["heads"])
        h = mm.linear(_ln(x, sd, f"{b}.norm2", eps), sd[f"{b}.mlp.fc1.weight"],
                      sd[f"{b}.mlp.fc1.bias"])
        h = mm.linear(F.gelu(h), sd[f"{b}.mlp.fc2.weight"], sd[f"{b}.mlp.fc2.bias"])
        x = x + sd[f"{b}.layer_scale2.lambda1"] * h
        if i in hooks:
            tapped[i] = x
    return _ln(x, sd, f"{pre}.layernorm", eps), [tapped[i] for i in hooks]


def windows(x: torch.Tensor, size: int, overlap: float) -> torch.Tensor:
    """[B, C, H, W] -> [n * B, C, size, size], windows row-major, each
    window's batch contiguous."""
    h, w = x.shape[2], x.shape[3]
    if h == size and w == size:
        return x
    stride = int(size * (1 - overlap))
    return torch.cat([x[:, :, i: i + size, j: j + size] for i in range(0, h - size + 1, stride)
                      for j in range(0, w - size + 1, stride)])


def merge(mm: Mat, tokens: torch.Tensor, batch: int, padding: int, out_hw) -> torch.Tensor:
    """[n * B, 1 + s * s, C] window tokens -> [B, C, out_h, out_w]: the
    class token dropped, the windows laid side by side with ``padding``
    trimmed at each inner seam (none under four windows, at most s // 4),
    then resized."""
    n, seq, c = tokens.shape
    s = math.isqrt(seq)
    grid = tokens[:, -s * s:].reshape(n, s, s, c).permute(0, 3, 1, 2)
    k = math.isqrt(n // batch)
    if n != batch:
        pad = 0 if n // batch < 4 else min(s // 4, padding)
        rows = []
        for i in range(k):
            row = []
            for j in range(k):
                box = grid[batch * (i * k + j): batch * (i * k + j + 1)]
                box = box[:, :, (pad if i else 0): s - (pad if i < k - 1 else 0),
                          (pad if j else 0): s - (pad if j < k - 1 else 0)]
                row.append(box)
            rows.append(torch.cat(row, dim=3))
        grid = torch.cat(rows, dim=2)
    return resize.bilinear(mm, grid, tuple(out_hw), hwc=False)


def _deconv(mm: Mat, x, sd, name):
    return mm.conv_transpose2d(x, sd[f"{name}.weight"], sd.get(f"{name}.bias"), stride=2)


def _conv_nb(mm: Mat, x, sd, name, stride=1):
    """A convolution with or without a bias (padding k // 2)."""
    wgt = sd[f"{name}.weight"]
    return mm.conv2d(x, wgt, sd.get(f"{name}.bias"), stride=stride, padding=wgt.shape[-1] // 2)


def _preact(mm, x, sd, name):
    h = _conv_nb(mm, F.relu(x), sd, f"{name}.convolution1")
    return x + _conv_nb(mm, F.relu(h), sd, f"{name}.convolution2")


def _fusion_layer(mm, sd, name, x, residual, deconv: bool):
    if residual is not None:
        x = x + _preact(mm, residual, sd, f"{name}.residual_layer1")
    x = _preact(mm, x, sd, f"{name}.residual_layer2")
    if deconv:
        x = _deconv(mm, x, sd, f"{name}.deconv")
    return _conv_nb(mm, x, sd, f"{name}.projection")


def forward(mm: Mat, sd: dict, cfg: dict, pixels: torch.Tensor, fov: bool = True):
    """[B, 3, S, S] normalized pixels -> (depth [B, S, S], field of view [B]
    or None)."""
    b, _, h, w = pixels.shape
    im = cfg["image_model"]
    out_size = im["image_size"] // im["patch"]
    exp = int(math.log2(w / out_size))
    base_h, base_w = h // 2 ** exp, w // 2 ** exp
    ratios, n_scaled = cfg["ratios"], len(cfg["ratios"])

    # the patch encoder over every window of every scale, high resolution first
    scaled, counts = [], []
    for r, overlap in zip(ratios, cfg["overlaps"]):
        img = resize.bilinear(mm, pixels, (int(h * r), int(w * r)), hwc=False)
        tiles = windows(img, cfg["window"], overlap)
        scaled.append(tiles)
        counts.append(tiles.shape[0])
    last, taps = vit(mm, sd, cfg["patch_model"], "depth_pro.encoder.patch_encoder.model",
                     torch.cat(scaled[::-1]), cfg["hooks"])
    del scaled
    per_scale = torch.split(last, counts[::-1])[::-1]
    feats = [merge(mm, per_scale[i], b, int(cfg["merge_pad"] / ratios[i]),
                   (base_h * 2 ** i, base_w * 2 ** i)) for i in range(n_scaled)]
    top = 2 ** (n_scaled - 1)
    for t in taps:
        feats.append(merge(mm, t[:counts[-1]], b, int(cfg["merge_pad"] / ratios[-1]),
                           (base_h * top, base_w * top)))
    del last, per_scale, taps

    # the image encoder
    img = resize.bilinear(mm, pixels, (im["image_size"],) * 2, hwc=False)
    image_last, _ = vit(mm, sd, im, "depth_pro.encoder.image_encoder.model", img)
    feats = [merge(mm, image_last, b, 0, (base_h, base_w)), *feats]

    # the neck
    up = "depth_pro.neck.feature_upsample"
    feats[0] = _deconv(mm, feats[0], sd, f"{up}.image_block.layers.0")
    for i in range(n_scaled):
        x = _conv_nb(mm, feats[i + 1], sd, f"{up}.scaled_images.{i}.layers.0")
        feats[i + 1] = _deconv(mm, x, sd, f"{up}.scaled_images.{i}.layers.1")
    for i in range(len(cfg["hooks"])):
        x = _conv_nb(mm, feats[n_scaled + 1 + i], sd, f"{up}.intermediate.{i}.layers.0")
        for j in range(2 + i):
            x = _deconv(mm, x, sd, f"{up}.intermediate.{i}.layers.{j + 1}")
        feats[n_scaled + 1 + i] = x
    low = _conv_nb(mm, torch.cat([feats[1], feats[0]], dim=1), sd,
                   "depth_pro.neck.fuse_image_with_low_res")
    feats = [low, *feats[2:]]
    proj = [_conv_nb(mm, x, sd, f"depth_pro.neck.feature_projection.projections.{i}")
            if f"depth_pro.neck.feature_projection.projections.{i}.weight" in sd else x
            for i, x in enumerate(feats)]
    del feats, low

    # the fusion stage, lowest resolution first, and the head
    fused = None
    for i in range(len(proj) - 1):
        fused = _fusion_layer(mm, sd, f"fusion_stage.intermediate.{i}",
                              proj[i] if fused is None else fused,
                              None if fused is None else proj[i], True)
    fused = _fusion_layer(mm, sd, "fusion_stage.final", fused, proj[-1], False)
    x = _conv_nb(mm, fused, sd, "head.layers.0")
    del fused
    x = _deconv(mm, x, sd, "head.layers.1")
    x = F.relu(_conv_nb(mm, x, sd, "head.layers.2"))
    depth = F.relu(_conv_nb(mm, x, sd, "head.layers.4"))[:, 0]
    if not (fov and cfg["use_fov"]):
        return depth, None

    # the field-of-view head on the FOV encoder and the projected global features
    fv = cfg["fov_model"]
    img = resize.bilinear(mm, pixels, (fv["image_size"],) * 2, hwc=False)
    tokens, _ = vit(mm, sd, fv, "fov_model.fov_encoder.model", img)
    tokens = mm.linear(tokens, sd["fov_model.fov_encoder.neck.weight"],
                       sd["fov_model.fov_encoder.neck.bias"])
    ff = merge(mm, tokens, b, 0, (base_h, base_w))
    g = F.relu(_conv_nb(mm, proj[0], sd, "fov_model.conv", stride=2))
    ff = resize.bilinear(mm, ff + resize.bilinear(mm, g, tuple(ff.shape[2:]), hwc=False),
                         (out_size, out_size), hwc=False)
    for i in range(cfg["fov_layers"]):
        ff = F.relu(_conv_nb(mm, ff, sd, f"fov_model.head.layers.{2 * i}", stride=2))
    k = sd[f"fov_model.head.layers.{2 * cfg['fov_layers']}.weight"]
    ff = mm.conv2d(ff, k, sd[f"fov_model.head.layers.{2 * cfg['fov_layers']}.bias"])
    return depth, ff.reshape(b, -1)[:, 0]


def predict_01(mm: Mat, sd: dict, cfg: dict, frames01: torch.Tensor, size: int,
               out_hw, ranges: list | None = None) -> torch.Tensor:
    """[T, H, W, 3] RGB in [0, 1] -> [T, out_h, out_w] depth in [0, 1], the
    model run on ``GROUP`` frames at a time (to bound the memory). Each
    frame's depth range (hi - lo) is appended to ``ranges`` when given."""
    mean = torch.tensor(STANDARD_MEAN, dtype=frames01.dtype, device=frames01.device)
    std = torch.tensor(STANDARD_STD, dtype=frames01.dtype, device=frames01.device)
    outs = []
    for i in range(0, frames01.shape[0], GROUP):
        x = resize.bilinear(mm, frames01[i:i + GROUP], (size, size), hwc=True)
        x = (x - mean) / std
        d, _ = forward(mm, sd, cfg, x.permute(0, 3, 1, 2), fov=False)
        lo = torch.amin(d, dim=(1, 2), keepdim=True)
        hi = torch.amax(d, dim=(1, 2), keepdim=True)
        if ranges is not None:
            ranges.extend((hi - lo).flatten().tolist())
        d01 = (d - lo) / torch.clamp(hi - lo, min=1e-6)
        outs.append(resize.bilinear(mm, d01, tuple(out_hw), hwc=False))
    return torch.cat(outs)
