"""Weights in and out of the port's Depth Anything model.

- ``from_jax_params``: the JAX package's flax params (as numpy) -> a state
  dict with HF ``DepthAnythingForDepthEstimation`` key names, the inverse
  of ``visiondepth3d_tpu/depth/convert.py:convert_depth_anything``.
- ``load_safetensors``: a ``.safetensors`` file -> CPU tensors, read with
  the standard library (the format is a JSON header plus raw little-endian
  arrays), so no extra package is needed.
- ``load_hf_state_dict``: an HF state dict into the port's model.
"""

from __future__ import annotations

import json
import struct

import numpy as np
import torch
from torch import nn

from .configs import DPTConfig

# HF keys the port's model does not hold: the masked-image token, and the
# first fusion layer's residual unit, which has no residual input to act on.
UNUSED_HF_KEYS = ("backbone.embeddings.mask_token",
                  "neck.fusion_stage.layers.0.residual_layer1.")


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, dtype=np.float32)))


def from_jax_params(params: dict, cfg: DPTConfig) -> dict[str, torch.Tensor]:
    """Flax params of ``visiondepth3d_tpu.depth.dpt.DepthAnything`` -> an
    HF-keyed state dict for ``depth.dpt.DepthAnything``."""
    bb, nh = params["backbone"], params["neck_head"]
    p, hid = cfg.backbone.patch_size, cfg.backbone.hidden_size
    sd: dict[str, torch.Tensor] = {}

    def lin(prefix, d):  # Dense (I, O) -> Linear (O, I)
        sd[f"{prefix}.weight"] = _t(np.asarray(d["kernel"]).T)
        sd[f"{prefix}.bias"] = _t(d["bias"])

    def conv(prefix, d):  # HWIO -> OIHW
        sd[f"{prefix}.weight"] = _t(np.asarray(d["kernel"]).transpose(3, 2, 0, 1))
        if "bias" in d:
            sd[f"{prefix}.bias"] = _t(d["bias"])

    def conv1x1(prefix, d):  # Dense (I, O) -> Conv2d (O, I, 1, 1)
        sd[f"{prefix}.weight"] = _t(np.asarray(d["kernel"]).T[:, :, None, None])
        sd[f"{prefix}.bias"] = _t(d["bias"])

    def ln(prefix, d):
        sd[f"{prefix}.weight"] = _t(d["scale"])
        sd[f"{prefix}.bias"] = _t(d["bias"])

    emb = "backbone.embeddings"
    sd[f"{emb}.cls_token"] = _t(bb["cls_token"])
    sd[f"{emb}.position_embeddings"] = _t(bb["pos_embed"])
    pe = np.asarray(bb["patch_embed"]["proj"]["kernel"]).reshape(p, p, 3, hid)
    sd[f"{emb}.patch_embeddings.projection.weight"] = _t(pe.transpose(3, 2, 0, 1))
    sd[f"{emb}.patch_embeddings.projection.bias"] = _t(bb["patch_embed"]["proj"]["bias"])
    ln("backbone.layernorm", bb["norm"])
    for i in range(cfg.backbone.num_layers):
        blk, pre = bb[f"block{i}"], f"backbone.encoder.layer.{i}"
        ln(f"{pre}.norm1", blk["norm1"])
        ln(f"{pre}.norm2", blk["norm2"])
        qkv_w = np.asarray(blk["attn"]["qkv"]["kernel"])
        qkv_b = np.asarray(blk["attn"]["qkv"]["bias"])
        for j, name in enumerate(("query", "key", "value")):
            lin(f"{pre}.attention.attention.{name}",
                {"kernel": qkv_w[:, j * hid:(j + 1) * hid], "bias": qkv_b[j * hid:(j + 1) * hid]})
        lin(f"{pre}.attention.output.dense", blk["attn"]["proj"])
        lin(f"{pre}.mlp.fc1", blk["mlp"]["fc1"])
        lin(f"{pre}.mlp.fc2", blk["mlp"]["fc2"])
        if cfg.backbone.layerscale:
            sd[f"{pre}.layer_scale1.lambda1"] = _t(blk["ls1"])
            sd[f"{pre}.layer_scale2.lambda1"] = _t(blk["ls2"])

    for i, factor in enumerate(cfg.reassemble_factors):
        layer, pre = nh[f"reassemble{i}"], f"neck.reassemble_stage.layers.{i}"
        conv1x1(f"{pre}.projection", layer["projection"])
        if factor > 1:  # (C, f, f, O) -> ConvTranspose2d (C, O, f, f)
            sd[f"{pre}.resize.weight"] = _t(
                np.asarray(layer["resize"]["kernel"]).transpose(0, 3, 1, 2))
            sd[f"{pre}.resize.bias"] = _t(layer["resize"]["bias"])
        elif factor < 1:
            conv(f"{pre}.resize", layer["resize"])
    for i in range(len(cfg.neck_hidden_sizes)):
        conv(f"neck.convs.{i}", nh[f"scratch{i}"])
        fusion, pre = nh[f"fusion{i}"], f"neck.fusion_stage.layers.{i}"
        conv1x1(f"{pre}.projection", fusion["projection"])
        for res, hf in (("res1", "residual_layer1"), ("res2", "residual_layer2")):
            if res == "res1" and i == 0:
                continue
            conv(f"{pre}.{hf}.convolution1", fusion[res]["conv1"])
            conv(f"{pre}.{hf}.convolution2", fusion[res]["conv2"])
    conv("head.conv1", nh["head_conv1"])
    conv("head.conv2", nh["head_conv2"])
    conv1x1("head.conv3", nh["head_conv3"])
    return sd


def load_hf_state_dict(model: nn.Module, state: dict) -> nn.Module:
    """Load an HF-keyed state dict; every model parameter must be present,
    and every extra key must be one of ``UNUSED_HF_KEYS``."""
    keep = {k: v for k, v in state.items() if not k.startswith(UNUSED_HF_KEYS)}
    missing, unexpected = model.load_state_dict(keep, strict=False)
    if missing or unexpected:
        raise KeyError(f"checkpoint does not fit the model: missing {missing}, "
                       f"unexpected {unexpected}")
    return model


_SAFETENSORS_DTYPES = {"F32": np.float32, "F16": np.float16, "F64": np.float64,
                       "I64": np.int64, "I32": np.int32, "I16": np.int16,
                       "I8": np.int8, "U8": np.uint8, "BOOL": np.bool_}


def load_safetensors(path) -> dict[str, torch.Tensor]:
    """Read a .safetensors file into CPU tensors."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        data = f.read()
    out = {}
    for name, meta in header.items():
        if name == "__metadata__":
            continue
        start, end = meta["data_offsets"]
        raw = data[start:end]
        if meta["dtype"] == "BF16":
            u16 = np.frombuffer(raw, dtype="<u2").astype(np.uint32) << 16
            arr = u16.view(np.float32)
            out[name] = torch.from_numpy(arr.reshape(meta["shape"]).copy()).to(torch.bfloat16)
            continue
        if meta["dtype"] not in _SAFETENSORS_DTYPES:
            raise ValueError(f"{path}: unsupported dtype {meta['dtype']} for {name}")
        arr = np.frombuffer(raw, dtype=np.dtype(_SAFETENSORS_DTYPES[meta["dtype"]]).newbyteorder("<"))
        out[name] = torch.from_numpy(arr.reshape(meta["shape"]).copy())
    return out
