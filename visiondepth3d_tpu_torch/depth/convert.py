"""Weights in and out of the port's depth models.

- ``from_jax_params``: the JAX package's flax params (as numpy) -> a state
  dict with HF ``DepthAnythingForDepthEstimation`` key names, the inverse
  of ``visiondepth3d_tpu/depth/convert.py:convert_depth_anything``.
- ``from_jax_params_<family>``: the same for the other families, each the
  inverse of that family's JAX converter (``convert_dpt_classic``,
  ``convert_dpt_beit``, ``convert_dpt_hybrid``, ``convert_zoedepth``,
  ``convert_zoedepth_nk``); MiDaS v2's gives the port's BatchNorm-folded
  keys, since its JAX converter folds BatchNorm and cannot be inverted.
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


class _StateDict(dict):
    """A state dict filled from flax leaves, one method per layout."""

    def lin(self, prefix, d):  # Dense (I, O) -> Linear (O, I)
        self[f"{prefix}.weight"] = _t(np.asarray(d["kernel"]).T)
        if "bias" in d:
            self[f"{prefix}.bias"] = _t(d["bias"])

    def conv(self, prefix, d):  # HWIO -> OIHW
        self[f"{prefix}.weight"] = _t(np.asarray(d["kernel"]).transpose(3, 2, 0, 1))
        if "bias" in d:
            self[f"{prefix}.bias"] = _t(d["bias"])

    def conv1x1(self, prefix, d):  # Dense (I, O) -> Conv2d (O, I, 1, 1)
        self[f"{prefix}.weight"] = _t(np.asarray(d["kernel"]).T[:, :, None, None])
        self[f"{prefix}.bias"] = _t(d["bias"])

    def ln(self, prefix, d):  # LayerNorm / GroupNorm
        self[f"{prefix}.weight"] = _t(d["scale"])
        self[f"{prefix}.bias"] = _t(d["bias"])

    def patch_embed(self, prefix, d, patch: int, hidden: int):
        # Dense (p * p * 3, C) ordered (dy, dx, c) -> Conv2d (C, 3, p, p)
        pe = np.asarray(d["kernel"]).reshape(patch, patch, 3, hidden)
        self[f"{prefix}.weight"] = _t(pe.transpose(3, 2, 0, 1))
        self[f"{prefix}.bias"] = _t(d["bias"])

    def reassemble(self, prefix, d, factor):
        self.conv1x1(f"{prefix}.projection", d["projection"])
        if factor > 1:  # (C, f, f, O) -> ConvTranspose2d (C, O, f, f)
            self[f"{prefix}.resize.weight"] = _t(
                np.asarray(d["resize"]["kernel"]).transpose(0, 3, 1, 2))
            self[f"{prefix}.resize.bias"] = _t(d["resize"]["bias"])
        elif factor < 1:
            self.conv(f"{prefix}.resize", d["resize"])

    def residual(self, prefix, d):
        self.conv(f"{prefix}.convolution1", d["conv1"])
        self.conv(f"{prefix}.convolution2", d["conv2"])


def from_jax_params(params: dict, cfg: DPTConfig) -> dict[str, torch.Tensor]:
    """Flax params of ``visiondepth3d_tpu.depth.dpt.DepthAnything`` -> an
    HF-keyed state dict for ``depth.dpt.DepthAnything``."""
    bb, nh = params["backbone"], params["neck_head"]
    p, hid = cfg.backbone.patch_size, cfg.backbone.hidden_size
    sd = _StateDict()
    lin, conv, conv1x1, ln = sd.lin, sd.conv, sd.conv1x1, sd.ln

    emb = "backbone.embeddings"
    sd[f"{emb}.cls_token"] = _t(bb["cls_token"])
    sd[f"{emb}.position_embeddings"] = _t(bb["pos_embed"])
    sd.patch_embed(f"{emb}.patch_embeddings.projection", bb["patch_embed"]["proj"], p, hid)
    ln("backbone.layernorm", bb["norm"])
    for i in range(cfg.backbone.num_layers):
        blk, pre = bb[f"block{i}"], f"backbone.encoder.layer.{i}"
        ln(f"{pre}.norm1", blk["norm1"])
        ln(f"{pre}.norm2", blk["norm2"])
        _qkv(sd, f"{pre}.attention", blk["attn"], hid)
        lin(f"{pre}.mlp.fc1", blk["mlp"]["fc1"])
        lin(f"{pre}.mlp.fc2", blk["mlp"]["fc2"])
        if cfg.backbone.layerscale:
            sd[f"{pre}.layer_scale1.lambda1"] = _t(blk["ls1"])
            sd[f"{pre}.layer_scale2.lambda1"] = _t(blk["ls2"])

    for i, factor in enumerate(cfg.reassemble_factors):
        sd.reassemble(f"neck.reassemble_stage.layers.{i}", nh[f"reassemble{i}"], factor)
    for i in range(len(cfg.neck_hidden_sizes)):
        conv(f"neck.convs.{i}", nh[f"scratch{i}"])
        fusion, pre = nh[f"fusion{i}"], f"neck.fusion_stage.layers.{i}"
        conv1x1(f"{pre}.projection", fusion["projection"])
        if i > 0:
            sd.residual(f"{pre}.residual_layer1", fusion["res1"])
        sd.residual(f"{pre}.residual_layer2", fusion["res2"])
    conv("head.conv1", nh["head_conv1"])
    conv("head.conv2", nh["head_conv2"])
    conv1x1("head.conv3", nh["head_conv3"])
    return dict(sd)


def _qkv(sd: _StateDict, prefix: str, attn: dict, hid: int):
    """A fused (C, 3C) ``qkv`` Dense -> HF's query/key/value Linears, and
    the output projection."""
    w, b = np.asarray(attn["qkv"]["kernel"]), np.asarray(attn["qkv"]["bias"])
    for j, name in enumerate(("query", "key", "value")):
        sd.lin(f"{prefix}.attention.{name}",
               {"kernel": w[:, j * hid:(j + 1) * hid], "bias": b[j * hid:(j + 1) * hid]})
    sd.lin(f"{prefix}.output.dense", attn["proj"])


def _vit_layers(sd: _StateDict, prefix: str, params: dict, vit) -> None:
    """The plain ViT's blocks (``block{i}``) -> HF ``DPTViTLayer`` keys."""
    for i in range(vit.num_layers):
        blk, pre = params[f"block{i}"], f"{prefix}.layer.{i}"
        sd.ln(f"{pre}.layernorm_before", blk["norm1"])
        sd.ln(f"{pre}.layernorm_after", blk["norm2"])
        _qkv(sd, f"{pre}.attention", blk["attn"], vit.hidden_size)
        sd.lin(f"{pre}.intermediate.dense", blk["mlp"]["fc1"])
        sd.lin(f"{pre}.output.dense", blk["mlp"]["fc2"])


def _beit(sd: _StateDict, bb: dict, cfg) -> None:
    """The JAX BEiT backbone -> HF ``backbone.*`` keys."""
    sd["backbone.embeddings.cls_token"] = _t(bb["cls_token"])
    sd.patch_embed("backbone.embeddings.patch_embeddings.projection",
                   bb["patch_embed"]["proj"], cfg.patch_size, cfg.hidden_size)
    for i in range(cfg.num_layers):
        blk, pre = bb[f"block{i}"], f"backbone.encoder.layer.{i}"
        sd.ln(f"{pre}.layernorm_before", blk["norm1"])
        sd.ln(f"{pre}.layernorm_after", blk["norm2"])
        sd[f"{pre}.lambda_1"] = _t(blk["ls1"])
        sd[f"{pre}.lambda_2"] = _t(blk["ls2"])
        for name, key in (("query", "q"), ("key", "k"), ("value", "v")):
            sd.lin(f"{pre}.attention.attention.{name}", blk["attn"][key])
        sd[f"{pre}.attention.attention.relative_position_bias.relative_position_bias_table"] = \
            _t(blk["rel_bias"]["table"])
        sd.lin(f"{pre}.attention.output.dense", blk["attn"]["proj"])
        sd.lin(f"{pre}.intermediate.dense", blk["mlp"]["fc1"])
        sd.lin(f"{pre}.output.dense", blk["mlp"]["fc2"])


def _neck(sd: _StateDict, params: dict, cfg, factors: dict) -> None:
    """Readout + reassemble of the stages in ``factors`` ({stage: factor}),
    the ``convs`` and the fusion stages -> HF ``neck.*`` keys."""
    for i, factor in factors.items():
        sd.lin(f"neck.reassemble_stage.readout_projects.{i}.0", params[f"readout{i}"])
        sd.reassemble(f"neck.reassemble_stage.layers.{i}", params[f"reassemble{i}"], factor)
    for i in range(len(cfg.neck_hidden_sizes)):
        pre = f"neck.fusion_stage.layers.{i}"
        sd.conv(f"neck.convs.{i}", params[f"scratch{i}"])
        sd.conv1x1(f"{pre}.projection", params[f"fusion{i}_proj"])
        if i > 0:
            sd.residual(f"{pre}.residual_layer1", params[f"fusion{i}_res1"])
        sd.residual(f"{pre}.residual_layer2", params[f"fusion{i}_res2"])


def _dpt_head(sd: _StateDict, params: dict) -> None:
    sd.conv("head.head.0", params["head_conv1"])
    sd.conv("head.head.2", params["head_conv2"])
    sd.conv1x1("head.head.4", params["head_conv3"])


def from_jax_params_dpt_classic(params: dict, cfg) -> dict[str, torch.Tensor]:
    """Flax params of the JAX ``DPTClassic`` -> HF-keyed ``DPTClassic`` state."""
    bb, vit = params["backbone"], cfg.backbone
    sd = _StateDict()
    sd["dpt.embeddings.cls_token"] = _t(bb["cls_token"])
    sd["dpt.embeddings.position_embeddings"] = _t(bb["pos_embed"])
    sd.patch_embed("dpt.embeddings.patch_embeddings.projection", bb["patch_embed"]["proj"],
                   vit.patch_size, vit.hidden_size)
    _vit_layers(sd, "dpt.encoder", bb, vit)
    _neck(sd, params, cfg, dict(enumerate(cfg.reassemble_factors)))
    _dpt_head(sd, params)
    return dict(sd)


def from_jax_params_dpt_beit(params: dict, cfg) -> dict[str, torch.Tensor]:
    """Flax params of the JAX ``DPTBEiT`` -> HF-keyed ``DPTBEiT`` state."""
    sd = _StateDict()
    _beit(sd, params["backbone"], cfg.backbone)
    _neck(sd, params, cfg, dict(enumerate(cfg.reassemble_factors)))
    _dpt_head(sd, params)
    return dict(sd)


def from_jax_params_dpt_hybrid(params: dict, cfg) -> dict[str, torch.Tensor]:
    """Flax params of the JAX ``DPTHybrid`` -> HF-keyed ``DPTHybrid`` state."""
    sd = _StateDict()
    bit, pre = params["bit"], "dpt.embeddings.backbone.bit"
    sd.conv(f"{pre}.embedder.convolution", bit["stem_conv"])
    sd.ln(f"{pre}.embedder.norm", bit["stem_norm"]["gn"])
    for si, depth in enumerate(cfg.bit.depths):
        for li in range(depth):
            layer, lp = bit[f"stage{si}_layer{li}"], f"{pre}.encoder.stages.{si}.layers.{li}"
            for j in (1, 2, 3):
                sd.conv(f"{lp}.conv{j}", layer[f"conv{j}"])
                sd.ln(f"{lp}.norm{j}", layer[f"norm{j}"]["gn"])
            if "down_conv" in layer:
                sd.conv(f"{lp}.downsample.conv", layer["down_conv"])
                sd.ln(f"{lp}.downsample.norm", layer["down_norm"]["gn"])
    sd["dpt.embeddings.cls_token"] = _t(params["cls_token"])
    sd["dpt.embeddings.position_embeddings"] = _t(params["pos_embed"])
    sd.conv1x1("dpt.embeddings.projection", params["projection"])
    _vit_layers(sd, "dpt.encoder", params, cfg.backbone)
    _neck(sd, params, cfg, {j + 2: f for j, f in enumerate(cfg.reassemble_factors)})
    _dpt_head(sd, params)
    return dict(sd)


def _zoe_trunk(sd: _StateDict, params: dict, cfg) -> None:
    _beit(sd, params["backbone"], cfg.backbone)
    _neck(sd, params, cfg, dict(enumerate(cfg.reassemble_factors)))
    sd.conv("relative_head.conv1", params["rel_conv1"])
    sd.conv("relative_head.conv2", params["rel_conv2"])
    sd.conv1x1("relative_head.conv3", params["rel_conv3"])


def _two_conv(sd: _StateDict, prefix: str, d: dict) -> None:
    sd.conv1x1(f"{prefix}.conv1", d["conv1"])
    sd.conv1x1(f"{prefix}.conv2", d["conv2"])


def _clb(sd: _StateDict, prefix: str, d: dict) -> None:
    sd.conv1x1(f"{prefix}.mlp.0", d["mlp1"])
    sd.conv1x1(f"{prefix}.mlp.2", d["mlp2"])


def from_jax_params_zoedepth(params: dict, cfg) -> dict[str, torch.Tensor]:
    """Flax params of the JAX ``ZoeDepth`` -> HF-keyed ``ZoeDepth`` state."""
    sd = _StateDict()
    _zoe_trunk(sd, params, cfg)
    sd.conv1x1("metric_head.conv2", params["metric_conv2"])
    _two_conv(sd, "metric_head.seed_bin_regressor", params["seed_bin"])
    _two_conv(sd, "metric_head.seed_projector", params["seed_proj"])
    for i in range(4):
        _two_conv(sd, f"metric_head.projectors.{i}", params[f"proj{i}"])
        _two_conv(sd, f"metric_head.attractors.{i}", params[f"attractor{i}"])
    _clb(sd, "metric_head.conditional_log_binomial", params["clb"])
    return dict(sd)


def from_jax_params_zoedepth_nk(params: dict, cfg) -> dict[str, torch.Tensor]:
    """Flax params of the JAX ``ZoeDepthNK`` -> HF-keyed ``ZoeDepthNK`` state."""
    sd = _StateDict()
    _zoe_trunk(sd, params["trunk"], cfg.base)
    mh = "metric_head"
    sd.conv1x1(f"{mh}.conv2", params["metric_conv2"])
    sd.conv1x1(f"{mh}.patch_transformer.embedding_convPxP", params["pt_embed"])
    for i in range(cfg.num_patch_transformer_layers):
        layer, pre = params[f"pt{i}"], f"{mh}.patch_transformer.transformer_encoder.{i}"
        for name, key in (("query", "q"), ("key", "k"), ("value", "v"), ("out_proj", "out")):
            sd.lin(f"{pre}.self_attn.{name}", layer[key])
        for name in ("linear1", "linear2"):
            sd.lin(f"{pre}.{name}", layer[name])
        for name in ("norm1", "norm2"):
            sd.ln(f"{pre}.{name}", layer[name])
    sd.lin(f"{mh}.mlp_classifier.linear1", params["clf1"])
    sd.lin(f"{mh}.mlp_classifier.linear2", params["clf2"])
    _two_conv(sd, f"{mh}.seed_projector", params["seed_proj"])
    for i in range(4):
        _two_conv(sd, f"{mh}.projectors.{i}", params[f"proj{i}"])
    for dom in cfg.domains:
        _two_conv(sd, f"{mh}.seed_bin_regressors.{dom.name}", params[f"seed_{dom.name}"])
        for i in range(4):
            _two_conv(sd, f"{mh}.attractors.{dom.name}.{i}", params[f"attr_{dom.name}_{i}"])
        _clb(sd, f"{mh}.conditional_log_binomial.{dom.name}", params[f"clb_{dom.name}"])
    return dict(sd)


def from_jax_params_midas_v2(params: dict, cfg) -> dict[str, torch.Tensor]:
    """Flax params of the JAX ``MidasNetSmall`` (BatchNorm folded) -> the
    port's ``MidasNetSmall`` state."""
    sd = _StateDict()
    sd.conv("pretrained.conv_stem", params["stem"])
    for si, (e, _, n, _, _) in enumerate(cfg.stages):
        for j in range(n):
            blk, pre = params[f"stage{si}_block{j}"], f"pretrained.blocks.{si}.{j}"
            names = (("dw", "conv_dw"), ("pwl", "conv_pw")) if e == 1 else \
                (("pw", "conv_pw"), ("dw", "conv_dw"), ("pwl", "conv_pwl"))
            for key, name in names:
                sd.conv(f"{pre}.{name}", blk[key])
    n_taps = len(cfg.taps)
    for i in range(n_taps):
        sd.conv(f"scratch.layer{i + 1}_rn", params[f"layer{i + 1}_rn"])
    for npos in range(1, n_taps + 1):
        blk, pre = params[f"refinenet{npos}"], f"scratch.refinenet{npos}"
        for res, unit in (("res1", "resConfUnit1"), ("res2", "resConfUnit2")):
            if res in blk:
                sd.conv(f"{pre}.{unit}.conv1", blk[res]["conv1"])
                sd.conv(f"{pre}.{unit}.conv2", blk[res]["conv2"])
        sd.conv1x1(f"{pre}.out_conv", blk["projection"])
    sd.conv("scratch.output_conv.0", params["out_conv0"])
    sd.conv("scratch.output_conv.2", params["out_conv2"])
    sd.conv1x1("scratch.output_conv.4", params["out_conv4"])
    return dict(sd)


def load_hf_state_dict(model: nn.Module, state: dict,
                       unused: tuple = UNUSED_HF_KEYS) -> nn.Module:
    """Load an HF-keyed state dict; every model parameter must be present,
    and every extra key must start with one of ``unused`` (the family's
    keys the port's model does not hold; Depth Anything's by default)."""
    keep = {k: v for k, v in state.items() if not k.startswith(unused)}
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
