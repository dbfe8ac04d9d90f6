"""Weights in and out of the port's depth models.

- ``from_jax_params``: the JAX package's flax params (as numpy) -> a state
  dict with HF ``DepthAnythingForDepthEstimation`` key names, the inverse
  of ``visiondepth3d_tpu/depth/convert.py:convert_depth_anything``.
- ``from_jax_params_<family>``: the same for the other families, each the
  inverse of that family's JAX converter (``convert_dpt_classic``,
  ``convert_dpt_beit``, ``convert_dpt_hybrid``, ``convert_zoedepth``,
  ``convert_zoedepth_nk``); MiDaS v2's gives the port's BatchNorm-folded
  keys, since its JAX converter folds BatchNorm and cannot be inverted.
- ``from_jax_tree(family, ...)``: any family of ``JAX_FAMILIES`` (Depth Pro
  and VDA, the inverses of ``convert_depth_pro`` and ``convert_vda``, only
  through it); what ``load_predictor`` reads a native folder with.
- ``to_jax_params``: the port's state dict -> the family's JAX params tree,
  each map above run backwards (what ``vd3d-torch convert`` writes as a
  ``format: "native"`` folder, the layout of the JAX ``vd3d convert``).
- ``load_safetensors`` / ``save_safetensors``: ``.safetensors`` files read
  and written with the standard library (the format is a JSON header plus
  raw little-endian arrays), so no extra package is needed.
- ``load_hf_state_dict``: an HF state dict into the port's model.
"""

from __future__ import annotations

import dataclasses
import json
import math
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


def _np(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().float().numpy()
    return np.asarray(v, dtype=np.float32)


class _Tree(dict):
    """A flax params tree that grows each node a map reads (``to_jax_params``)."""

    def __missing__(self, key):
        node = self[key] = _Tree()
        return node


def _plain(node):
    return {k: _plain(v) for k, v in node.items()} if isinstance(node, dict) else node


# (flax leaf -> state-dict tensor, and back), per layout
_SAME = (lambda a: a, lambda a: a)
_DENSE = (lambda a: a.T, lambda a: a.T)  # Dense (I, O) <-> Linear (O, I)
_CONV = (lambda a: a.transpose(3, 2, 0, 1), lambda a: a.transpose(2, 3, 1, 0))  # HWIO <-> OIHW
_CONV1X1 = (lambda a: a.T[:, :, None, None], lambda a: a[:, :, 0, 0].T)  # Dense <-> (O, I, 1, 1)
_DECONV = (lambda a: a.transpose(0, 3, 1, 2),  # (C, f, f, O) <-> ConvTranspose2d (C, O, f, f)
           lambda a: a.transpose(0, 2, 3, 1))


class _StateDict(dict):
    """A state dict filled from flax leaves, one method per layout.

    Built over a state dict (``state``), every method runs the other way:
    it reads the tensors and fills the flax tree it is handed (a ``_Tree``),
    so one map per family gives both ``from_jax_params*`` and
    ``to_jax_params``."""

    def __init__(self, state: dict | None = None):
        super().__init__()
        self.state = None if state is None else {k: _np(v) for k, v in state.items()}

    def leaf(self, key, node, name, layout=_SAME):
        if self.state is None:
            self[key] = _t(layout[0](np.asarray(node[name])))
        else:
            node[name] = np.ascontiguousarray(layout[1](self.state[key]), dtype=np.float32)

    def has(self, key, node, name) -> bool:
        """Whether an optional leaf or node is there: in the flax tree, or,
        the other way, its tensor in the state dict."""
        return name in node if self.state is None else key in self.state

    def _with_bias(self, prefix, d, layout):
        self.leaf(f"{prefix}.weight", d, "kernel", layout)
        if self.has(f"{prefix}.bias", d, "bias"):
            self.leaf(f"{prefix}.bias", d, "bias")

    def lin(self, prefix, d):
        self._with_bias(prefix, d, _DENSE)

    def conv(self, prefix, d):
        self._with_bias(prefix, d, _CONV)

    def conv1x1(self, prefix, d):
        self._with_bias(prefix, d, _CONV1X1)

    def deconv(self, prefix, d):
        self._with_bias(prefix, d, _DECONV)

    def ln(self, prefix, d):  # LayerNorm / GroupNorm
        self.leaf(f"{prefix}.weight", d, "scale")
        self.leaf(f"{prefix}.bias", d, "bias")

    def patch_embed(self, prefix, d, patch: int, hidden: int):
        # Dense (p * p * 3, C) ordered (dy, dx, c) <-> Conv2d (C, 3, p, p)
        layout = (lambda a: a.reshape(patch, patch, 3, hidden).transpose(3, 2, 0, 1),
                  lambda a: a.transpose(2, 3, 1, 0).reshape(patch * patch * 3, hidden))
        self.leaf(f"{prefix}.weight", d, "kernel", layout)
        self.leaf(f"{prefix}.bias", d, "bias")

    def reassemble(self, prefix, d, factor):
        self.conv1x1(f"{prefix}.projection", d["projection"])
        if factor > 1:
            self.deconv(f"{prefix}.resize", d["resize"])
        elif factor < 1:
            self.conv(f"{prefix}.resize", d["resize"])

    def residual(self, prefix, d):
        self.conv(f"{prefix}.convolution1", d["conv1"])
        self.conv(f"{prefix}.convolution2", d["conv2"])

    def qkv(self, prefix: str, attn: dict, hid: int):
        """A fused (C, 3C) ``qkv`` Dense <-> HF's query/key/value Linears,
        and the output projection."""
        names = ("query", "key", "value")
        if self.state is None:
            w, b = np.asarray(attn["qkv"]["kernel"]), np.asarray(attn["qkv"]["bias"])
            for j, name in enumerate(names):
                self.lin(f"{prefix}.attention.{name}",
                         {"kernel": w[:, j * hid:(j + 1) * hid], "bias": b[j * hid:(j + 1) * hid]})
        else:
            g = self.state
            attn["qkv"] = {
                "kernel": np.concatenate([g[f"{prefix}.attention.{n}.weight"].T for n in names], 1),
                "bias": np.concatenate([g[f"{prefix}.attention.{n}.bias"] for n in names])}
        self.lin(f"{prefix}.output.dense", attn["proj"])


def _dinov2(sd: _StateDict, prefix: str, bb: dict, vit) -> None:
    """A JAX DINOv2 trunk -> HF ``Dinov2Model`` keys under ``prefix``."""
    emb = f"{prefix}.embeddings"
    sd.leaf(f"{emb}.cls_token", bb, "cls_token")
    sd.leaf(f"{emb}.position_embeddings", bb, "pos_embed")
    sd.patch_embed(f"{emb}.patch_embeddings.projection", bb["patch_embed"]["proj"],
                   vit.patch_size, vit.hidden_size)
    sd.ln(f"{prefix}.layernorm", bb["norm"])
    for i in range(vit.num_layers):
        blk, pre = bb[f"block{i}"], f"{prefix}.encoder.layer.{i}"
        sd.ln(f"{pre}.norm1", blk["norm1"])
        sd.ln(f"{pre}.norm2", blk["norm2"])
        sd.qkv(f"{pre}.attention", blk["attn"], vit.hidden_size)
        sd.lin(f"{pre}.mlp.fc1", blk["mlp"]["fc1"])
        sd.lin(f"{pre}.mlp.fc2", blk["mlp"]["fc2"])
        if vit.layerscale:
            sd.leaf(f"{pre}.layer_scale1.lambda1", blk, "ls1")
            sd.leaf(f"{pre}.layer_scale2.lambda1", blk, "ls2")


def _dpt_dinov2(sd: _StateDict, params: dict, cfg: DPTConfig) -> None:
    _dinov2(sd, "backbone", params["backbone"], cfg.backbone)
    nh = params["neck_head"]
    for i, factor in enumerate(cfg.reassemble_factors):
        sd.reassemble(f"neck.reassemble_stage.layers.{i}", nh[f"reassemble{i}"], factor)
    for i in range(len(cfg.neck_hidden_sizes)):
        sd.conv(f"neck.convs.{i}", nh[f"scratch{i}"])
        fusion, pre = nh[f"fusion{i}"], f"neck.fusion_stage.layers.{i}"
        sd.conv1x1(f"{pre}.projection", fusion["projection"])
        if i > 0:
            sd.residual(f"{pre}.residual_layer1", fusion["res1"])
        sd.residual(f"{pre}.residual_layer2", fusion["res2"])
    sd.conv("head.conv1", nh["head_conv1"])
    sd.conv("head.conv2", nh["head_conv2"])
    sd.conv1x1("head.conv3", nh["head_conv3"])


def _vit_layers(sd: _StateDict, prefix: str, params: dict, vit) -> None:
    """The plain ViT's blocks (``block{i}``) -> HF ``DPTViTLayer`` keys."""
    for i in range(vit.num_layers):
        blk, pre = params[f"block{i}"], f"{prefix}.layer.{i}"
        sd.ln(f"{pre}.layernorm_before", blk["norm1"])
        sd.ln(f"{pre}.layernorm_after", blk["norm2"])
        sd.qkv(f"{pre}.attention", blk["attn"], vit.hidden_size)
        sd.lin(f"{pre}.intermediate.dense", blk["mlp"]["fc1"])
        sd.lin(f"{pre}.output.dense", blk["mlp"]["fc2"])


def _beit(sd: _StateDict, bb: dict, cfg) -> None:
    """The JAX BEiT backbone -> HF ``backbone.*`` keys."""
    sd.leaf("backbone.embeddings.cls_token", bb, "cls_token")
    sd.patch_embed("backbone.embeddings.patch_embeddings.projection",
                   bb["patch_embed"]["proj"], cfg.patch_size, cfg.hidden_size)
    for i in range(cfg.num_layers):
        blk, pre = bb[f"block{i}"], f"backbone.encoder.layer.{i}"
        sd.ln(f"{pre}.layernorm_before", blk["norm1"])
        sd.ln(f"{pre}.layernorm_after", blk["norm2"])
        sd.leaf(f"{pre}.lambda_1", blk, "ls1")
        sd.leaf(f"{pre}.lambda_2", blk, "ls2")
        for name, key in (("query", "q"), ("key", "k"), ("value", "v")):
            sd.lin(f"{pre}.attention.attention.{name}", blk["attn"][key])
        sd.leaf(f"{pre}.attention.attention.relative_position_bias.relative_position_bias_table",
                blk["rel_bias"], "table")
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


def _dpt_classic(sd: _StateDict, params: dict, cfg) -> None:
    bb, vit = params["backbone"], cfg.backbone
    sd.leaf("dpt.embeddings.cls_token", bb, "cls_token")
    sd.leaf("dpt.embeddings.position_embeddings", bb, "pos_embed")
    sd.patch_embed("dpt.embeddings.patch_embeddings.projection", bb["patch_embed"]["proj"],
                   vit.patch_size, vit.hidden_size)
    _vit_layers(sd, "dpt.encoder", bb, vit)
    _neck(sd, params, cfg, dict(enumerate(cfg.reassemble_factors)))
    _dpt_head(sd, params)


def _dpt_beit(sd: _StateDict, params: dict, cfg) -> None:
    _beit(sd, params["backbone"], cfg.backbone)
    _neck(sd, params, cfg, dict(enumerate(cfg.reassemble_factors)))
    _dpt_head(sd, params)


def _dpt_hybrid(sd: _StateDict, params: dict, cfg) -> None:
    bit, pre = params["bit"], "dpt.embeddings.backbone.bit"
    sd.conv(f"{pre}.embedder.convolution", bit["stem_conv"])
    sd.ln(f"{pre}.embedder.norm", bit["stem_norm"]["gn"])
    for si, depth in enumerate(cfg.bit.depths):
        for li in range(depth):
            layer, lp = bit[f"stage{si}_layer{li}"], f"{pre}.encoder.stages.{si}.layers.{li}"
            for j in (1, 2, 3):
                sd.conv(f"{lp}.conv{j}", layer[f"conv{j}"])
                sd.ln(f"{lp}.norm{j}", layer[f"norm{j}"]["gn"])
            if sd.has(f"{lp}.downsample.conv.weight", layer, "down_conv"):
                sd.conv(f"{lp}.downsample.conv", layer["down_conv"])
                sd.ln(f"{lp}.downsample.norm", layer["down_norm"]["gn"])
    sd.leaf("dpt.embeddings.cls_token", params, "cls_token")
    sd.leaf("dpt.embeddings.position_embeddings", params, "pos_embed")
    sd.conv1x1("dpt.embeddings.projection", params["projection"])
    _vit_layers(sd, "dpt.encoder", params, cfg.backbone)
    _neck(sd, params, cfg, {j + 2: f for j, f in enumerate(cfg.reassemble_factors)})
    _dpt_head(sd, params)


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


def _zoedepth(sd: _StateDict, params: dict, cfg) -> None:
    _zoe_trunk(sd, params, cfg)
    sd.conv1x1("metric_head.conv2", params["metric_conv2"])
    _two_conv(sd, "metric_head.seed_bin_regressor", params["seed_bin"])
    _two_conv(sd, "metric_head.seed_projector", params["seed_proj"])
    for i in range(4):
        _two_conv(sd, f"metric_head.projectors.{i}", params[f"proj{i}"])
        _two_conv(sd, f"metric_head.attractors.{i}", params[f"attractor{i}"])
    _clb(sd, "metric_head.conditional_log_binomial", params["clb"])


def _zoedepth_nk(sd: _StateDict, params: dict, cfg) -> None:
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


def _midas_v2(sd: _StateDict, params: dict, cfg) -> None:
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
            if sd.has(f"{pre}.{unit}.conv1.weight", blk, res):
                sd.conv(f"{pre}.{unit}.conv1", blk[res]["conv1"])
                sd.conv(f"{pre}.{unit}.conv2", blk[res]["conv2"])
        sd.conv1x1(f"{pre}.out_conv", blk["projection"])
    sd.conv("scratch.output_conv.0", params["out_conv0"])
    sd.conv("scratch.output_conv.2", params["out_conv2"])
    sd.conv1x1("scratch.output_conv.4", params["out_conv4"])


def _depth_pro(sd: _StateDict, params: dict, cfg) -> None:
    """The JAX ``DepthPro`` tree <-> transformers' ``DepthProForDepthEstimation``
    keys (the inverse of the JAX ``convert_depth_pro``)."""
    _dinov2(sd, "depth_pro.encoder.patch_encoder.model", params["patch_encoder"],
            cfg.patch_model)
    _dinov2(sd, "depth_pro.encoder.image_encoder.model", params["image_encoder"],
            cfg.image_model)
    up = "depth_pro.neck.feature_upsample"
    sd.deconv(f"{up}.image_block.layers.0", params["up_image"]["up0"])
    sd.conv1x1("depth_pro.neck.fuse_image_with_low_res", params["fuse_low_res"])
    n_scaled, n_inter = len(cfg.scaled_images_ratios), len(cfg.intermediate_hook_ids)
    for i in range(n_scaled):
        d, pre = params[f"up_scaled{i}"], f"{up}.scaled_images.{i}"
        sd.conv1x1(f"{pre}.layers.0", d["proj"])
        sd.deconv(f"{pre}.layers.1", d["up0"])
    for i in range(n_inter):
        d, pre = params[f"up_inter{i}"], f"{up}.intermediate.{i}"
        sd.conv1x1(f"{pre}.layers.0", d["proj"])
        for j in range(2 + i):
            sd.deconv(f"{pre}.layers.{j + 1}", d[f"up{j}"])
    for i in range(n_scaled + n_inter):
        key = f"depth_pro.neck.feature_projection.projections.{i}"
        if sd.has(f"{key}.weight", params, f"feat_proj{i}"):
            sd.conv(key, params[f"feat_proj{i}"])
    for i in range(n_scaled + n_inter - 1):
        d, pre = params[f"fusion{i}"], f"fusion_stage.intermediate.{i}"
        sd.residual(f"{pre}.residual_layer1", d["res1"])
        sd.residual(f"{pre}.residual_layer2", d["res2"])
        sd.deconv(f"{pre}.deconv", d["deconv"])
        sd.conv1x1(f"{pre}.projection", d["projection"])
    d, pre = params["fusion_final"], "fusion_stage.final"
    sd.residual(f"{pre}.residual_layer1", d["res1"])
    sd.residual(f"{pre}.residual_layer2", d["res2"])
    sd.conv1x1(f"{pre}.projection", d["projection"])
    sd.conv("head.layers.0", params["head_conv1"])
    sd.deconv("head.layers.1", params["head_up"])
    sd.conv("head.layers.2", params["head_conv2"])
    sd.conv1x1("head.layers.4", params["head_conv3"])
    if cfg.use_fov_model:
        _dinov2(sd, "fov_model.fov_encoder.model", params["fov_encoder"], cfg.fov_model)
        sd.lin("fov_model.fov_encoder.neck", params["fov_neck"])
        sd.conv("fov_model.conv", params["fov_global_conv"])
        for i in range(cfg.num_fov_head_layers):
            sd.conv(f"fov_model.head.layers.{2 * i}", params[f"fov_head{i}"])
        sd.conv(f"fov_model.head.layers.{2 * cfg.num_fov_head_layers}", params["fov_final"])


def _vda(sd: _StateDict, params: dict, cfg) -> None:
    """The JAX ``VideoDepthAnything`` tree: Depth Anything's, plus one
    temporal attention block per tapped layer."""
    _dpt_dinov2(sd, params, cfg.base)
    for i in range(len(cfg.base.out_indices)):
        block, pre = params[f"temporal{i}"], f"temporal.{i}"
        sd.ln(f"{pre}.norm", block["norm"])
        for name in ("q", "k", "v", "proj"):
            sd.lin(f"{pre}.{name}", block[name])


# family -> its map between the JAX params tree and the port's state dict
_MAPS = {"dpt_dinov2": _dpt_dinov2, "dpt_classic": _dpt_classic, "dpt_beit": _dpt_beit,
         "dpt_hybrid": _dpt_hybrid, "zoedepth": _zoedepth, "zoedepth_nk": _zoedepth_nk,
         "dpt_vit": _midas_v2, "depth_pro": _depth_pro, "vda": _vda}
JAX_FAMILIES = tuple(_MAPS)  # the families whose JAX params tree the port reads and writes


def from_jax_tree(family: str, params: dict, cfg) -> dict[str, torch.Tensor]:
    """A family's JAX params tree (numpy leaves) -> the port's state dict."""
    sd = _StateDict()
    _MAPS[family](sd, params, cfg)
    return dict(sd)


def to_jax_params(family: str, state: dict, cfg) -> dict:
    """The port's state dict -> the family's JAX params tree (float32 numpy
    leaves): the layout the JAX package's ``vd3d convert`` writes to a
    ``format: "native"`` folder."""
    tree = _Tree()
    _MAPS[family](_StateDict(state), tree, cfg)
    return _plain(tree)


def from_jax_params(params: dict, cfg: DPTConfig) -> dict[str, torch.Tensor]:
    """Flax params of ``visiondepth3d_tpu.depth.dpt.DepthAnything`` -> an
    HF-keyed state dict for ``depth.dpt.DepthAnything``."""
    return from_jax_tree("dpt_dinov2", params, cfg)


def from_jax_params_dpt_classic(params: dict, cfg) -> dict[str, torch.Tensor]:
    """Flax params of the JAX ``DPTClassic`` -> HF-keyed ``DPTClassic`` state."""
    return from_jax_tree("dpt_classic", params, cfg)


def from_jax_params_dpt_beit(params: dict, cfg) -> dict[str, torch.Tensor]:
    """Flax params of the JAX ``DPTBEiT`` -> HF-keyed ``DPTBEiT`` state."""
    return from_jax_tree("dpt_beit", params, cfg)


def from_jax_params_dpt_hybrid(params: dict, cfg) -> dict[str, torch.Tensor]:
    """Flax params of the JAX ``DPTHybrid`` -> HF-keyed ``DPTHybrid`` state."""
    return from_jax_tree("dpt_hybrid", params, cfg)


def from_jax_params_zoedepth(params: dict, cfg) -> dict[str, torch.Tensor]:
    """Flax params of the JAX ``ZoeDepth`` -> HF-keyed ``ZoeDepth`` state."""
    return from_jax_tree("zoedepth", params, cfg)


def from_jax_params_zoedepth_nk(params: dict, cfg) -> dict[str, torch.Tensor]:
    """Flax params of the JAX ``ZoeDepthNK`` -> HF-keyed ``ZoeDepthNK`` state."""
    return from_jax_tree("zoedepth_nk", params, cfg)


def from_jax_params_midas_v2(params: dict, cfg) -> dict[str, torch.Tensor]:
    """Flax params of the JAX ``MidasNetSmall`` (BatchNorm folded) -> the
    port's ``MidasNetSmall`` state."""
    return from_jax_tree("dpt_vit", params, cfg)


def _vit_from_jax(bb: dict, like) -> "object":
    """The ``ViTConfig`` of a JAX DINOv2 trunk, read off its shapes; what
    shapes cannot show (the head width 64 of DINOv2, the norm epsilon, the
    pretraining size where it fits the position grid) comes from ``like``."""
    hidden = int(np.shape(bb["cls_token"])[-1])
    patch = math.isqrt(int(np.shape(bb["patch_embed"]["proj"]["kernel"])[0]) // 3)
    side = math.isqrt(int(np.shape(bb["pos_embed"])[1]) - 1)
    layers = sum(1 for k in bb if k.startswith("block"))
    mlp = int(np.shape(bb["block0"]["mlp"]["fc1"]["kernel"])[1]) // hidden
    image = like.image_size if like.image_size // patch == side else side * patch
    return dataclasses.replace(like, hidden_size=hidden, num_layers=layers,
                               num_heads=max(hidden // 64, 1), mlp_ratio=mlp, patch_size=patch,
                               layerscale="ls1" in bb["block0"], image_size=image)


def depth_pro_config_from_jax(params: dict, cfg):
    """``cfg`` with its three encoders read off a JAX Depth Pro tree: the
    JAX catalog's Depth Pro holds ViT-S/14 encoders where the published
    model has DINOv2-L/16 (ROADMAP Queue 3, F10), so a JAX-written folder
    cannot take the port's catalog widths."""
    fov = params.get("fov_encoder")

    def vit(bb, like):  # the encoders see windows of ``patch_size``
        return _vit_from_jax(bb, dataclasses.replace(like, image_size=cfg.patch_size))

    return dataclasses.replace(
        cfg, patch_model=vit(params["patch_encoder"], cfg.patch_model),
        image_model=vit(params["image_encoder"], cfg.image_model),
        fov_model=cfg.fov_model if fov is None else vit(fov, cfg.fov_model),
        use_fov_model=fov is not None)


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


_SAFETENSORS_NAMES = {np.dtype(v).newbyteorder("<"): k for k, v in _SAFETENSORS_DTYPES.items()}


def _raw(v) -> tuple[bytes, str, list]:
    """A tensor or array -> (little-endian bytes, safetensors dtype, shape)."""
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().contiguous()
        if v.dtype == torch.bfloat16:
            return v.view(torch.int16).numpy().astype("<i2").tobytes(), "BF16", list(v.shape)
        v = v.numpy()
    a = np.ascontiguousarray(v)
    le = a.dtype.newbyteorder("<")
    return a.astype(le).tobytes(), _SAFETENSORS_NAMES[le], list(a.shape)


def save_safetensors(path, tensors: dict) -> None:
    """Write {name: tensor or array} as a ``.safetensors`` file: a JSON
    header (padded to 8 bytes) of each tensor's dtype, shape and byte range,
    then the raw little-endian arrays in name order."""
    header, blobs, offset = {}, [], 0
    for name in sorted(tensors):
        data, dtype, shape = _raw(tensors[name])
        header[name] = {"dtype": dtype, "shape": shape,
                        "data_offsets": [offset, offset + len(data)]}
        blobs.append(data)
        offset += len(data)
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for data in blobs:
            f.write(data)
