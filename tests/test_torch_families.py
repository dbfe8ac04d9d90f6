"""The port's feed-forward depth families against the JAX package and
against transformers: DPT-Large (``dpt_classic``), DPT-BEiT-Large-512
(``dpt_beit``), DPT-Hybrid (``dpt_hybrid``), ZoeDepth NYU and NYU+KITTI
(``zoedepth``, ``zoedepth_nk``) and MiDaS v2.1-small (``dpt_vit``).

Each family runs at the JAX package's tiny config (``DPT_TINY``,
``DPT_BEIT_TINY``, ``DPT_HYBRID_TINY``, ``ZOE_TINY``, ``ZOE_NK_TINY``,
``MIDAS_V2_TINY``).
- Against JAX: one seeded random state dict with the upstream keys (HF, or
  isl-org with BatchNorm for MiDaS) loads into the port through
  ``load_predictor`` and goes through the JAX family's converter; both
  predictors see the same frames at 96 px (the position embeddings and the
  BEiT bias tables re-gridded from the 64 px pretraining grid). float32:
  max |d| <= 1e-4 x max |ref|. bfloat16: the Depth Anything bound of
  ``tests/test_torch_depth.py``, mean 2e-2 and max 1e-1 of the output's
  range. ``fast_head`` both ways where the family has it.
- Against transformers, where the JAX tests build the twin (their tiny HF
  configs, with the seeded weights above): max |d| <= 2e-5 x max |ref|
  (float32, other summation orders), as ``tests/test_torch_catalog.py``
  holds Depth Anything; ZoeDepth 1e-4 x max |ref|, its temperature softmax
  amplifying those differences. transformers' ZoeDepth differs from the
  JAX package in two constants, which this check sets to transformers'
  values on the port's model: its unnormed attractors take
  ``inv_attractor``'s default alpha 300, not the config's 1000, and its
  patch transformer's LayerNorms torch's epsilon 1e-5, not 1e-6.
- The weights carry across: HF-keyed random weights -> the JAX converter ->
  ``from_jax_params_<family>`` give the same tensors; MiDaS's JAX
  converter folds BatchNorm, so there the folded tensors and the outputs
  are compared.
- The K7 route: with ``USE_VMEM_KERNEL`` a DPT-Large- and a
  DPT-Hybrid-shaped model send every ViT layer to K7 (its plain version on
  the CPU, spied) at 384 px (N = 577) and none at 256 px (N = 257); BEiT
  and ZoeDepth never do.
- ``vd3d-torch render --model dpt-large`` and ``vd3d-torch depth --model
  zoedepth-nyu`` end to end on the CPU, the catalog entries' configs swapped
  for the tiny ones.
- On a card (``cuda`` marker): K7 at N = 577 with 12 and 16 heads against
  its plain version, and each family's tiny float32 predictor against the
  CPU.
"""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch
torch.set_num_threads(1)

from visiondepth3d_tpu.depth import dpt_beit as jdpt_beit
from visiondepth3d_tpu.depth import dpt_classic as jdpt_classic
from visiondepth3d_tpu.depth import dpt_hybrid as jdpt_hybrid
from visiondepth3d_tpu.depth import midas_v2 as jmidas
from visiondepth3d_tpu.depth import registry as jregistry
from visiondepth3d_tpu.depth import zoedepth as jzoe
from visiondepth3d_tpu.depth.convert_dpt import convert_dpt_classic
from visiondepth3d_tpu.depth.model import DepthPredictor as JPredictor
from visiondepth3d_tpu.io import Y4MReader, Y4MWriter
from visiondepth3d_tpu_torch.cli.main import main as cli_main
from visiondepth3d_tpu_torch.depth import convert as tconvert
from visiondepth3d_tpu_torch.depth import registry as tregistry
from visiondepth3d_tpu_torch.depth.convert import load_hf_state_dict
from visiondepth3d_tpu_torch.depth.dpt_beit import DPT_BEIT_TINY, DPTBEiT
from visiondepth3d_tpu_torch.depth.dpt_classic import DPT_TINY, DPTClassic
from visiondepth3d_tpu_torch.depth.dpt_hybrid import DPT_HYBRID_TINY, DPTHybrid
from visiondepth3d_tpu_torch.depth.midas_v2 import MIDAS_V2_TINY, MidasNetSmall, convert_midas_small
from visiondepth3d_tpu_torch.depth.model import DepthPredictor
from visiondepth3d_tpu_torch.depth.zoedepth import (ZOE_NK_TINY, ZOE_TINY, AttractorLayerUnnormed,
                                                    PatchTransformerLayer, ZoeDepth, ZoeDepthNK)
from visiondepth3d_tpu_torch.kernels import attention as kattention
from visiondepth3d_tpu_torch.ops import attention as tattention

SIZE = 96
# catalog name -> (family, tiny port config, port model class, JAX model class,
# JAX converter, from_jax_params, has fast_head)
FAMILIES = {
    "dpt-large": ("dpt_classic", DPT_TINY, DPTClassic, jdpt_classic.DPTClassic,
                  convert_dpt_classic, tconvert.from_jax_params_dpt_classic, True),
    "dpt-beit-large-512": ("dpt_beit", DPT_BEIT_TINY, DPTBEiT, jdpt_beit.DPTBEiT,
                           jdpt_beit.convert_dpt_beit, tconvert.from_jax_params_dpt_beit, True),
    "midas-v3-hybrid": ("dpt_hybrid", DPT_HYBRID_TINY, DPTHybrid, jdpt_hybrid.DPTHybrid,
                        jdpt_hybrid.convert_dpt_hybrid, tconvert.from_jax_params_dpt_hybrid,
                        True),
    "zoedepth-nyu": ("zoedepth", ZOE_TINY, ZoeDepth, jzoe.ZoeDepth, jzoe.convert_zoedepth,
                     tconvert.from_jax_params_zoedepth, False),
    "zoedepth-nyu-kitti": ("zoedepth_nk", ZOE_NK_TINY, ZoeDepthNK, jzoe.ZoeDepthNK,
                           jzoe.convert_zoedepth_nk, tconvert.from_jax_params_zoedepth_nk,
                           False),
    "midas-v2": ("dpt_vit", MIDAS_V2_TINY, MidasNetSmall, jmidas.MidasNetSmall,
                 jmidas.convert_midas_small, tconvert.from_jax_params_midas_v2, False),
}
HF_FAMILIES = [n for n in FAMILIES if n != "midas-v2"]


JAX_TINY = {"dpt-large": jdpt_classic.DPT_TINY, "dpt-beit-large-512": jdpt_beit.DPT_BEIT_TINY,
            "midas-v3-hybrid": jdpt_hybrid.DPT_HYBRID_TINY, "zoedepth-nyu": jzoe.ZOE_TINY,
            "zoedepth-nyu-kitti": jzoe.ZOE_NK_TINY, "midas-v2": jmidas.MIDAS_V2_TINY}


# the last conv of each depth head: positive weights and bias keep its ReLU's
# output from being zero nearly everywhere (which would compare nothing)
LAST_CONVS = ("head.head.4.", "relative_head.conv3.", "scratch.output_conv.4.")


def _value(key: str, shape: tuple, rng) -> np.ndarray:
    """A seeded weight that keeps the tiny models' activations O(1): He
    scaling by the fan-in, small biases, norms and gains near 1 (the JAX
    package's init rule, a 3x3 conv's fan-in taken as 3, lets the fusion
    stages grow by 1e7, where the jitted JAX ZoeDepth gives NaN)."""
    if "relative_position_bias_table" in key:
        return 0.05 * rng.standard_normal(shape)
    if "lambda" in key:
        return 0.5 + 0.1 * rng.standard_normal(shape)
    if "norm" in key and key.endswith("weight"):
        return 1.0 + 0.1 * rng.standard_normal(shape)
    if len(shape) >= 2 and "token" not in key and "position_embeddings" not in key:
        w = rng.standard_normal(shape) * np.sqrt(2.0 / np.prod(shape[1:]))
        return np.abs(w) if key.startswith(LAST_CONVS) else w
    return np.ones(shape) if key.startswith(LAST_CONVS) else 0.02 * rng.standard_normal(shape)


def hf_state(name: str, seed: int = 0) -> dict[str, torch.Tensor]:
    """Seeded random weights on the upstream (HF) keys of a tiny family
    model, the keys the port does not hold included (the JAX converters
    read them)."""
    _, tcfg, cls, *_ = FAMILIES[name]
    shapes = {k: tuple(v.shape) for k, v in cls(tcfg).state_dict().items()}
    f = getattr(tcfg, "base", tcfg).fusion_hidden_size
    for conv in ("convolution1", "convolution2"):
        pre = f"neck.fusion_stage.layers.0.residual_layer1.{conv}"
        shapes[f"{pre}.weight"], shapes[f"{pre}.bias"] = (f, f, 3, 3), (f,)
    rng = np.random.default_rng(seed)
    return {k: torch.from_numpy(_value(k, s, rng).astype(np.float32))
            for k, s in sorted(shapes.items())}


def isl_org_state(cfg, seed: int = 0) -> dict[str, torch.Tensor]:
    """Seeded random MiDaS v2.1-small weights on the isl-org checkpoint's
    keys: bias-free backbone convs, each with its BatchNorm, and the
    decoder (the deepest refinenet's unused ``resConfUnit1`` included)."""
    rng = np.random.default_rng(seed)
    port = MidasNetSmall(cfg).state_dict()
    state = {}

    def conv_bn(src, dst, bn):
        w = port[f"{dst}.weight"]
        state[f"{src}.weight"] = _value(f"{src}.weight", tuple(w.shape), rng)
        c = w.shape[0]
        state[f"{bn}.weight"] = 1.0 + 0.2 * rng.standard_normal(c)
        state[f"{bn}.bias"] = 0.2 * rng.standard_normal(c)
        state[f"{bn}.running_mean"] = 0.5 * rng.standard_normal(c)
        state[f"{bn}.running_var"] = rng.uniform(0.5, 2.0, c)

    conv_bn("pretrained.layer1.0", "pretrained.conv_stem", "pretrained.layer1.1")
    prefix = {}
    for li, group in enumerate(cfg.taps):
        for off, si in enumerate(group):
            prefix[si] = f"pretrained.layer{li + 1}.{(3 if li == 0 else 0) + off}"
    for si, (e, _, n, _, _) in enumerate(cfg.stages):
        convs = (("conv_dw", "bn1"), ("conv_pw", "bn2")) if e == 1 else \
            (("conv_pw", "bn1"), ("conv_dw", "bn2"), ("conv_pwl", "bn3"))
        for j in range(n):
            for conv, bn in convs:
                conv_bn(f"{prefix[si]}.{j}.{conv}", f"pretrained.blocks.{si}.{j}.{conv}",
                        f"{prefix[si]}.{j}.{bn}")
    deepest = f"scratch.refinenet{len(cfg.taps)}"
    for k, v in port.items():
        if k.startswith("scratch."):
            state[k] = _value(k, tuple(v.shape), rng)
            if k.startswith(f"{deepest}.resConfUnit2."):
                unused = k.replace("resConfUnit2", "resConfUnit1")
                state[unused] = _value(unused, tuple(v.shape), rng)
    return {k: torch.from_numpy(np.asarray(v, np.float32)) for k, v in state.items()}


def upstream_state(name: str, seed: int = 0) -> dict[str, torch.Tensor]:
    if name == "midas-v2":
        return isl_org_state(MIDAS_V2_TINY, seed)
    return hf_state(name, seed)


def jax_depth(name: str, state: dict, size: int, frames, dtype: str = "float32",
              fast_head: bool = False) -> np.ndarray:
    """The JAX predictor's depth. ZoeDepth runs op by op: jitted on the CPU,
    the JAX package's conditional log-binomial gives NaN at every pixel for
    these weights (run op by op it is finite, as the port is)."""
    pred = jax_predictor(name, state, size, dtype, fast_head)
    if FAMILIES[name][0] in ("zoedepth", "zoedepth_nk"):
        with jax.disable_jit():
            return np.asarray(pred(frames))
    return np.asarray(pred(frames))


def jax_predictor(name: str, state: dict, size: int, dtype: str = "float32",
                  fast_head: bool = False):
    family, *_, jcls, jconvert, _, has_fast = FAMILIES[name]
    jcfg = JAX_TINY[name]
    params = jconvert({k: v.numpy() for k, v in state.items()}, jcfg)
    kw = {"fast_head": fast_head} if has_fast else {}
    if family in ("zoedepth", "zoedepth_nk"):
        kw_pred = dict(mean=jregistry.STANDARD_MEAN, std=jregistry.STANDARD_STD,
                       select=0 if family == "zoedepth_nk" else None)
    elif family == "dpt_vit":
        kw_pred = dict(snap_multiple=32)
    else:
        kw_pred = {}
    return JPredictor(jcfg, params, size, dtype=dtype, model=jcls(jcfg, **kw), **kw_pred)


def port_predictor(name: str, state: dict, size: int, dtype: str = "float32",
                   fast_head: bool = False, device: str = "cpu"):
    return tregistry.load_predictor(name, dict(state), inference_size=size, dtype=dtype,
                                    device=device, fast_head=fast_head,
                                    config=FAMILIES[name][1])


def _frames(seed=0):
    return np.random.default_rng(seed).random((2, 40, 52, 3), dtype=np.float32)


PARITY_CASES = [(n, fh, dt) for n in FAMILIES for fh in ((False, True) if FAMILIES[n][6]
                                                         else (False,))
                for dt in ("float32", "bfloat16")]


@pytest.mark.parametrize("name,fast_head,dtype", PARITY_CASES)
def test_family_matches_jax(name, fast_head, dtype):
    state = upstream_state(name, seed=1)
    frames = _frames()
    want = jax_depth(name, state, SIZE, frames, dtype, fast_head)
    got = port_predictor(name, state, SIZE, dtype, fast_head)(torch.from_numpy(frames)).numpy()
    assert got.shape == want.shape == (2, SIZE, SIZE) and got.dtype == np.float32
    assert np.isfinite(want).all() and want.std() > 1e-3 * np.abs(want).max()
    if dtype == "float32":
        err = np.abs(got - want).max() / np.abs(want).max()
        assert err <= 1e-4, err
    elif FAMILIES[name][0] in ("zoedepth", "zoedepth_nk"):
        # a bf16 rounding moves a pixel's sharp (temperature down to 0.02)
        # softmax over the bins by a whole bin: here the JAX package's own
        # bf16 depth is 0.6-0.8 of the range from its float32 depth at the
        # worst pixel, so both bf16 depths are held to the float32 one
        ref = jax_depth(name, state, SIZE, frames)
        scale = float(ref.max() - ref.min())
        mine, theirs = np.abs(got - ref) / scale, np.abs(want - ref) / scale
        assert mine.mean() <= 2e-2 and mine.max() <= 1.25 * theirs.max(), \
            (mine.mean(), mine.max(), theirs.max())
    else:
        err = np.abs(got - want) / float(want.max() - want.min())
        assert err.mean() <= 2e-2 and err.max() <= 1e-1, (err.mean(), err.max())


# ---------------------------------------------------------------- transformers


def _tiny_hf_dpt():
    from test_dpt_classic import _tiny_hf_dpt as build

    return build()[0]


def _tiny_hf_hybrid():
    from test_dpt_hybrid import _tiny_hf_hybrid as build

    return build()


def _tiny_hf_zoe():
    from test_zoedepth import _tiny_hf_zoe as build

    return build()


def _hf_beit_backbone():
    from transformers import BeitConfig

    return BeitConfig(hidden_size=32, num_hidden_layers=4, num_attention_heads=2,
                      intermediate_size=128, image_size=64, patch_size=16,
                      use_relative_position_bias=True, use_absolute_position_embeddings=False,
                      layer_scale_init_value=0.1,
                      out_features=["stage1", "stage2", "stage3", "stage4"],
                      reshape_hidden_states=False)


def _randomize_bias_tables(model):
    with torch.no_grad():
        for layer in model.backbone.encoder.layer:
            layer.attention.attention.relative_position_bias \
                .relative_position_bias_table.normal_(0, 0.05)
    return model


def _tiny_hf_dpt_beit():
    """``tests/test_dpt_classic.py::test_dpt_beit_parity``'s model."""
    from transformers import DPTConfig, DPTForDepthEstimation

    cfg = DPTConfig(backbone_config=_hf_beit_backbone(), is_hybrid=False,
                    neck_hidden_sizes=[16, 24, 32, 40], fusion_hidden_size=16,
                    reassemble_factors=[4, 2, 1, 0.5], readout_type="project",
                    add_projection=False)
    torch.manual_seed(0)
    return _randomize_bias_tables(DPTForDepthEstimation(cfg).eval())


def _tiny_hf_zoe_nk():
    """``tests/test_zoedepth.py::test_zoedepth_nk_two_domain_parity``'s model."""
    from transformers import ZoeDepthConfig, ZoeDepthForDepthEstimation

    cfg = ZoeDepthConfig(
        backbone_config=_hf_beit_backbone(), neck_hidden_sizes=[16, 24, 32, 40],
        fusion_hidden_size=16, reassemble_factors=[4, 2, 1, 0.5], readout_type="project",
        bottleneck_features=16, num_relative_features=8, bin_embedding_dim=8,
        num_attractors=[4, 2, 2, 1], bin_centers_type="softplus",
        bin_configurations=[
            {"name": "nyu", "n_bins": 8, "min_depth": 1e-3, "max_depth": 10.0},
            {"name": "kitti", "n_bins": 8, "min_depth": 1e-3, "max_depth": 80.0}],
        num_patch_transformer_layers=4, patch_transformer_hidden_size=128,
        patch_transformer_intermediate_size=32, patch_transformer_num_attention_heads=2,
        add_projection=False)
    torch.manual_seed(0)
    return _randomize_bias_tables(ZoeDepthForDepthEstimation(cfg).eval())


# name, the function making the HF model, input size (96 re-grids the position embeddings)
HF_CASES = {"dpt-large-64": ("dpt-large", _tiny_hf_dpt, 64),
            "dpt-large-96": ("dpt-large", _tiny_hf_dpt, 96),
            "dpt-beit-large-512": ("dpt-beit-large-512", _tiny_hf_dpt_beit, 64),
            "midas-v3-hybrid": ("midas-v3-hybrid", _tiny_hf_hybrid, 64),
            "zoedepth-nyu": ("zoedepth-nyu", _tiny_hf_zoe, 64),
            "zoedepth-nyu-kitti": ("zoedepth-nyu-kitti", _tiny_hf_zoe_nk, 64)}


@pytest.mark.parametrize("case", sorted(HF_CASES))
def test_family_matches_transformers(case):
    name, build, size = HF_CASES[case]
    hf = build()
    # the seeded weights of the JAX comparison on transformers' keys
    # (transformers' own init makes ZoeDepth's depth a constant log 2)
    state = hf.state_dict()
    state.update(hf_state(name, seed=10))
    hf.load_state_dict(state)
    pred = port_predictor(name, state, size)
    for module in pred.model.modules():
        # transformers' unnormed attractors call inv_attractor with its
        # default alpha 300, not the config's 1000, and its patch transformer
        # takes torch's LayerNorm epsilon 1e-5; the JAX package (and the
        # port after it) takes 1000 and 1e-6: set transformers' values here
        if isinstance(module, AttractorLayerUnnormed):
            module.alpha = 300.0
        if isinstance(module, PatchTransformerLayer):
            module.norm1.eps = module.norm2.eps = 1e-5
    x = torch.from_numpy(np.random.default_rng(0).random((2, 3, size, size), dtype=np.float32))
    with torch.no_grad():
        out = hf(x, interpolate_pos_encoding=True) if size != 64 else hf(x)
        got = pred.model(x)
    if name == "zoedepth-nyu-kitti":
        got, logits = got
        torch.testing.assert_close(logits, out.domain_logits, atol=1e-5, rtol=0)
    want = out.predicted_depth
    assert got.shape == want.shape == (2, size, size)
    scale = want.abs().max().item()
    assert want.std().item() > 1e-3 * scale
    # ZoeDepth's softmax over the bins (temperature down to 0.02) amplifies
    # the summation orders' float32 differences: the port-vs-JAX bound there
    tol = 1e-4 if name.startswith("zoedepth") else 2e-5
    assert (got - want).abs().max().item() <= tol * scale


# ---------------------------------------------------------------- weights


@pytest.mark.parametrize("name", HF_FAMILIES)
def test_weights_carry_across_from_jax(name):
    """HF-keyed weights -> the JAX converter -> from_jax_params_<family>:
    the port's tensors, bit for bit."""
    *_, jconvert, from_jax, _ = FAMILIES[name]
    state = hf_state(name, seed=2)
    back = from_jax(jconvert({k: v.numpy() for k, v in state.items()}, JAX_TINY[name]),
                    FAMILIES[name][1])
    model = FAMILIES[name][2](FAMILIES[name][1])
    assert set(back) == set(model.state_dict())
    for k, v in back.items():
        torch.testing.assert_close(v, state[k], atol=0, rtol=0, msg=k)
    load_hf_state_dict(model, back, ())


def test_midas_weights_carry_across_from_jax():
    """The isl-org weights folded by the JAX converter and by the port's give
    the same tensors, and the two models the same depth."""
    state = isl_org_state(MIDAS_V2_TINY, seed=3)
    jparams = jmidas.convert_midas_small({k: v.numpy() for k, v in state.items()}, MIDAS_V2_TINY)
    back = tconvert.from_jax_params_midas_v2(jparams, MIDAS_V2_TINY)
    mine = convert_midas_small(state, MIDAS_V2_TINY)
    assert set(back) == set(mine) == set(MidasNetSmall(MIDAS_V2_TINY).state_dict())
    for k, v in back.items():
        torch.testing.assert_close(v, mine[k], atol=0, rtol=0, msg=k)
    frames = _frames(4)
    want = np.asarray(JPredictor(JAX_TINY["midas-v2"], jparams, 64, model=jmidas.MidasNetSmall(
        JAX_TINY["midas-v2"]), snap_multiple=32)(frames))
    model = load_hf_state_dict(MidasNetSmall(MIDAS_V2_TINY), back, ())
    got = DepthPredictor(model, 64, device="cpu", snap_multiple=32)(
        torch.from_numpy(frames)).numpy()
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


def test_midas_checkpoint_files(tmp_path):
    """The isl-org weights load from a .pt, a .safetensors and an .onnx file
    (its initializers) to the same folded tensors."""
    from visiondepth3d_tpu_torch.utils.onnx_reader import write_onnx_initializers

    state = isl_org_state(MIDAS_V2_TINY, seed=5)
    want = convert_midas_small(state, MIDAS_V2_TINY)
    torch.save(state, tmp_path / "midas.pt")
    from safetensors.torch import save_file

    save_file({k: v.contiguous() for k, v in state.items()}, str(tmp_path / "midas.safetensors"))
    write_onnx_initializers(tmp_path / "midas.onnx", {k: v.numpy() for k, v in state.items()})
    for fn in ("midas.pt", "midas.safetensors", "midas.onnx"):
        got = convert_midas_small(tmp_path / fn, MIDAS_V2_TINY)
        assert set(got) == set(want), fn
        for k, v in got.items():
            torch.testing.assert_close(v, want[k], atol=0, rtol=0, msg=f"{fn} {k}")


# ---------------------------------------------------------------- the K7 route


@pytest.mark.parametrize("name", ["dpt-large", "midas-v3-hybrid", "dpt-beit-large-512",
                                  "zoedepth-nyu"])
def test_k7_route(name, monkeypatch):
    """With the opt-in, the plain ViTs send every layer to K7 at 384 px
    (24 x 24 patches + the class token: 577 tokens) and none at 256 px (257
    tokens); BEiT's biased attention never goes there."""
    calls = []
    plain = kattention.vmem_attention
    monkeypatch.setattr(kattention, "vmem_attention",
                        lambda q, k, v: calls.append(tuple(q.shape)) or plain(q, k, v))
    monkeypatch.setattr(tattention, "USE_VMEM_KERNEL", True)
    state = upstream_state(name, seed=6)
    frames = _frames(7)
    tcfg = FAMILIES[name][1]
    layers = tcfg.backbone.num_layers
    heads = tcfg.backbone.num_heads
    pred = port_predictor(name, state, 384)
    got = pred(torch.from_numpy(frames)).numpy()
    want = jax_depth(name, state, 384, frames)
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
    k7 = FAMILIES[name][0] in ("dpt_classic", "dpt_hybrid")
    assert calls == ([(2, 577, heads, 32 // heads)] * layers if k7 else [])
    calls.clear()
    port_predictor(name, state, 256)(torch.from_numpy(frames))
    assert calls == []


# ---------------------------------------------------------------- the CLI


def _write_clip(path, h=48, w=64, n=4):
    yy, xx = np.mgrid[0:h, 0:w]
    with Y4MWriter(str(path), w, h, 24.0) as wr:
        for i in range(n):
            f = np.zeros((h, w, 3), np.uint8)
            f[..., 0] = (xx * 4 + i * 4) % 256
            f[..., 1] = (yy * 5) % 256
            f[..., 2] = 100
            f[h // 4: h // 2, w // 6 + 3 * i: w // 3 + 3 * i] = (240, 50, 50)
            wr.write(f)


def _tiny_catalog(monkeypatch, name):
    entry = tregistry.CATALOG[name]
    monkeypatch.setitem(tregistry.CATALOG, name,
                        dataclasses.replace(entry, config=FAMILIES[name][1]))


def test_cli_render_dpt_large(tmp_path, monkeypatch):
    _tiny_catalog(monkeypatch, "dpt-large")
    clip, out = tmp_path / "clip.y4m", tmp_path / "sbs.y4m"
    _write_clip(clip)
    assert cli_main(["render", "--input", str(clip), "--model", "dpt-large", "--allow-random",
                     "--device", "cpu", "--output", str(out), "--preserve-aspect",
                     "--chunk-size", "4", "--inference-size", "64"]) == 0
    with Y4MReader(str(out)) as rd:
        frames = np.stack(list(rd))
    assert frames.shape == (4, 48, 128, 3)
    assert np.abs(frames[:, :, :64].astype(int) - frames[:, :, 64:].astype(int)).mean() > 0


def test_cli_depth_zoedepth(tmp_path, monkeypatch):
    _tiny_catalog(monkeypatch, "zoedepth-nyu")
    clip, out = tmp_path / "clip.y4m", tmp_path / "depth.y4m"
    _write_clip(clip)
    assert cli_main(["depth", "--input", str(clip), "--model", "zoedepth-nyu", "--output",
                     str(out), "--device", "cpu", "--inference-size", "64", "--batch-size", "2",
                     "--allow-random-weights"]) == 0
    with Y4MReader(str(out)) as rd:
        depth = np.stack(list(rd))
    assert depth.shape == (4, 48, 64, 3) and depth.std() > 0


# ---------------------------------------------------------------- the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("heads", [12, 16])
def test_cuda_vmem_attention_at_577(cuda, dtype, heads):
    """K7 at DPT-Large's (16 heads) and DPT-Hybrid's (12) 384 px shape:
    577 = 9 x 64 + 1 tokens, so the last query and key tile hold one valid
    row. Gates of the depth route's card case."""
    gen = torch.Generator().manual_seed(heads)
    q, k, v = (torch.randn(8, 577, heads, 64, generator=gen).to(cuda, dtype) for _ in range(3))
    got = kattention.vmem_attention(q, k, v)
    ref = kattention.vmem_attention_torch(q, k, v)
    err = (got.float() - ref.float()).abs()
    if dtype == torch.float32:
        assert err.max().item() <= 1e-5
    else:
        assert err.max().item() <= 1.6e-2 and err.mean().item() <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_cuda_family_matches_cpu(cuda, name):
    """Each family's tiny float32 predictor (TF32 off) on the card against
    the CPU: 1e-4 x max |ref|, the port-vs-JAX bound; ZoeDepth that on the
    mean and 2e-3 on the max."""
    state = upstream_state(name, seed=8)
    frames = torch.from_numpy(_frames(9))
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        want = port_predictor(name, state, SIZE)(frames)
        got = port_predictor(name, state, SIZE, device="cuda")(frames.to(cuda)).cpu()
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    err, scale = (got - want).abs(), want.abs().max().item()
    if FAMILIES[name][0] in ("zoedepth", "zoedepth_nk"):
        # the bins' temperature softmax amplifies the summation orders'
        # differences (measured on an H100: 4.5e-4 of the largest depth)
        assert err.mean().item() <= 1e-4 * scale and err.max().item() <= 2e-3 * scale
    else:
        assert err.max().item() <= 1e-4 * scale
