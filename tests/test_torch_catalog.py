"""The port's depth catalog and the Depth Anything heads.

- Each catalog name resolves to the JAX entry's family, config, upstream id
  and reference names, and ``load_predictor`` builds it at its family's
  tiny config (the JAX registry test's ``TINY_BY_FAMILY``).
- At a tiny config (4 layers of width 32: transformers needs four distinct
  ``out_indices``), the exact head (relative) and the metric head (indoor
  20 m and outdoor 80 m ``max_depth``) are held against transformers'
  ``DepthAnythingForDepthEstimation`` built from the same random state dict:
  max |d| <= 2e-5 of the largest output (float32, other summation orders).
  The same dict goes through the JAX converter and the JAX predictor at
  the same inference size: max |d| <= 1e-4 of the output range, as
  ``test_torch_depth.py`` holds the relative model.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch
torch.set_num_threads(1)

from visiondepth3d_tpu.depth import configs as jconfigs
from visiondepth3d_tpu.depth import registry as jregistry
from visiondepth3d_tpu.depth.convert import convert_depth_anything
from visiondepth3d_tpu.depth.model import DepthPredictor as JPredictor
from visiondepth3d_tpu_torch.cli.main import main as cli_main
from visiondepth3d_tpu_torch.depth import configs as tconfigs
from visiondepth3d_tpu_torch.depth import registry as tregistry
from visiondepth3d_tpu_torch.depth.convert import load_hf_state_dict
from visiondepth3d_tpu_torch.depth.dpt import DepthAnything
from visiondepth3d_tpu_torch.depth.dpt_beit import DPT_BEIT_TINY
from visiondepth3d_tpu_torch.depth.depth_pro import DEPTH_PRO_TINY
from visiondepth3d_tpu_torch.depth.dpt_classic import DPT_TINY
from visiondepth3d_tpu_torch.depth.dpt_hybrid import DPT_HYBRID_TINY
from visiondepth3d_tpu_torch.depth.midas_v2 import MIDAS_V2_TINY
from visiondepth3d_tpu_torch.depth.model import DepthPredictor
from visiondepth3d_tpu_torch.depth.vda import VDA_TINY
from visiondepth3d_tpu_torch.depth.zoedepth import ZOE_NK_TINY, ZOE_TINY

HEADS = {"relative": ("relative", 1.0), "metric_indoor": ("metric", 20.0),
         "metric_outdoor": ("metric", 80.0)}


def _as_dict(cfg):
    return dataclasses.asdict(cfg)


# the port's tiny config of each ported family, with the input size that
# gives a whole patch grid (Marigold: the tiny pipeline of allow_random)
TINY_BY_FAMILY = {"dpt_dinov2": (tconfigs.DA_TINY, 28), "dpt_classic": (DPT_TINY, 64),
                  "dpt_beit": (DPT_BEIT_TINY, 64), "dpt_hybrid": (DPT_HYBRID_TINY, 64),
                  "zoedepth": (ZOE_TINY, 64), "zoedepth_nk": (ZOE_NK_TINY, 64),
                  "dpt_vit": (MIDAS_V2_TINY, 64), "depth_pro": (DEPTH_PRO_TINY, 64),
                  "vda": (VDA_TINY, 28), "diffusion": (None, 16)}


def test_catalog_matches_jax():
    jax_entries = {n: e for n, e in jregistry.CATALOG.items()
                   if e.family in tregistry.PORTED_FAMILIES}
    # every entry of the JAX catalog is ported (DepthCrafter last)
    assert set(jax_entries) == set(tregistry.CATALOG) == set(jregistry.CATALOG)
    assert len(jax_entries) == 20
    assert set(tregistry.PORTED_FAMILIES) == set(TINY_BY_FAMILY)
    for name, te in tregistry.CATALOG.items():
        je = jax_entries[name]
        assert (te.family, te.hf_id, te.reference_names) == \
            (je.family, je.hf_id, je.reference_names), name
        if name == "depth-pro":  # published widths (F10): tests/test_torch_depth_pro.py
            continue
        if te.config is None:
            assert je.config is None, name
        else:
            assert _as_dict(te.config) == _as_dict(je.config), name
        assert tregistry.inference_resolutions(name) == jregistry.inference_resolutions(name)


@pytest.mark.parametrize("name", sorted(tregistry.CATALOG))
def test_load_predictor_takes_every_entry(name):
    """Every name builds; its config is the entry's family's (the model's
    widths are swapped for the tiny ones so each build takes a moment)."""
    entry = tregistry.CATALOG[name]
    tiny, size = TINY_BY_FAMILY[entry.family]
    if entry.family == "dpt_dinov2":
        tiny = dataclasses.replace(tiny, depth_estimation_type=entry.config.depth_estimation_type,
                                   max_depth=entry.config.max_depth)
    if entry.family == "diffusion":
        pred = tregistry.load_predictor(name, None, device="cpu", allow_random=True)
    else:
        pred = tregistry.load_predictor(name, None, inference_size=size, config=tiny,
                                        device="cpu")
    # the windowed and diffusion families take frames at the model's size
    frames = torch.rand(2, *((size, size) if entry.family in ("vda", "diffusion")
                             else (30, 40)), 3)
    out = pred(frames)
    # the tiny Depth Pro's fusion ends at half its input size
    want = size // 2 if entry.family == "depth_pro" else size
    assert out.shape == (2, want, want) and torch.isfinite(out).all()
    if getattr(entry.config, "depth_estimation_type", None) == "metric":
        assert 0 <= out.min() and out.max() <= entry.config.max_depth


@pytest.mark.parametrize("name", ["depth-pro", "video-depth-anything", "marigold",
                                  "depthcrafter"])
def test_unported_family_names_the_ported_ones(name):
    """Depth Pro, VDA, Marigold and DepthCrafter are among the ported
    families now, and DepthCrafter loads (its tiny random pipeline); a
    name outside the catalog is refused, naming the ported families."""
    assert tregistry.CATALOG[name].family in tregistry.PORTED_FAMILIES
    if name == "depthcrafter":
        from visiondepth3d_tpu_torch.depth.diffusion import DepthCrafterPipeline

        pipe = tregistry.load_predictor(name, device="cpu", allow_random=True, window=6,
                                        overlap=2)
        assert isinstance(pipe, DepthCrafterPipeline) and (pipe.window_size, pipe.overlap) == (6, 2)
    with pytest.raises(KeyError, match="dpt_dinov2, dpt_classic, dpt_beit.*depth_pro, vda, "
                                       "diffusion"):
        tregistry.load_predictor(f"{name}-unknown", device="cpu")


@pytest.mark.parametrize("family", sorted(TINY_BY_FAMILY))
def test_models_cli_lists_the_family(family, capsys):
    assert cli_main(["models", "--family", family]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    want = [n for n, e in tregistry.CATALOG.items() if e.family == family]
    assert [ln.split()[0] for ln in lines] == want
    sizes = "/".join(str(r) for r in jregistry.inference_resolutions(want[0]))
    assert all(family in ln and sizes in ln for ln in lines)


def _hf_model(kind: str, max_depth: float):
    from transformers import DepthAnythingConfig, DepthAnythingForDepthEstimation
    from transformers.models.dinov2 import Dinov2Config

    bb = Dinov2Config(hidden_size=32, num_hidden_layers=4, num_attention_heads=2, mlp_ratio=4,
                      image_size=70, patch_size=14, layerscale_value=1.0,
                      out_indices=[1, 2, 3, 4], apply_layernorm=True,
                      reshape_hidden_states=False)
    cfg = DepthAnythingConfig(backbone_config=bb, reassemble_hidden_size=32, patch_size=14,
                              neck_hidden_sizes=[16, 24, 32, 40], fusion_hidden_size=16,
                              head_hidden_size=8, reassemble_factors=[4, 2, 1, 0.5],
                              depth_estimation_type=kind, max_depth=max_depth)
    return DepthAnythingForDepthEstimation(cfg).eval()


def _random_state(model, seed: int) -> dict:
    """Seeded numpy weights on the model's keys, scaled by fan-in so the
    activations stay O(1) (torch's and transformers' own inits make the
    tiny model's output vanish or the metric sigmoid saturate)."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in model.state_dict().items():
        shape = tuple(v.shape)
        if k.endswith("mask_token"):
            a = np.zeros(shape)
        elif "norm" in k and k.endswith("weight"):
            a = 1.0 + 0.1 * rng.standard_normal(shape)
        elif "lambda1" in k:
            a = 0.5 + 0.1 * rng.standard_normal(shape)
        elif v.ndim >= 2 and "embeddings" not in k and "token" not in k:
            a = rng.standard_normal(shape) / np.sqrt(np.prod(shape[1:]))
        else:
            a = 0.1 * rng.standard_normal(shape)
        out[k] = torch.from_numpy(a.astype(np.float32))
    return out


@pytest.mark.parametrize("head", sorted(HEADS))
def test_exact_and_metric_heads_match_transformers_and_jax(head):
    kind, max_depth = HEADS[head]
    hf = _hf_model(kind, max_depth)
    state = _random_state(hf, seed=3)
    hf.load_state_dict(state)
    tcfg = dataclasses.replace(tconfigs.DA_TINY, depth_estimation_type=kind, max_depth=max_depth)
    model = load_hf_state_dict(DepthAnything(tcfg, fast_head=False), dict(state)).eval()
    x = torch.from_numpy(np.random.default_rng(0).random((2, 3, 70, 98), dtype=np.float32))
    with torch.no_grad():
        want, got = hf(x).predicted_depth, model(x)
    assert got.shape == want.shape == (2, 70, 98)
    scale = want.abs().max().item()
    assert want.std().item() > 1e-3 * scale  # not a constant map
    assert (got - want).abs().max().item() <= 2e-5 * scale
    if kind == "metric":
        assert 0 < want.min() and want.max() < max_depth

    jcfg = dataclasses.replace(jconfigs.DA_TINY, depth_estimation_type=kind, max_depth=max_depth)
    jparams = convert_depth_anything({k: v.numpy() for k, v in state.items()}, jcfg)
    frames = np.random.default_rng(1).random((2, 40, 52, 3), dtype=np.float32)
    jwant = np.asarray(JPredictor(jcfg, jparams, 70)(frames))
    tgot = DepthPredictor(model, 70, device="cpu")(torch.from_numpy(frames)).numpy()
    assert tgot.shape == jwant.shape == (2, 70, 70)
    assert np.abs(tgot - jwant).max() <= 1e-4 * float(jwant.max() - jwant.min())
