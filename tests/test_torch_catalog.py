"""The port's ``dpt_dinov2`` catalog and its depth heads.

- Each of the ten catalog names resolves to the JAX entry's family, config,
  upstream id and reference names, and ``load_predictor`` builds it.
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

from visiondepth3d_tpu.depth import configs as jconfigs
from visiondepth3d_tpu.depth import registry as jregistry
from visiondepth3d_tpu.depth.convert import convert_depth_anything
from visiondepth3d_tpu.depth.model import DepthPredictor as JPredictor
from visiondepth3d_tpu_torch.cli.main import main as cli_main
from visiondepth3d_tpu_torch.depth import configs as tconfigs
from visiondepth3d_tpu_torch.depth import registry as tregistry
from visiondepth3d_tpu_torch.depth.convert import load_hf_state_dict
from visiondepth3d_tpu_torch.depth.dpt import DepthAnything
from visiondepth3d_tpu_torch.depth.model import DepthPredictor

HEADS = {"relative": ("relative", 1.0), "metric_indoor": ("metric", 20.0),
         "metric_outdoor": ("metric", 80.0)}


def _as_dict(cfg):
    return dataclasses.asdict(cfg)


def test_catalog_matches_jax():
    jax_entries = {n: e for n, e in jregistry.CATALOG.items() if e.family == "dpt_dinov2"}
    assert len(jax_entries) == 10
    assert set(tregistry.CATALOG) == set(jax_entries)
    for name, je in jax_entries.items():
        te = tregistry.CATALOG[name]
        assert (te.family, te.hf_id, te.reference_names) == \
            (je.family, je.hf_id, je.reference_names), name
        assert _as_dict(te.config) == _as_dict(je.config), name
        assert tregistry.inference_resolutions(name) == jregistry.inference_resolutions(name)


@pytest.mark.parametrize("name", sorted(tregistry.CATALOG))
def test_load_predictor_takes_every_entry(name):
    """Every name builds; its config is the entry's (the model's widths are
    swapped for the tiny ones so each build takes a moment)."""
    entry = tregistry.CATALOG[name]
    tiny = dataclasses.replace(tconfigs.DA_TINY,
                               depth_estimation_type=entry.config.depth_estimation_type,
                               max_depth=entry.config.max_depth)
    pred = tregistry.load_predictor(name, None, inference_size=28, config=tiny, device="cpu")
    out = pred(torch.rand(1, 30, 40, 3))
    assert out.shape == (1, 28, 28) and torch.isfinite(out).all()
    if entry.config.depth_estimation_type == "metric":
        assert 0 <= out.min() and out.max() <= entry.config.max_depth


def test_unported_family_names_the_ported_ones():
    with pytest.raises(KeyError, match="dpt_dinov2"):
        tregistry.load_predictor("dpt-large", device="cpu")


def test_models_cli_lists_the_family(capsys):
    assert cli_main(["models", "--family", "dpt_dinov2"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert [ln.split()[0] for ln in lines] == list(tregistry.CATALOG)
    assert all("dpt_dinov2" in ln and "518/392" in ln for ln in lines)


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
