"""The port's Depth Anything (DINOv2 + DPT) against the JAX model.

The JAX package's random params for the tiny config (DA_TINY) convert with
``from_jax_params`` into the port's HF-keyed state dict; both predictors
then see the same frames. Tolerances, relative to the output's range:
float32: max 1e-4 (summation order in the convolutions and attention).
bfloat16: mean 2e-2, max 1e-1. The two frameworks round to bf16 at
other places, and this random network amplifies rounding: at its worst
pixel the JAX model's own bf16 output is 3.8 % of the range from its
float32 output.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from visiondepth3d_tpu.depth.configs import DA_TINY
from visiondepth3d_tpu.depth.convert import convert_depth_anything
from visiondepth3d_tpu.depth.model import DepthPredictor as JPredictor
from visiondepth3d_tpu.depth.model import init_random
from visiondepth3d_tpu_torch.depth import configs as tconfigs
from visiondepth3d_tpu_torch.depth.convert import from_jax_params, load_hf_state_dict
from visiondepth3d_tpu_torch.depth.dpt import DepthAnything
from visiondepth3d_tpu_torch.depth.model import DepthPredictor, build_random, snap_hw
from visiondepth3d_tpu_torch.depth.registry import load_predictor, parse_inference_size

SIZE = 56  # a 4 x 4 patch grid: the 5 x 5 position embeddings are regridded


@pytest.fixture(scope="module")
def jax_params():
    return init_random(DA_TINY, seed=3, size=SIZE)


def _frames(seed=0):
    return np.random.default_rng(seed).random((2, 40, 52, 3), dtype=np.float32)


def _port(jax_params, fast_head, dtype):
    model = DepthAnything(tconfigs.DA_TINY, fast_head=fast_head)
    load_hf_state_dict(model, from_jax_params(jax_params, tconfigs.DA_TINY))
    return DepthPredictor(model, SIZE, dtype=dtype, device="cpu")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fast_head", [False, True])
@pytest.mark.parametrize("method", ["call", "predict_01"])
def test_predictor_matches_jax(jax_params, method, fast_head, dtype):
    jp = JPredictor(DA_TINY, jax_params, SIZE, dtype=dtype, fast_head=fast_head)
    tp = _port(jax_params, fast_head, dtype)
    frames = _frames()
    if method == "call":
        want = np.asarray(jp(frames))
        got = tp(torch.from_numpy(frames)).numpy()
    else:
        want = np.asarray(jp.predict_01(frames, out_hw=(30, 44)))
        got = tp.predict_01(torch.from_numpy(frames), out_hw=(30, 44)).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    err = np.abs(got - want) / float(want.max() - want.min())
    if dtype == "float32":
        assert err.max() <= 1e-4, err.max()
    else:
        assert err.mean() <= 2e-2 and err.max() <= 1e-1, (err.mean(), err.max())


def test_state_dict_round_trip():
    """HF-keyed random weights -> JAX converter -> from_jax_params gives the
    same tensors back."""
    model = build_random(tconfigs.DA_TINY, seed=5)
    state = {k: v.numpy() for k, v in model.state_dict().items()}
    # an HF checkpoint also holds these; the port's model has no use for them
    hf = dict(state)
    hf["backbone.embeddings.mask_token"] = np.zeros((1, 32), np.float32)
    for conv in ("convolution1", "convolution2"):
        pre = f"neck.fusion_stage.layers.0.residual_layer1.{conv}"
        hf[f"{pre}.weight"] = np.ones((16, 16, 3, 3), np.float32)
        hf[f"{pre}.bias"] = np.ones(16, np.float32)
    back = from_jax_params(convert_depth_anything(hf, DA_TINY), tconfigs.DA_TINY)
    assert set(back) == set(state)
    load_hf_state_dict(DepthAnything(tconfigs.DA_TINY), {k: torch.from_numpy(v)
                                                         for k, v in hf.items()})
    for k, v in state.items():
        np.testing.assert_array_equal(back[k].numpy(), v, err_msg=k)


def test_random_init_rule_matches_jax(jax_params):
    """Seeded random weights follow the JAX init rule: the same scale per
    parameter (ones, zeros, or N(0, fan_in^-1/2))."""
    model = build_random(tconfigs.DA_TINY, seed=0)
    ref = from_jax_params(init_random(DA_TINY, seed=0, size=SIZE), tconfigs.DA_TINY)
    for k, v in model.state_dict().items():
        r = ref[k]
        if r.abs().max() == 0 or torch.all(r == 1):
            torch.testing.assert_close(v, r, atol=0, rtol=0)
        elif r.numel() >= 64:
            assert abs(v.std().item() / r.std().item() - 1) < 0.5, k


def test_registry_and_sizes():
    assert snap_hw(518, 14) == (518, 518) and snap_hw((300, 530), 14) == (294, 518)
    assert parse_inference_size("910x518") == (518, 910)
    assert parse_inference_size("dc-max-quality") == (576, 1024)
    pred = load_predictor("depth-anything-v2-small", None, inference_size=(300, 530),
                          config=tconfigs.DA_TINY, device="cpu")
    assert pred._size == (294, 518)
    with pytest.raises(KeyError):
        load_predictor("dpt-large")


def test_safetensors_checkpoint(tmp_path):
    """An HF .safetensors checkpoint (float32 and bf16 tensors) loads
    through the registry into the same weights."""
    from safetensors.torch import save_file

    from visiondepth3d_tpu_torch.depth.convert import load_safetensors

    state = build_random(tconfigs.DA_TINY, seed=7).state_dict()
    state = {k: (v.to(torch.bfloat16) if "encoder.layer.0." in k else v).contiguous()
             for k, v in state.items()}
    state["backbone.embeddings.mask_token"] = torch.zeros(1, 32)
    save_file(state, str(tmp_path / "model.safetensors"))
    loaded = load_safetensors(tmp_path / "model.safetensors")
    assert set(loaded) == set(state)
    for k, v in state.items():
        assert loaded[k].dtype == v.dtype and torch.equal(loaded[k], v), k
    pred = load_predictor("depth-anything-v2-small", tmp_path / "model.safetensors",
                          inference_size=SIZE, config=tconfigs.DA_TINY, device="cpu")
    got = pred.model.state_dict()
    for k, v in got.items():
        torch.testing.assert_close(v, state[k].float(), atol=0, rtol=0)
