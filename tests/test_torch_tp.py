"""Tensor parallelism (``parallel/tp.py``) on the CPU: the split plan
against the JAX rule, the split model against one device and the JAX
model, the ``tp`` depth route and render, and the refusals.

- The parameters ``shard_module`` splits (``split_plan``) are exactly the
  counterparts of those the JAX ``vit_param_spec`` shards (with its
  divisibility rule) on the JAX DA-V2 tree at toy widths (``DA_TINY``,
  tp 2), found by converting a tree that marks the sharded leaves with
  ``from_jax_params``. The split parameters reassemble to the originals
  bit for bit (``full_state_dict``).
- A toy DA-V2 with 6 heads (ViT-S's count, 48 wide, so tp 4 splits the
  heads 2, 2, 1, 1) at tp 2, 3 and 4: the float32 depth within 1e-5 of
  its range of one device, and within the depth tests' 1e-4 of the range
  of the JAX predictor's ``_forward`` on the same weights.
- ``depth --mesh tp=2`` and ``dp=2,tp=2`` (the CLI, the CPU two or four
  times) against one device: u8 depth within one step at most, mean
  |d| <= 0.05. ``render --mesh tp=2`` and ``dp=2,tp=2`` against one device
  (the dp=2 render for the second): mean |d| <= 0.1 u8 (the mesh tests'
  bound) and SSIM >= 0.99 per frame (the stereo tests' shipped gate; the
  random toy model's depth is noise-like, so a float32 change of order
  1e-7 moves a few warped pixels and bar columns by whole u8 steps).
- ``depth --mesh sp=2,tp=2`` raises NotImplementedError naming ROADMAP
  item 6d; the frame tools refuse sp and tp (the JAX CLI's dp-only rule).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch
torch.set_num_threads(1)

from visiondepth3d_tpu_torch.depth import configs as tconfigs
from visiondepth3d_tpu_torch.depth.convert import from_jax_params, load_hf_state_dict
from visiondepth3d_tpu_torch.depth.dpt import DepthAnything
from visiondepth3d_tpu_torch.depth.model import DepthPredictor, init_random_
from visiondepth3d_tpu_torch.parallel.tp import (TPAttention, TPMlp, even_split,
                                                 full_state_dict, shard_module, split_plan,
                                                 tp_predictor)

SIZE = 28


def _six_heads(cfg):
    return dataclasses.replace(cfg, backbone=dataclasses.replace(
        cfg.backbone, hidden_size=48, num_heads=6))


def test_split_plan_matches_jax_rule():
    import jax
    from jax.sharding import PartitionSpec as P

    from visiondepth3d_tpu.depth.configs import DA_TINY
    from visiondepth3d_tpu.depth.model import init_random
    from visiondepth3d_tpu.parallel.tp import vit_param_spec as jspec

    params = init_random(DA_TINY, seed=0, size=SIZE)
    tp = 2

    def mark(path, x):
        spec = jspec(path)
        split = spec != P() and all(x.shape[d] % tp == 0 for d, a in enumerate(spec)
                                    if a is not None)
        return np.full(np.shape(x), 1.0 if split else 0.0, np.float32)

    marked = from_jax_params(jax.tree_util.tree_map_with_path(mark, params), tconfigs.DA_TINY)
    jax_split = {k for k, v in marked.items() if float(v.abs().max()) > 0}
    model = init_random_(DepthAnything(tconfigs.DA_TINY), torch.Generator().manual_seed(0))
    want = {k: v.clone() for k, v in model.state_dict().items()}
    sharded = shard_module(model, ["cpu"] * tp)
    assert jax_split and set(split_plan(sharded)) == jax_split
    parts = [m for m in sharded.modules() if isinstance(m, (TPAttention, TPMlp))]
    assert len(parts) == 2 * tconfigs.DA_TINY.backbone.num_layers
    got = full_state_dict(sharded)
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k


@pytest.fixture(scope="module")
def six_heads():
    """The JAX predictor and the port's DA-V2 on the same seeded weights."""
    from visiondepth3d_tpu.depth.configs import DA_TINY
    from visiondepth3d_tpu.depth.model import DepthPredictor as JPredictor
    from visiondepth3d_tpu.depth.model import init_random

    jcfg = _six_heads(DA_TINY)
    params = init_random(jcfg, seed=2, size=SIZE)
    model = DepthAnything(_six_heads(tconfigs.DA_TINY))
    load_hf_state_dict(model, from_jax_params(params, _six_heads(tconfigs.DA_TINY)))
    return JPredictor(jcfg, params, SIZE), DepthPredictor(model, SIZE, device="cpu")


@pytest.mark.parametrize("tp", [2, 3, 4])
def test_tp_depth_matches_one_device_and_jax(six_heads, tp):
    jpred, pred = six_heads
    frames = np.random.default_rng(tp).random((2, 40, 52, 3), dtype=np.float32)
    one = pred(torch.from_numpy(frames)).numpy()
    split = tp_predictor(pred, ["cpu"] * tp)
    attn = next(m for m in split.model.modules() if isinstance(m, TPAttention))
    assert [p.num_heads for p in attn.parts] == [b - a for a, b in even_split(6, tp)]
    got = split(torch.from_numpy(frames)).numpy()
    rng_ = float(one.max() - one.min())
    assert np.abs(got - one).max() <= 1e-5 * rng_, np.abs(got - one).max() / rng_
    want = np.asarray(jpred._forward(jpred.params, frames))
    assert np.abs(got - want).max() <= 1e-4 * float(want.max() - want.min())
    # the original predictor is untouched
    assert not any(isinstance(m, TPAttention) for m in pred.model.modules())


def test_uneven_head_split():
    assert even_split(6, 4) == [(0, 2), (2, 4), (4, 5), (5, 6)]
    assert even_split(6, 3) == [(0, 2), (2, 4), (4, 6)]
    assert even_split(2, 3) == [(0, 1), (1, 2), (2, 2)]


# ------------------------------------------------------------------ routes

@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    from visiondepth3d_tpu_torch.io import Y4MWriter

    tmp = tmp_path_factory.mktemp("tp")
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:48, 0:64]
    with Y4MWriter(str(tmp / "clip.y4m"), 64, 48, 24.0) as wr:
        for i in range(6):
            f = np.stack([(xx * 3 + 7 * i) % 256, (yy * 5) % 256, np.full_like(xx, 90)], -1)
            f[10:30, 2 * i:2 * i + 12] = (250, 40, 40)
            wr.write((f + rng.integers(0, 8, f.shape)).clip(0, 255).astype(np.uint8))
    return tmp


def _luma(path):
    from visiondepth3d_tpu_torch.io import Y4MReader

    with Y4MReader(str(path)) as rd:
        return np.stack(list(rd)).astype(int)


def _run(tmp, cmd, name, *flags):
    from visiondepth3d_tpu_torch.cli.main import main as cli_main

    out = tmp / f"{cmd}_{name}.y4m"
    argv = [cmd, "--input", str(tmp / "clip.y4m"), "--device", "cpu", "--output", str(out),
            "--inference-size", str(SIZE), *flags]
    argv += (["--allow-random-weights", "--batch-size", "4"] if cmd == "depth"
             else ["--allow-random", "--preserve-aspect", "--chunk-size", "4"])
    assert cli_main(argv) == 0
    return _luma(out)


@pytest.mark.parametrize("spec", ["tp=2", "dp=2,tp=2"])
def test_cli_depth_tp(clip, spec):
    one = _run(clip, "depth", "one", "--mesh", "off")
    got = _run(clip, "depth", spec.replace(",", "_"), "--mesh", spec)
    d = np.abs(got - one)
    assert got.shape == one.shape and d.max() <= 1 and d.mean() <= 0.05, (d.max(), d.mean())


@pytest.mark.parametrize("spec", ["tp=2", "dp=2,tp=2"])
def test_cli_render_tp(clip, spec):
    if spec.startswith("dp"):
        from visiondepth3d_tpu_torch.parallel import segment_bounds

        assert segment_bounds(6, 2) == [(0, 3), (3, 6)]
        one = _run(clip, "render", "dp", "--mesh", "dp=2")
    else:
        one = _run(clip, "render", "one", "--mesh", "off")
    got = _run(clip, "render", spec.replace(",", "_"), "--mesh", spec)
    assert got.shape == one.shape and np.abs(got - one).mean() <= 0.1
    from test_torch_stereo_step import _ssim

    assert min(_ssim(a / 255.0, b / 255.0) for a, b in zip(got, one)) >= 0.99


def test_depth_sp_and_tools_refused(clip):
    from visiondepth3d_tpu_torch.enhance import EnhanceConfig, run_merged_pipeline
    from visiondepth3d_tpu_torch.pipeline.depth_pipeline import (DepthConfig,
                                                                 render_depth_video_file)

    with pytest.raises(NotImplementedError, match="6d"):
        render_depth_video_file(clip / "clip.y4m", clip / "x.y4m",
                                DepthConfig(device="cpu", mesh="sp=2,tp=2", inference_size=SIZE))
    for axes in ({"sp": 2}, {"tp": 2}, {"dp": 2, "tp": 2}):
        with pytest.raises(ValueError, match="only the dp"):
            run_merged_pipeline(clip / "clip.y4m", clip / "t.y4m",
                                EnhanceConfig(allow_random_weights=True), mesh_axes=axes,
                                device="cpu")
