"""``depth --mesh sp=M`` beyond the row-sharded Depth Anything model, on the
CPU (``pipeline/depth_pipeline.py``): a group of M x K devices (``sp=M``,
``tp=K``) is cut into M sub-groups of K devices.

- Every other family at ``sp=2`` runs on the group's first device, so its
  depth is the one-device depth byte for byte: DPT-BEiT, DPT-Large,
  DPT-Hybrid, ZoeDepth NYU and NYU+KITTI, MiDaS v2 and Depth Pro at the
  port's tiny configs (random weights), an ``onnx:`` graph (the five-conv
  net of ``tests/test_torch_onnx.py``), a ``local:`` folder of a tiny
  DPT-Large, and a Depth Anything predictor with ``select`` (which the row
  sharding does not take).
- ``--tiled`` spreads each call's tiles over the M sub-groups in runs, in
  order (``_TileRuns``): at ``sp=3`` with 8 tiles a call (runs of 3, 3 and
  2) and a last call of 4 (runs of 2 and 2), and at ``dp=2,sp=2``; u8
  within one step of one device and mean |d| <= 0.05 (each tile is whole
  on one model, only the batch changes).
- ``vd3d-torch depth --mesh ...`` for each lifted case: DPT-Large and a
  ``local:`` folder at ``sp=2`` (the catalog entry's config swapped for
  the tiny one), ``--tiled`` at ``sp=2``, ``sp=2,tp=2`` against ``tp=2``
  and DepthCrafter at ``dp=2,sp=2`` against ``dp=2``, byte for byte
  (``--tiled`` within one step).
- One lifted case against the JAX route under the same mesh spec: a toy
  DA-V2 at ``sp=2,tp=2``, the JAX route on four of the suite's eight
  virtual CPU devices (GSPMD's row and Megatron partition), the port's
  weights carried from the JAX tree by its converter: u8 within one step,
  mean |d| <= 0.05.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch
torch.set_num_threads(1)

from test_torch_reference import bounded
from visiondepth3d_tpu_torch.cli.main import main as cli_main
from visiondepth3d_tpu_torch.depth import configs as tconfigs
from visiondepth3d_tpu_torch.depth import registry as tregistry
from visiondepth3d_tpu_torch.depth.depth_pro import DEPTH_PRO_TINY
from visiondepth3d_tpu_torch.depth.dpt_beit import DPT_BEIT_TINY
from visiondepth3d_tpu_torch.depth.dpt_classic import DPT_TINY
from visiondepth3d_tpu_torch.depth.dpt_hybrid import DPT_HYBRID_TINY
from visiondepth3d_tpu_torch.depth.midas_v2 import MIDAS_V2_TINY
from visiondepth3d_tpu_torch.depth.zoedepth import ZOE_NK_TINY, ZOE_TINY
from visiondepth3d_tpu_torch.io import Y4MPlaneReader, Y4MWriter
from visiondepth3d_tpu_torch.parallel.sp import is_row_shardable
from visiondepth3d_tpu_torch.pipeline import depth_pipeline
from visiondepth3d_tpu_torch.pipeline.depth_pipeline import DepthConfig, render_depth_video_file

H, W, T = 48, 64, 6
# catalog entry -> (tiny config, inference size)
TINY = {"dpt-beit-large-512": (DPT_BEIT_TINY, 32), "dpt-large": (DPT_TINY, 32),
        "midas-v3-hybrid": (DPT_HYBRID_TINY, 32), "zoedepth-nyu": (ZOE_TINY, 32),
        "zoedepth-nyu-kitti": (ZOE_NK_TINY, 32), "midas-v2": (MIDAS_V2_TINY, 32),
        "depth-pro": (DEPTH_PRO_TINY, 64)}


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sp_more")
    rng = np.random.default_rng(1)
    yy, xx = np.mgrid[0:H, 0:W]
    with Y4MWriter(str(tmp / "clip.y4m"), W, H, 24.0) as wr:
        for i in range(T):
            f = np.stack([(xx * 3 + 7 * i) % 256, (yy * 5) % 256, np.full_like(xx, 90)], -1)
            f[10:30, 2 * i:2 * i + 12] = (250, 40, 40)
            wr.write((f + rng.integers(0, 8, f.shape)).clip(0, 255).astype(np.uint8))
    return tmp


def _read(path):
    """The luma of a gray depth y4m (one depth step moves it by at most one)."""
    with Y4MPlaneReader(str(path)) as rd:
        return np.stack([y for y, _, _ in iter(rd.read, None)]).astype(np.int64)


def _local_dpt_large(root):
    """A ``local:`` folder of a tiny random DPT-Large (the JAX params layout)."""
    from visiondepth3d_tpu_torch.depth.convert import to_jax_params

    pred = tregistry.load_predictor("dpt-large", None, inference_size=32, config=DPT_TINY,
                                    device="cpu")
    state = {k: v.detach().numpy() for k, v in pred.model.state_dict().items()}
    tregistry.save_local_params(str(root), "dpt-large", to_jax_params("dpt_classic", state,
                                                                      DPT_TINY))
    return f"local:{root}"


def _onnx(root):
    from test_torch_onnx import _depth_graph

    return f"onnx:{_depth_graph(root / 'm.onnx')}"


def _family_predictor(case, tmp):
    """-> (model name, predictor, inference size) of a case."""
    if case in TINY:
        cfg, size = TINY[case]
        return case, tregistry.load_predictor(case, None, inference_size=size, config=cfg,
                                              device="cpu"), size
    if case == "onnx":
        name = _onnx(tmp)
        return name, tregistry.load_predictor(name, None, inference_size=32, device="cpu"), 32
    if case == "local":
        name = _local_dpt_large(tmp / "local_dpt")
        return name, tregistry.load_predictor(name, None, inference_size=32, config=DPT_TINY,
                                              device="cpu"), 32
    # a Depth Anything predictor with ``select``
    from visiondepth3d_tpu_torch.depth.dpt import DepthAnything
    from visiondepth3d_tpu_torch.depth.model import DepthPredictor, init_random_

    model = init_random_(DepthAnything(tconfigs.DA_TINY), torch.Generator().manual_seed(5))
    return "depth-anything-v2-small", DepthPredictor(model, 28, device="cpu", select=0), 28


FAMILY_CASES = sorted(TINY) + ["onnx", "local", "da_select"]


@pytest.mark.parametrize("case", FAMILY_CASES)
def test_sp_family_runs_on_the_first_device(clip, tmp_path, case):
    name, pred, size = _family_predictor(case, tmp_path)
    assert not is_row_shardable(pred)
    outs = []
    for mesh in ("sp=2", "off"):
        out = tmp_path / f"{mesh.replace('=', '')}.y4m"
        assert render_depth_video_file(clip / "clip.y4m", out,
                                       DepthConfig(model=name, device="cpu", mesh=mesh,
                                                   inference_size=size, batch_size=4),
                                       predictor=pred) == T
        outs.append(out)
    assert outs[0].read_bytes() == outs[1].read_bytes()
    assert _read(outs[0]).std() > 0


@pytest.mark.parametrize("spec,runs", [("sp=3", [(8, 3), (4, 3)]),
                                       ("dp=2,sp=2", [(4, 2)])])
def test_tiled_sp_spreads_tiles(clip, tmp_path, monkeypatch, spec, runs):
    """Working height 28 (the tile) over a 48 x 64 clip: 28 x 37, two 28 px
    tiles a frame with an overlap of 8; batches of 4 frames (dp=2: 2 a
    group) -> 8 tiles a call (4), and a last call of 2 frames."""
    pred = tregistry.load_predictor("depth-anything-v2-small", None, inference_size=28,
                                    config=tconfigs.DA_TINY, device="cpu")
    kw = dict(device="cpu", tiled=True, tile_size=28, tile_overlap=8, inference_size=28,
              batch_size=4)
    one = tmp_path / "one.y4m"
    assert render_depth_video_file(clip / "clip.y4m", one, DepthConfig(mesh="off", **kw),
                                   predictor=pred) == T
    calls = []
    real = depth_pipeline._batch_runs

    def spy(n, parts):
        calls.append((n, parts))
        return real(n, parts)

    monkeypatch.setattr(depth_pipeline, "_batch_runs", spy)
    out = tmp_path / "mesh.y4m"
    assert render_depth_video_file(clip / "clip.y4m", out, DepthConfig(mesh=spec, **kw),
                                   predictor=pred) == T
    assert all(r in calls for r in runs), calls
    got, want = _read(out), _read(one)
    d = np.abs(got - want)
    assert got.shape == want.shape == (T, H, W) and want.std() > 0
    assert d.max() <= 1 and d.mean() <= 0.05, (d.max(), d.mean())


def _cli(clip, out, *flags):
    assert cli_main(["depth", "--input", str(clip / "clip.y4m"), "--device", "cpu",
                     "--output", str(out), "--allow-random-weights", "--batch-size", "4",
                     *flags]) == 0
    return out


# case -> (flags, mesh spec, twin's spec, byte-identical)
CLI = {
    "family": (["--model", "dpt-large", "--inference-size", "32"], "sp=2", "off", True),
    "local": (None, "sp=2", "off", True),
    "tiled": (["--inference-size", "28", "--tiled", "--tile-size", "28", "--tile-overlap",
               "8"], "sp=2", "off", False),
    "sp_tp": (["--inference-size", "28"], "sp=2,tp=2", "tp=2", True),
    "depthcrafter": (["--model", "depthcrafter", "--steps", "1", "--window", "4", "--overlap",
                      "2", "--target-fps", "24"], "dp=2,sp=2", "dp=2", True),
}


@pytest.mark.parametrize("case", sorted(CLI))
def test_cli_depth_sp_lifted(clip, tmp_path, monkeypatch, case):
    flags, spec, twin, exact = CLI[case]
    monkeypatch.setitem(tregistry.CATALOG, "dpt-large",
                        dataclasses.replace(tregistry.CATALOG["dpt-large"], config=DPT_TINY))
    if case == "local":
        flags = ["--model", _local_dpt_large(tmp_path / "local_dpt"), "--inference-size", "32"]
    got = _cli(clip, tmp_path / "mesh.y4m", "--mesh", spec, *flags)
    want = _cli(clip, tmp_path / "twin.y4m", "--mesh", twin, *flags)
    if exact:
        assert got.read_bytes() == want.read_bytes()
    a, b = _read(got), _read(want)
    d = np.abs(a - b)
    assert a.shape == b.shape and b.std() > 0
    assert d.max() <= 1 and d.mean() <= 0.05, (d.max(), d.mean())


def test_sp_tp_matches_jax_route_under_the_same_mesh(clip, tmp_path):
    """A toy DA-V2 at ``sp=2,tp=2``: the port (the tp=2 split on the first
    sub-group of the CPU four times) against the JAX route on four virtual
    CPU devices (frames row-sharded, the ViT Megatron-split by GSPMD), the
    same weights through ``from_jax_params``."""
    import jax

    from visiondepth3d_tpu.depth.configs import DA_TINY
    from visiondepth3d_tpu.depth.model import DepthPredictor as JPredictor
    from visiondepth3d_tpu.depth.model import init_random
    from visiondepth3d_tpu.pipeline.depth_pipeline import DepthConfig as JConfig
    from visiondepth3d_tpu.pipeline.depth_pipeline import render_depth_video_file as jroute
    from visiondepth3d_tpu_torch.depth.convert import from_jax_params, load_hf_state_dict
    from visiondepth3d_tpu_torch.depth.dpt import DepthAnything
    from visiondepth3d_tpu_torch.depth.model import DepthPredictor

    assert len(jax.devices()) >= 4
    params = init_random(DA_TINY, seed=7, size=28)
    model = DepthAnything(tconfigs.DA_TINY, fast_head=True)
    load_hf_state_dict(model, from_jax_params(params, tconfigs.DA_TINY))
    kw = dict(inference_size=28, batch_size=4, mesh="sp=2,tp=2")
    assert bounded(jroute, clip / "clip.y4m", tmp_path / "jax.y4m", JConfig(**kw),
                   predictor=JPredictor(DA_TINY, params, 28, fast_head=True)) == T
    assert render_depth_video_file(clip / "clip.y4m", tmp_path / "port.y4m",
                                   DepthConfig(device="cpu", **kw),
                                   predictor=DepthPredictor(model, 28, device="cpu")) == T
    got, want = _read(tmp_path / "port.y4m"), _read(tmp_path / "jax.y4m")
    d = np.abs(got - want)
    assert got.shape == want.shape == (T, H, W) and want.std() > 0
    assert d.max() <= 1 and d.mean() <= 0.05, (d.max(), d.mean())
