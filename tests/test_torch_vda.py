"""The port's Video Depth Anything against the JAX package.

At the JAX package's tiny config (``VDA_TINY``: a DINOv2 of width 32 and 4
layers, a 4-frame window with 2 frames of overlap, 2 temporal heads), from
one seeded state dict on the upstream checkpoint's keys (``pretrained.*``
with fused qkv, ``head.*``, and the motion modules' attention), which the
port's ``convert_vda`` and the JAX package's read:
- ``convert_vda`` gives back the port's tensors bit for bit; without the
  motion modules the temporal blocks start as the identity with the JAX
  package's draws.
- The model over one window, and ``VDAPredictor`` over 7 frames (two
  windows, the second fitted to the first on their overlap and
  cross-faded): max |d| <= 1e-4 x max |ref|, float32.
- ``_align_scale_shift``: the least-squares fit within 1e-5 (float64 sums
  here, float32 in the JAX package), and (1, 0) where it is singular.
- ``render_depth_video_file`` with ``video-depth-anything`` on tiny y4m
  clips against the JAX route: 8 bits, 16 bits inverted, and a
  letterboxed clip; mean |d| <= 1 u8 (257 u16 steps), the sidecar
  identical.
"""

from __future__ import annotations

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
torch.set_num_threads(1)

from visiondepth3d_tpu.depth import vda as jvda
from visiondepth3d_tpu.pipeline.depth_pipeline import DepthConfig as JConfig
from visiondepth3d_tpu.pipeline.depth_pipeline import render_depth_video_file as jroute
from test_torch_depth_route import _read, _write_clip
from test_torch_reference import bounded
from visiondepth3d_tpu_torch.depth import registry as tregistry
from visiondepth3d_tpu_torch.depth.vda import (VDA_TINY, VideoDepthAnything, _align_scale_shift,
                                               convert_vda)
from visiondepth3d_tpu_torch.pipeline.depth_pipeline import DepthConfig, render_depth_video_file

SIZE = 56


def _value(key: str, shape: tuple, rng) -> np.ndarray:
    if "lambda1" in key or ("norm" in key and key.endswith("weight")):
        return 1.0 + 0.1 * rng.standard_normal(shape)
    if len(shape) >= 2 and "token" not in key and "position_embeddings" not in key:
        w = rng.standard_normal(shape) * np.sqrt(2.0 / np.prod(shape[1:]))
        return np.abs(w) if key.startswith("head.conv3") else w
    return np.ones(shape) if key.startswith("head.conv3") else 0.02 * rng.standard_normal(shape)


def port_state(seed: int) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    return {k: _value(k, tuple(v.shape), rng).astype(np.float32)
            for k, v in sorted(VideoDepthAnything(VDA_TINY).state_dict().items())}


def upstream_state(port: dict, motion: bool = True, seed: int = 0) -> dict[str, np.ndarray]:
    """The upstream checkpoint's keys holding ``port``'s tensors (the
    deepest refinenet's unused ``resConfUnit1`` and the mask token added)."""
    rng = np.random.default_rng(seed)
    up = {"pretrained.cls_token": port["backbone.embeddings.cls_token"],
          "pretrained.pos_embed": port["backbone.embeddings.position_embeddings"],
          "pretrained.mask_token": np.zeros((1, 32), np.float32)}
    for leaf in ("weight", "bias"):
        up[f"pretrained.patch_embed.proj.{leaf}"] = \
            port[f"backbone.embeddings.patch_embeddings.projection.{leaf}"]
        up[f"pretrained.norm.{leaf}"] = port[f"backbone.layernorm.{leaf}"]
        up[f"head.scratch.output_conv1.{leaf}"] = port[f"head.conv1.{leaf}"]
        up[f"head.scratch.output_conv2.0.{leaf}"] = port[f"head.conv2.{leaf}"]
        up[f"head.scratch.output_conv2.2.{leaf}"] = port[f"head.conv3.{leaf}"]
    for i in range(VDA_TINY.base.backbone.num_layers):
        pre, src = f"pretrained.blocks.{i}", f"backbone.encoder.layer.{i}"
        for leaf in ("weight", "bias"):
            up[f"{pre}.attn.qkv.{leaf}"] = np.concatenate(
                [port[f"{src}.attention.attention.{n}.{leaf}"] for n in ("query", "key", "value")])
            up[f"{pre}.attn.proj.{leaf}"] = port[f"{src}.attention.output.dense.{leaf}"]
            for n in ("norm1", "norm2", "mlp.fc1", "mlp.fc2"):
                up[f"{pre}.{n}.{leaf}"] = port[f"{src}.{n}.{leaf}"]
        up[f"{pre}.ls1.gamma"] = port[f"{src}.layer_scale1.lambda1"]
        up[f"{pre}.ls2.gamma"] = port[f"{src}.layer_scale2.lambda1"]
    n = len(VDA_TINY.base.neck_hidden_sizes)
    for k, v in port.items():
        parts = k.split(".")
        if k.startswith("neck.reassemble_stage.layers."):
            i, name = parts[3], parts[4]
            up[f"head.{'projects' if name == 'projection' else 'resize_layers'}.{i}."
               f"{parts[-1]}"] = v
        elif k.startswith("neck.convs."):
            up[f"head.scratch.layer{int(parts[2]) + 1}_rn.weight"] = v
        elif k.startswith("neck.fusion_stage.layers."):
            pre = f"head.scratch.refinenet{n - int(parts[3])}"
            if parts[4] == "projection":
                up[f"{pre}.out_conv.{parts[-1]}"] = v
            else:
                unit = "resConfUnit1" if parts[4] == "residual_layer1" else "resConfUnit2"
                up[f"{pre}.{unit}.conv{parts[5][-1]}.{parts[-1]}"] = v
                if parts[3] == "0":  # present in upstream checkpoints, unused
                    up[f"{pre}.resConfUnit1.conv{parts[5][-1]}.{parts[-1]}"] = \
                        _value(k, v.shape, rng).astype(np.float32)
        elif k.startswith("temporal.") and motion:
            names = {"q": "to_q", "k": "to_k", "v": "to_v", "proj": "to_out.0"}
            blocks = f"head.motion_modules.{parts[1]}.attention_blocks"
            dst = f"{blocks}.norms.0" if parts[2] == "norm" else f"{blocks}.0.{names[parts[2]]}"
            up[f"{dst}.{parts[-1]}"] = v
    return up


@pytest.fixture(scope="module")
def weights():
    port = port_state(1)
    return port, upstream_state(port)


def _jax_pred(up: dict):
    return jvda.VDAPredictor(jvda.VDA_TINY, jvda.convert_vda(up, jvda.VDA_TINY))


def _port_pred(up: dict):
    return tregistry.load_predictor("video-depth-anything", dict(up), device="cpu",
                                    config=VDA_TINY)


def test_convert_vda_round_trip(weights):
    port, up = weights
    got = convert_vda(up, VDA_TINY)
    assert set(got) == set(port)
    for k, v in got.items():
        np.testing.assert_array_equal(v.numpy(), port[k], err_msg=k)


def test_identity_temporal_blocks_match_jax(weights):
    """Without the motion modules: zero output projections, q/k/v from the
    JAX package's draws; the depth is the per-frame model's, as in JAX."""
    port, _ = weights
    up = upstream_state(port, motion=False)
    mine, theirs = convert_vda(up, VDA_TINY), jvda.convert_vda(up, jvda.VDA_TINY)
    for i in range(len(VDA_TINY.base.out_indices)):
        t = theirs[f"temporal{i}"]
        assert not mine[f"temporal.{i}.proj.weight"].any()
        for n in ("q", "k", "v"):
            np.testing.assert_array_equal(mine[f"temporal.{i}.{n}.weight"].numpy(),
                                          t[n]["kernel"].T)
    frames = np.random.default_rng(3).random((3, SIZE, SIZE, 3), dtype=np.float32)
    want = np.asarray(_jax_pred(up)(frames))
    got = _port_pred(up)(torch.from_numpy(frames)).numpy()
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


def test_model_matches_jax(weights):
    _, up = weights
    x = np.random.default_rng(4).standard_normal((1, 4, SIZE, SIZE, 3)).astype(np.float32)
    params = jvda.convert_vda(up, jvda.VDA_TINY)
    want = np.asarray(jvda.VideoDepthAnything(jvda.VDA_TINY).apply({"params": params},
                                                                  jnp.asarray(x)))
    model = _port_pred(up).model
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 1, 4, 2, 3)).numpy()
    assert got.shape == want.shape == (1, 4, SIZE, SIZE)
    assert want.std() > 1e-3 * np.abs(want).max()
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


@pytest.mark.parametrize("t", [3, 7])
def test_predictor_matches_jax(weights, t):
    """3 frames: one padded window; 7: windows at 0 and 3 (stride 2, the last
    at T - window), the second fitted to the first on their overlap."""
    _, up = weights
    frames = np.random.default_rng(5).random((t, SIZE, SIZE, 3), dtype=np.float32)
    want = np.asarray(_jax_pred(up)(frames))
    got = _port_pred(up)(torch.from_numpy(frames)).numpy()
    assert got.shape == want.shape == (t, SIZE, SIZE) and got.dtype == np.float32
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


def test_align_scale_shift_matches_jax():
    rng = np.random.default_rng(6)
    p = rng.random((3, 20, 30)).astype(np.float32)
    r = (2.5 * p - 0.7 + 0.01 * rng.standard_normal(p.shape)).astype(np.float32)
    a, b = _align_scale_shift(torch.from_numpy(p), torch.from_numpy(r))
    ja, jb = jvda._align_scale_shift(p, r)
    assert abs(a.item() - ja) <= 1e-5 * abs(ja) and abs(b.item() - jb) <= 1e-5
    a, b = _align_scale_shift(torch.ones(2, 4, 4), torch.from_numpy(r[:2, :4, :4]))
    assert (a.item(), b.item()) == (1.0, 0.0) == jvda._align_scale_shift(np.ones((2, 4, 4)),
                                                                         r[:2, :4, :4])


ROUTES = {"u8": ((48, 64, 9, 0), {}), "u16": ((48, 64, 9, 0), dict(bits=16, invert=True)),
          "letterbox": ((96, 128, 10, 12), dict(track_letterbox=True))}


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_route_matches_jax(weights, route, tmp_path):
    """Chunks of 4 carrying 2 frames: 4, then 2 + 2, ...; the last chunk
    short (padded in the predictor)."""
    _, up = weights
    (h, w, n, bars), kw = ROUTES[route]
    clip = tmp_path / "clip.y4m"
    _write_clip(clip, h, w, n, bars)
    ext = "vd16" if kw.get("bits") == 16 else "y4m"
    common = dict(model="video-depth-anything", inference_size=SIZE, **kw)
    assert bounded(jroute, clip, tmp_path / f"jax.{ext}", JConfig(mesh="off", **common),
                   predictor=_jax_pred(up)) == n
    assert render_depth_video_file(clip, tmp_path / f"port.{ext}",
                                   DepthConfig(device="cpu", **common),
                                   predictor=_port_pred(up)) == n
    want, got = _read(tmp_path / f"jax.{ext}"), _read(tmp_path / f"port.{ext}")
    assert got.shape == want.shape == (n, h, w) and got.std() > 0
    assert np.abs(got - want).mean() <= (257 if ext == "vd16" else 1)
    if route == "letterbox":
        side = [json.loads((tmp_path / f"{s}.y4m.letterbox.json").read_text())
                for s in ("jax", "port")]
        assert side[0] == side[1] and side[0]["top"] > 0, side


def test_cli_depth_video_depth_anything(tmp_path, monkeypatch):
    """``vd3d-torch depth --model video-depth-anything`` end to end on the
    CPU, the catalog config swapped for the tiny one (random weights)."""
    import dataclasses

    from visiondepth3d_tpu.io import Y4MReader
    from visiondepth3d_tpu_torch.cli.main import main as cli_main

    entry = tregistry.CATALOG["video-depth-anything"]
    monkeypatch.setitem(tregistry.CATALOG, "video-depth-anything",
                        dataclasses.replace(entry, config=VDA_TINY))
    clip, out = tmp_path / "clip.y4m", tmp_path / "depth.y4m"
    _write_clip(clip, 48, 64, 6)
    assert cli_main(["depth", "--input", str(clip), "--model", "video-depth-anything",
                     "--output", str(out), "--device", "cpu", "--inference-size", "56",
                     "--allow-random-weights"]) == 0
    with Y4MReader(str(out)) as rd:
        depth = np.stack(list(rd))
    assert depth.shape == (6, 48, 64, 3) and depth.std() > 0
