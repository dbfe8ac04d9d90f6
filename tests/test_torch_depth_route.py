"""The port's depth-only route and its attention against the JAX package.

- K7's plain version against ``vmem_attention`` (TPU interpret mode) at
  (2, 270, 3, 64), the JAX package's own case: float32 2e-6; bfloat16
  against the float32 reference 1e-2 (the probabilities are rounded to
  bf16 before P V, as the TPU kernel rounds them).
- The attention dispatch: SDPA by default (float32 1e-6 against
  ``jax.nn.dot_product_attention``), K7 under the ``USE_VMEM_KERNEL``
  opt-in only where the JAX package's gate lets it run.
- A DA_TINY model with the opt-in on (N = 530 tokens at 322 px) against
  the JAX model through ``from_jax_params``: 1e-4 of the output's range,
  the float32 bound of ``tests/test_torch_depth.py``.
- ``render_depth_video_file`` end to end on tiny y4m clips, the JAX side
  with ``mesh="off"`` (``tests/conftest.py`` makes 8 virtual CPU
  devices): the feed-forward route at 8 and 16 bits, the Hann-tiled route,
  and ``track_letterbox`` on a letterboxed clip. u8 within 1 step; u16
  within 2 steps (the two models differ by about 1e-6 of the depth range,
  0.07 u16 steps, which flips the rounding of a few values by one; 1 was
  measured). The letterbox sidecar is identical.
- ``io/letterbox.py`` against the JAX package's: bit-identical decisions.
- On a card, K7 against its plain version (``cuda`` marker).
"""

from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
torch.set_num_threads(1)
from jax.experimental.pallas import tpu as pltpu

from visiondepth3d_tpu.depth.configs import DA_TINY
from visiondepth3d_tpu.depth.model import DepthPredictor as JPredictor
from visiondepth3d_tpu.depth.model import init_random
from visiondepth3d_tpu.io import Y4MReader, Y4MWriter
from visiondepth3d_tpu.io.y4m import Y4MPlaneReader
from visiondepth3d_tpu.io import letterbox as jlb
from visiondepth3d_tpu.io.depth_io import Depth16Reader
from visiondepth3d_tpu.ops.pallas_attention import vmem_attention as jvmem
from visiondepth3d_tpu.ops.tiling import hann2d as jhann2d
from visiondepth3d_tpu.ops.tiling import tile_grid as jtile_grid
from visiondepth3d_tpu.pipeline.depth_pipeline import DepthConfig as JConfig
from visiondepth3d_tpu.pipeline.depth_pipeline import render_depth_video_file as jroute
from test_torch_reference import bounded
from visiondepth3d_tpu_torch.cli.main import main as cli_main
from visiondepth3d_tpu_torch.depth import configs as tconfigs
from visiondepth3d_tpu_torch.depth.convert import from_jax_params, load_hf_state_dict
from visiondepth3d_tpu_torch.depth.dpt import DepthAnything
from visiondepth3d_tpu_torch.depth.model import DepthPredictor
from visiondepth3d_tpu_torch.io import letterbox as tlb
from visiondepth3d_tpu_torch.kernels import attention as kattention
from visiondepth3d_tpu_torch.ops import attention as tattention
from visiondepth3d_tpu_torch.ops import tiling
from visiondepth3d_tpu_torch.pipeline.depth_pipeline import DepthConfig, render_depth_video_file

SIZE = 56


def _qkv(shape, seed=2):
    rng = np.random.default_rng(seed)
    return [rng.normal(0, 1, shape).astype(np.float32) for _ in range(3)]


def test_vmem_attention_plain_matches_pallas():
    q, k, v = _qkv((2, 270, 3, 64))
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jvmem(*(jnp.asarray(x) for x in (q, k, v))))
    got = kattention.vmem_attention_torch(*(torch.from_numpy(x) for x in (q, k, v)))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-6, rtol=0)
    got_b = kattention.vmem_attention(*(torch.from_numpy(x).bfloat16() for x in (q, k, v)))
    assert got_b.dtype == torch.bfloat16
    assert np.abs(got_b.float().numpy() - want).max() < 1e-2


def _one_pass_attention(q, k, v, tile=64):
    """The bf16 K7 kernel's schedule in plain PyTorch: 64-key tiles, the
    running row max and sum, the unnormalized probabilities rounded to bf16
    before P V, one divide by the sum at the end, one rounding."""
    b, n, h, d = q.shape
    scale = 1.0 / np.sqrt(d)
    qf, kf, vf = (x.float() for x in (q, k, v))
    m = torch.full((b, h, n, 1), -torch.inf)
    l = torch.zeros(b, h, n, 1)
    o = torch.zeros(b, h, n, d)
    for k0 in range(0, n, tile):
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kf[:, k0:k0 + tile]) * scale
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        o = o * alpha + torch.einsum("bhqk,bkhd->bhqd", p.to(q.dtype).float(),
                                     vf[:, k0:k0 + tile])
        m = m_new
    return (o / l).permute(0, 2, 1, 3).to(q.dtype)


@pytest.mark.parametrize("shape", [(2, 270, 3, 64), (1, 1370, 2, 64)])
def test_one_pass_schedule_within_bf16_gate(shape):
    """Rounding the unnormalized P (the bf16 kernel's rounding point) stays
    within K7's bf16 gate (max 1.6e-2, mean 1e-3) of the plain version (the
    TPU kernel's rounding point) and of jax.nn.dot_product_attention on the
    same bf16 inputs."""
    q, k, v = (torch.from_numpy(x).bfloat16() for x in _qkv(shape, seed=9))
    got = _one_pass_attention(q, k, v).float()
    plain = kattention.vmem_attention_torch(q, k, v).float()
    ref = torch.from_numpy(np.asarray(jax.nn.dot_product_attention(
        *(jnp.asarray(x.float().numpy()) for x in (q, k, v)))))
    for want in (plain, ref):
        err = (got - want).abs()
        assert err.max().item() <= 1.6e-2 and err.mean().item() <= 1e-3


def test_attention_dispatch_and_gate(monkeypatch):
    """SDPA by default; the opt-in takes self-attention with 512 <= N <
    4096 to K7 (its plain version for CPU tensors), at any head count: the
    JAX package's 8-head cap is its TPU kernel's VMEM budget, and K7 runs
    ViT-B's 12 and ViT-L's 16 heads on the card."""
    calls = []
    plain = kattention.vmem_attention

    def spy(q, k, v):
        calls.append(tuple(q.shape))
        return plain(q, k, v)

    monkeypatch.setattr(kattention, "vmem_attention", spy)
    q, k, v = (torch.from_numpy(x) for x in _qkv((1, 600, 2, 16), seed=1))
    want = np.asarray(jax.nn.dot_product_attention(*(jnp.asarray(x.numpy())
                                                     for x in (q, k, v))))
    np.testing.assert_allclose(tattention.multi_head_attention(q, k, v).numpy(), want,
                               atol=1e-6)
    assert calls == []
    monkeypatch.setattr(tattention, "USE_VMEM_KERNEL", True)
    np.testing.assert_allclose(tattention.multi_head_attention(q, k, v).numpy(), want,
                               atol=2e-6)
    assert calls == [(1, 600, 2, 16)]
    short = torch.zeros(1, 511, 2, 16)
    for a, b in ((short, short), (q, k[:, :599])):
        tattention.multi_head_attention(a, b, b)
    assert len(calls) == 1
    many_heads = torch.zeros(1, 600, 16, 16)
    tattention.multi_head_attention(many_heads, many_heads, many_heads)
    assert calls[1:] == [(1, 600, 16, 16)]


def test_dinov2_opt_in_matches_jax(monkeypatch):
    """DA_TINY at 322 px: 23 x 23 patches + the class token = 530 tokens,
    two heads, so every block's attention takes the opt-in route."""
    size = 322
    params = init_random(DA_TINY, seed=4, size=size)
    frames = np.random.default_rng(5).random((2, 100, 130, 3), dtype=np.float32)
    want = np.asarray(JPredictor(DA_TINY, params, size)(frames))
    model = DepthAnything(tconfigs.DA_TINY)
    load_hf_state_dict(model, from_jax_params(params, tconfigs.DA_TINY))
    calls = []
    plain = kattention.vmem_attention
    monkeypatch.setattr(kattention, "vmem_attention",
                        lambda q, k, v: calls.append(q.shape[1]) or plain(q, k, v))
    monkeypatch.setattr(tattention, "USE_VMEM_KERNEL", True)
    got = DepthPredictor(model, size, device="cpu")(torch.from_numpy(frames)).numpy()
    assert calls == [530] * tconfigs.DA_TINY.backbone.num_layers
    err = np.abs(got - want) / float(want.max() - want.min())
    assert err.max() <= 1e-4, err.max()


# ---------------------------------------------------------------- the route


def _write_clip(path, h, w, n, bars=0):
    yy, xx = np.mgrid[0:h, 0:w]
    with Y4MWriter(str(path), w, h, 24.0) as wr:
        for i in range(n):
            f = np.zeros((h, w, 3), np.uint8)
            f[..., 0] = (xx * 4 + i * 4) % 256
            f[..., 1] = (yy * 5) % 256
            f[..., 2] = 100
            f[h // 4: h // 2, w // 6 + 3 * i: w // 3 + 3 * i] = (240, 50, 50)
            if bars:
                f[:bars] = 0
                f[h - bars:] = 0
            wr.write(f)


def _read(path):
    """A depth output's values: the u16 planes of a .vd16, the luma of a
    y4m (the gray depth's monotone image; one depth step moves it by at most
    one, where the RGB read back through limited-range YUV can move by two)."""
    if str(path).endswith(".vd16"):
        with Depth16Reader(str(path)) as rd:
            return np.stack(list(rd)).astype(np.int64)
    with Y4MPlaneReader(str(path)) as rd:
        return np.stack([y for y, _, _ in iter(rd.read, None)]).astype(np.int64)


@pytest.fixture(scope="module")
def models():
    params = init_random(DA_TINY, seed=6, size=SIZE)
    model = DepthAnything(tconfigs.DA_TINY, fast_head=True)
    load_hf_state_dict(model, from_jax_params(params, tconfigs.DA_TINY))
    return (JPredictor(DA_TINY, params, SIZE, fast_head=True),
            DepthPredictor(model, SIZE, device="cpu"))


ROUTES = {
    "u8": dict(clip=(48, 64, 6, 0), kw=dict(batch_size=4)),
    "u16": dict(clip=(48, 64, 6, 0), kw=dict(batch_size=4, bits=16, invert=True)),
    "tiled": dict(clip=(48, 64, 5, 0), kw=dict(batch_size=4, tiled=True, inference_size=70,
                                               tile_size=SIZE, tile_overlap=16)),
    "letterbox": dict(clip=(96, 128, 10, 12), kw=dict(batch_size=4, track_letterbox=True)),
}


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_depth_route_matches_jax(route, models, tmp_path):
    h, w, n, bars = ROUTES[route]["clip"]
    kw = {"inference_size": SIZE, **ROUTES[route]["kw"]}
    clip = tmp_path / "clip.y4m"
    _write_clip(clip, h, w, n, bars)
    ext = "vd16" if kw.get("bits") == 16 else "y4m"
    jpred, tpred = models
    assert bounded(jroute, clip, tmp_path / f"jax.{ext}", JConfig(mesh="off", **kw),
                   predictor=jpred) == n
    assert render_depth_video_file(clip, tmp_path / f"port.{ext}", DepthConfig(device="cpu",
                                                                                **kw),
                                   predictor=tpred) == n
    want, got = _read(tmp_path / f"jax.{ext}"), _read(tmp_path / f"port.{ext}")
    assert got.shape == want.shape == (n, h, w)
    assert np.abs(got - want).max() <= (2 if ext == "vd16" else 1)
    assert got.std() > 0
    if route == "letterbox":
        side = [json.loads((tmp_path / f"{s}.y4m.letterbox.json").read_text())
                for s in ("jax", "port")]
        assert side[0] == side[1] and side[0]["top"] > 0, side
        assert np.all(got[:, :side[0]["top"]] == want[:, :side[0]["top"]])


def test_tiling_helpers_match_jax():
    for size, tile, ov in ((70, 56, 16), (56, 56, 8), (200, 64, 10)):
        assert tiling.tile_grid(size, tile, ov) == jtile_grid(size, tile, ov)
    np.testing.assert_array_equal(tiling.hann2d(7, 9), jhann2d(7, 9))


def test_unported_depth_routes_raise(tmp_path):
    """The depth route's meshes on the CPU: ``--tiled`` at sp=2 (the tiles
    over the two sub-groups) and DepthCrafter at dp=2,sp=2 (its windows over
    the dp groups) run, the first within one step of one device and the
    second byte for byte against dp=2; dp=2 and sp=2 run on the feed-forward
    route (a tiny predictor, 3 frames), dp=2 also on DepthCrafter's (the
    tiny random pipeline, one 16 x 16 frame), whose windows spread over the
    dp devices only under dp=2,tp=2, as in the JAX package. (The name is
    the one these cases had while sp refused them.)"""
    from visiondepth3d_tpu_torch.depth.registry import load_predictor

    clip = tmp_path / "clip.y4m"
    _write_clip(clip, 16, 16, 1)
    pred = load_predictor("depth-anything-v2-small", None, inference_size=28,
                          config=tconfigs.DA_TINY, device="cpu")
    tiled = dict(tiled=True, tile_size=28, tile_overlap=8, inference_size=28)
    for mesh in ("sp=2", "off"):
        assert render_depth_video_file(clip, tmp_path / f"tiled_{mesh}.y4m",
                                       DepthConfig(device="cpu", mesh=mesh, **tiled),
                                       predictor=pred) == 1
    d = np.abs(_read(tmp_path / "tiled_sp=2.y4m") - _read(tmp_path / "tiled_off.y4m"))
    assert d.max() <= 1 and d.mean() <= 0.05, (d.max(), d.mean())
    for mesh in ("dp=2,sp=2", "dp=2"):
        assert render_depth_video_file(clip, tmp_path / f"dc_{mesh}.y4m",
                                       DepthConfig(model="depthcrafter", device="cpu",
                                                   allow_random=True, window_size=4,
                                                   overlap=2, mesh=mesh)) == 1
    assert (tmp_path / "dc_dp=2,sp=2.y4m").read_bytes() == (tmp_path / "dc_dp=2.y4m").read_bytes()
    three = tmp_path / "three.y4m"
    _write_clip(three, 16, 16, 3)
    for mesh in ("dp=2", "sp=2"):
        assert render_depth_video_file(three, tmp_path / f"{mesh}.y4m",
                                       DepthConfig(device="cpu", mesh=mesh, batch_size=2),
                                       predictor=pred) == 3
        assert _read(tmp_path / f"{mesh}.y4m").shape == (3, 16, 16)
    for mesh in ("off", "dp=2", "dp=2,tp=2"):
        assert render_depth_video_file(clip, tmp_path / "dc.y4m",
                                       DepthConfig(model="depthcrafter", device="cpu",
                                                   allow_random=True, window_size=4,
                                                   overlap=2, mesh=mesh)) == 1
    # --control is ported: 'cancel' stops the route before its first batch
    ctl = tmp_path / "ctl"
    ctl.write_text("cancel")
    out = tmp_path / "cancelled.y4m"
    assert cli_main(["depth", "--input", str(clip), "--output", str(out), "--device", "cpu",
                     "--inference-size", "28", "--allow-random-weights", "--control",
                     str(ctl)]) == 0
    with Y4MReader(str(out)) as rd:  # read to the end (F23)
        assert rd.count() == 0 and list(rd) == []


def test_cli_depth_cpu(tmp_path):
    clip = tmp_path / "clip.y4m"
    _write_clip(clip, 48, 64, 3)
    out = tmp_path / "depth.y4m"
    rc = cli_main(["depth", "--input", str(clip), "--output", str(out), "--device", "cpu",
                   "--inference-size", "28", "--batch-size", "2", "--allow-random-weights"])
    assert rc == 0
    depth = _read(out)
    assert depth.shape == (3, 48, 64) and depth.std() > 0


# ---------------------------------------------------------------- letterbox


def _letterboxed(h, w, bars, seed):
    rng = np.random.default_rng(seed)
    f = (rng.random((h, w, 3)) * 200 + 40).astype(np.uint8)
    f[:bars] = rng.integers(0, 6, (bars, w, 3))
    f[h - bars:] = 0
    return f


def test_letterbox_copy_is_identical():
    frames = [_letterboxed(120, 160, 14, s) for s in range(9)]
    frames += [np.zeros((120, 160, 3), np.uint8)]  # near-black
    frames += [_letterboxed(120, 160, 0, 20 + s) for s in range(6)]  # bars change at a cut
    for f in frames:
        assert tlb.detect_letterbox_single(f) == jlb.detect_letterbox_single(f)
        assert tlb.is_near_black_frame(f) == jlb.is_near_black_frame(f)
    for a, b in zip(frames, frames[1:]):
        assert tlb.is_scene_cut(tlb.to_gray(a), tlb.to_gray(b)) == \
            jlb.is_scene_cut(jlb.to_gray(a), jlb.to_gray(b))
    assert tlb.detect_letterbox_multiframe(frames[:9], 120) == \
        jlb.detect_letterbox_multiframe(frames[:9], 120)
    tt, jt = tlb.LetterboxTracker(120, 2.0), jlb.LetterboxTracker(120, 2.0)
    assert tt.bootstrap(frames[:9]) == jt.bootstrap(frames[:9])
    for i, f in enumerate(frames):
        assert tt.update(f, i) == jt.update(f, i), i
    d = np.arange(60, dtype=np.uint8).reshape(6, 10)
    np.testing.assert_array_equal(tlb.reinsert_bars(d, 2, 4, fill=128),
                                  jlb.reinsert_bars(d, 2, 4, fill=128))
    np.testing.assert_array_equal(tlb.crop_by_bars(frames[0], 14, 14),
                                  jlb.crop_by_bars(frames[0], 14, 14))


# ---------------------------------------------------------------- the card


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 270, 3, 64), (1, 600, 2, 16), (1, 130, 2, 128),
                                   (2, 64, 1, 32), (2, 1370, 6, 64), (1, 1, 1, 64),
                                   (1, 333, 3, 32), (1, 700, 2, 128), (3, 1370, 1, 16)])
def test_cuda_vmem_attention_matches_plain(dtype, shape):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    q, k, v = (torch.from_numpy(x).to("cuda", dtype) for x in _qkv(shape, seed=7))
    got = kattention.vmem_attention(q, k, v)
    ref = kattention.vmem_attention_torch(q, k, v)
    err = (got.float() - ref.float()).abs()
    if dtype == torch.float32:
        assert err.max().item() <= 1e-5
    else:
        assert err.max().item() <= 1.6e-2 and err.mean().item() <= 1e-3
