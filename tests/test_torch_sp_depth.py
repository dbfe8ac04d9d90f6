"""The depth route's row mesh (``depth --mesh sp=M``, ``parallel/sp.py``) on
the CPU: its parts, the token-parallel model against one device and the
JAX model, the route and the CLI, and the cases sp runs without row
sharding.

- ``RowSharded.rows`` and ``resize_bilinear_rows`` over uneven bands (2
  and 3): bit-identical to the whole frame's rows, for bilinear in both
  ``align_corners`` modes, channel-last and NCHW, at toy sizes (at large
  source heights the library GEMM's K blocking can move an output by an
  ulp; the model is held by its depth below).
- K7's query-band form: the plain version on a band of query rows
  against rows [a, b) of the JAX ``vmem_attention`` in interpret mode, at
  K7's gates (f32 <= 1e-5; bf16 max <= 1.6e-2, mean <= 1e-3). The band
  entry point routes by the global key count at 511, 512, 4095 and 4096
  as the self-attention gate does on N; cross-attention through
  ``multi_head_attention`` stays on SDPA.
- Each of the ten ``dpt_dinov2`` catalog entries at toy widths with its
  own head (relative or metric), sp=2, against one device.
- A toy DA-V2 with 6 heads (ViT-S's count) at 70^2 (5 patch rows) and
  42 x 70 (3, whose stride-2 level has 2 rows: sp=3 leaves a band empty
  there), sp 2 and 3, both head orders: float32 depth within 1e-5 of its
  range of one device, and within 1e-4 of the range of the JAX predictor's
  ``_forward`` on the same weights (the tp tests' bounds).
- ``depth --mesh sp=2`` and ``dp=2,sp=2`` through the CLI (the CPU two and
  four times), 8 and 16 bits, against one device: values within one step,
  mean |d| <= 0.05.
- What sp did not run before PR 16 runs: another family (DPT-Large) and
  ``sp=2,tp=2`` byte for byte against one device and ``tp=2``, ``--tiled``
  within one step of one device, DepthCrafter at ``dp=2,sp=2`` byte for
  byte against ``dp=2`` (more cases in ``tests/test_torch_sp_depth_more.py``).
- ``cuda``-marked: K7's band form on the card against its plain version
  and against rows of the whole-sequence kernel, and the sp route on
  [cuda:0, cuda:0] against one device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch
torch.set_num_threads(1)

from visiondepth3d_tpu_torch.depth import configs as tconfigs
from visiondepth3d_tpu_torch.depth.dpt import DepthAnything
from visiondepth3d_tpu_torch.depth.model import DepthPredictor, init_random_
from visiondepth3d_tpu_torch.kernels import attention as kattention
from visiondepth3d_tpu_torch.ops import attention as tattention
from visiondepth3d_tpu_torch.ops.resize import (resize_bilinear, resize_bilinear_rows,
                                                source_rows)
from visiondepth3d_tpu_torch.parallel.halo import RowSharded, band_bounds
from visiondepth3d_tpu_torch.parallel.sp import SPPredictor, split_rows


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def _six_heads(cfg):
    return dataclasses.replace(cfg, backbone=dataclasses.replace(
        cfg.backbone, hidden_size=48, num_heads=6))


# ------------------------------------------------------- rows and resizes

RESIZES = ((37, 20, 74, 40), (19, 13, 37, 30), (40, 52, 70, 70), (70, 70, 42, 70),
           (148, 20, 296, 40), (5, 7, 5, 9))


@pytest.mark.parametrize("channel_last", [True, False])
@pytest.mark.parametrize("n", [2, 3])
@pytest.mark.parametrize("align_corners", [False, True])
def test_rows_and_band_resize_bit_identical(align_corners, n, channel_last):
    rng = np.random.default_rng(n)
    for h, w, oh, ow in RESIZES:
        shape = (2, h, w, 3) if channel_last else (2, 4, h, w)
        x = torch.from_numpy(rng.random(shape, dtype=np.float32))
        h_axis = 1 if channel_last else 2
        bands = split_rows(h, n)
        sharded = RowSharded([x.narrow(h_axis, a, b - a) for a, b in bands], bands, h_axis)
        pad = [0, 0] * (x.ndim - 1 - h_axis) + [1, 1]
        assert torch.equal(sharded.rows(-1, h + 1, "cpu"),
                           torch.nn.functional.pad(x, pad))
        assert torch.equal(sharded.rows(1, h - 1, "cpu"), x.narrow(h_axis, 1, h - 2))
        whole = resize_bilinear(x, (oh, ow), align_corners=align_corners,
                                channel_last=channel_last)
        for r0, r1 in split_rows(oh, n):
            a, b = source_rows(h, oh, (r0, r1), align_corners)
            got = resize_bilinear_rows(sharded.rows(a, b, "cpu"), h, (oh, ow), (r0, r1), a,
                                       align_corners, channel_last=channel_last)
            assert torch.equal(got, whole.narrow(h_axis, r0, r1 - r0)), (h, w, oh, ow, r0, r1)


def test_split_rows():
    assert split_rows(37, 2) == band_bounds(37, 2) == [(0, 18), (18, 37)]
    assert split_rows(5, 3) == [(0, 2), (2, 3), (3, 5)]
    assert split_rows(2, 3) == [(0, 1), (1, 1), (1, 2)]  # an empty band
    assert source_rows(1080, 518, (0, 252)) == (0, 525)
    with pytest.raises(ValueError, match="read source rows"):
        resize_bilinear_rows(torch.zeros(1, 10, 4), 40, (20, 4), (0, 10), 5,
                             channel_last=False)


# ------------------------------------------------------- K7's band form

BANDS = ((0, 91), (91, 270), (37, 38), (0, 270))


def _qkv(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(0, 1, shape).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k7_band_plain_matches_pallas_rows(dtype):
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from visiondepth3d_tpu.ops.pallas_attention import vmem_attention as jvmem

    q, k, v = _qkv((2, 270, 3, 64), seed=5)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jvmem(*(jnp.asarray(x, jdt) for x in (q, k, v))).astype(jnp.float32))
    tq, tk, tv = (torch.from_numpy(x).to(getattr(torch, dtype)) for x in (q, k, v))
    for a, b in BANDS:
        got = kattention.vmem_attention(tq[:, a:b], tk, tv)
        assert got.shape == (2, b - a, 3, 64) and got.dtype == tq.dtype
        err = np.abs(got.float().numpy() - want[:, a:b])
        if dtype == "float32":
            assert err.max() <= 1e-5, err.max()
        else:
            assert err.max() <= 1.6e-2 and err.mean() <= 1e-3, (err.max(), err.mean())
    with pytest.raises(ValueError, match="Nq <= Nk"):
        kattention.vmem_attention(tk, tq[:, :10], tv[:, :10])


@pytest.mark.parametrize("n", [511, 512, 4095, 4096])
def test_band_route_by_global_n(n, monkeypatch):
    """A band of 7 query tokens takes K7 where the self-attention gate
    takes a sequence of n tokens (the JAX package's gate, which sees the
    global shapes under jit); cross-attention through
    ``multi_head_attention`` stays on SDPA whatever n is. Both routes are
    spies."""
    from visiondepth3d_tpu.ops import attention as jattention
    from visiondepth3d_tpu.ops.pallas_attention import MAX_RESIDENT_SEQ

    routes = []

    def spy(name):
        def route(q, k, v):
            routes.append(name)
            return q
        return route

    monkeypatch.setattr(tattention, "USE_VMEM_KERNEL", True)
    monkeypatch.setattr(kattention, "vmem_attention", spy("K7"))
    monkeypatch.setattr(tattention.F, "scaled_dot_product_attention", spy("SDPA"))
    q, k = torch.zeros(1, 7, 2, 16), torch.zeros(1, n, 2, 16)
    tattention.band_attention(q, k, k)
    tattention.multi_head_attention(q, k, k)
    jax_k7 = (jattention._FLASH_MIN_SEQ <= n < jattention._FLASH_ALWAYS_SEQ
              and n <= MAX_RESIDENT_SEQ)
    assert routes == ["K7" if jax_k7 else "SDPA", "SDPA"]


# ------------------------------------------------ the token-parallel model

FRAMES = np.random.default_rng(11).random((2, 40, 52, 3), dtype=np.float32)


@pytest.fixture(scope="module")
def toy_models():
    """size, fast head -> (one-device predictor, JAX _forward's depth of
    FRAMES) on the same seeded weights."""
    import jax

    from visiondepth3d_tpu.depth.configs import DA_TINY
    from visiondepth3d_tpu.depth.model import DepthPredictor as JPredictor
    from visiondepth3d_tpu.depth.model import init_random

    from visiondepth3d_tpu_torch.depth.convert import from_jax_params, load_hf_state_dict

    jcfg = _six_heads(DA_TINY)
    params = init_random(jcfg, seed=3, size=70)
    cache = {}

    def get(size, fast):
        if (size, fast) not in cache:
            model = DepthAnything(_six_heads(tconfigs.DA_TINY), fast_head=fast)
            load_hf_state_dict(model, from_jax_params(params, _six_heads(tconfigs.DA_TINY)))
            jpred = JPredictor(jcfg, params, size, fast_head=fast)
            want = np.asarray(jax.device_get(jpred._forward(jpred.params, FRAMES)))
            cache[size, fast] = DepthPredictor(model, size, device="cpu"), want
        return cache[size, fast]

    return get


@pytest.mark.parametrize("fast", [True, False])
@pytest.mark.parametrize("size", [70, (42, 70)])
@pytest.mark.parametrize("sp", [2, 3])
def test_sp_depth_matches_one_device_and_jax(toy_models, sp, size, fast):
    pred, want = toy_models(size, fast)
    frames = torch.from_numpy(FRAMES)
    one = pred(frames).numpy()
    split = SPPredictor(pred, ["cpu"] * sp)
    gh = split.grid[0]
    assert split.model.token_bounds(gh) == split_rows(gh, sp)
    got = split(frames).numpy()
    assert got.shape == one.shape == want.shape
    rng_ = float(one.max() - one.min())
    assert np.abs(got - one).max() <= 1e-5 * rng_, np.abs(got - one).max() / rng_
    assert np.abs(got - want).max() <= 1e-4 * float(want.max() - want.min())


DA_ENTRIES = ("depth-anything-v2-small", "depth-anything-v2-base", "depth-anything-v2-large",
              "depth-anything-v1-small", "depth-anything-v1-base", "depth-anything-v1-large",
              "distill-any-depth-small", "distill-any-depth-large",
              "depth-anything-v2-metric-indoor", "depth-anything-v2-metric-outdoor")


@pytest.mark.parametrize("name", DA_ENTRIES)
def test_every_da_entry_runs_sp(name):
    """Each of the ten dpt_dinov2 catalog entries, at DA_TINY's widths with
    its own head (relative, or metric: a sigmoid times its max depth),
    row-sharded at sp=2 on a 42 x 70 frame: within 1e-5 of its range of one
    device, and accepted by the route's family check."""
    from visiondepth3d_tpu_torch.depth.registry import CATALOG, load_predictor
    from visiondepth3d_tpu_torch.parallel.sp import is_row_shardable

    entry = CATALOG[name]
    assert entry.family == "dpt_dinov2"
    cfg = dataclasses.replace(tconfigs.DA_TINY,
                              depth_estimation_type=entry.config.depth_estimation_type,
                              max_depth=entry.config.max_depth)
    pred = load_predictor(name, None, inference_size=(42, 70), config=cfg, device="cpu",
                          fast_head=True)
    assert is_row_shardable(pred)
    frames = torch.from_numpy(FRAMES)
    one = pred(frames)
    got = SPPredictor(pred, ["cpu", "cpu"])(frames)
    rng_ = float(one.max() - one.min())
    assert rng_ > 0 and float((got - one).abs().max()) <= 1e-5 * rng_


def test_sp_needs_a_patch_row_per_band():
    model = init_random_(DepthAnything(tconfigs.DA_TINY), torch.Generator().manual_seed(0))
    pred = DepthPredictor(model, 28, device="cpu")
    with pytest.raises(ValueError, match="at least 3 patch rows"):
        SPPredictor(pred, ["cpu"] * 3)(torch.zeros(1, 28, 28, 3))


# ------------------------------------------------------------- the CLI

@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    from visiondepth3d_tpu_torch.io import Y4MWriter

    tmp = tmp_path_factory.mktemp("sp_depth")
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:48, 0:64]
    with Y4MWriter(str(tmp / "clip.y4m"), 64, 48, 24.0) as wr:
        for i in range(6):
            f = np.stack([(xx * 3 + 7 * i) % 256, (yy * 5) % 256, np.full_like(xx, 90)], -1)
            f[10:30, 2 * i:2 * i + 12] = (250, 40, 40)
            wr.write((f + rng.integers(0, 8, f.shape)).clip(0, 255).astype(np.uint8))
    return tmp


def _read(path):
    """A depth output's values: the u16 planes of a .vd16, the luma of a
    gray y4m (one depth step moves it by at most one)."""
    from visiondepth3d_tpu_torch.io import Y4MPlaneReader
    from visiondepth3d_tpu_torch.io.depth_io import Depth16Reader

    if str(path).endswith(".vd16"):
        with Depth16Reader(str(path)) as rd:
            return np.stack(list(rd)).astype(np.int64)
    with Y4MPlaneReader(str(path)) as rd:
        return np.stack([y for y, _, _ in iter(rd.read, None)]).astype(np.int64)


def _run(tmp, name, bits, *flags):
    from visiondepth3d_tpu_torch.cli.main import main as cli_main

    out = tmp / f"{name}_{bits}.{'vd16' if bits == 16 else 'y4m'}"
    if not out.exists():
        assert cli_main(["depth", "--input", str(tmp / "clip.y4m"), "--device", "cpu",
                         "--output", str(out), "--inference-size", "42", "--bits", str(bits),
                         "--allow-random-weights", "--batch-size", "4", *flags]) == 0
    return _read(out)


@pytest.mark.parametrize("bits", [8, 16])
@pytest.mark.parametrize("spec", ["sp=2", "dp=2,sp=2"])
def test_cli_depth_sp(clip, spec, bits):
    one = _run(clip, "one", bits, "--mesh", "off")
    got = _run(clip, spec.replace(",", "_"), bits, "--mesh", spec)
    d = np.abs(got - one)
    assert got.shape == one.shape == (6, 48, 64)
    assert d.max() <= 1 and d.mean() <= 0.05, (d.max(), d.mean())


def _tiny(name):
    """A tiny random predictor of a catalog entry (the port's tiny configs)."""
    from visiondepth3d_tpu_torch.depth.dpt_classic import DPT_TINY
    from visiondepth3d_tpu_torch.depth.registry import load_predictor

    if name == "dpt-large":
        return load_predictor(name, None, inference_size=32, config=DPT_TINY, device="cpu")
    return load_predictor(name, None, inference_size=28, config=tconfigs.DA_TINY, device="cpu")


def _depthcrafter_cfg(mesh):
    from visiondepth3d_tpu_torch.pipeline.depth_pipeline import DepthConfig

    return DepthConfig(model="depthcrafter", device="cpu", allow_random=True, steps=1,
                       window_size=4, overlap=2, max_segment_frames=4, target_fps=24.0,
                       mesh=mesh)


# case -> (its mesh spec, its twin's, predictor, DepthConfig fields, byte-identical)
LIFTED = {
    "family": ("sp=2", "off", "dpt-large", dict(model="dpt-large", inference_size=32), True),
    "tiled": ("sp=2", "off", "depth-anything-v2-small",
              dict(tiled=True, tile_size=28, tile_overlap=8, inference_size=42), False),
    "sp_tp": ("sp=2,tp=2", "tp=2", "depth-anything-v2-small", dict(inference_size=28), True),
    "depthcrafter": ("dp=2,sp=2", "dp=2", None, None, True),
}


@pytest.mark.parametrize("case", sorted(LIFTED))
def test_sp_lifted_runs(clip, case):
    """What sp did not run before: another family (DPT-Large, on the
    group's first device) and ``sp=2,tp=2`` (the tp=2 split on the first
    sub-group) byte for byte against one device and ``tp=2``; ``--tiled``
    (the tiles over the two sub-groups) against one device, u8 within one
    step and mean |d| <= 0.05; DepthCrafter at ``dp=2,sp=2`` (its windows
    over the dp groups' first devices) byte for byte against ``dp=2``."""
    from visiondepth3d_tpu_torch.pipeline.depth_pipeline import (DepthConfig,
                                                                 render_depth_video_file)

    spec, twin, name, kw, exact = LIFTED[case]
    outs = []
    for mesh in (spec, twin):
        out = clip / f"lifted_{case}_{mesh.replace(',', '_')}.y4m"
        if name is None:  # the tiny random DepthCrafter on the clip's first 6 frames
            n = render_depth_video_file(clip / "clip.y4m", out, _depthcrafter_cfg(mesh))
        else:
            n = render_depth_video_file(clip / "clip.y4m", out,
                                        DepthConfig(device="cpu", mesh=mesh, batch_size=4, **kw),
                                        predictor=_tiny(name))
        assert n == 6
        outs.append(out)
    if exact:
        assert outs[0].read_bytes() == outs[1].read_bytes()
    got, want = _read(outs[0]), _read(outs[1])
    d = np.abs(got - want)
    assert got.shape == want.shape and want.std() > 0
    assert d.max() <= 1 and d.mean() <= 0.05, (d.max(), d.mean())


# ------------------------------------------------------------- the card

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_k7_band_form(cuda, dtype):
    """K7 at the sp=2 depth route's query bands against the whole sequence
    (518^2: band 0 is the cls token and patch rows 0-17, band 1 rows 18-36,
    against 1370 keys): within K7's gates of its plain version, and each
    band's rows bit for bit the same rows of the whole-sequence kernel."""
    gen = torch.Generator().manual_seed(9)
    q, k, v = (torch.randn(2, 1370, 6, 64, generator=gen).to(cuda, dtype) for _ in range(3))
    whole = kattention.vmem_attention(q, k, v)
    for a, b in ((0, 667), (667, 1370)):
        got = kattention.vmem_attention(q[:, a:b], k, v)
        for ref in (kattention.vmem_attention_torch(q[:, a:b], k, v), whole[:, a:b]):
            err = (got.float() - ref.float()).abs()
            if dtype == torch.float32:
                assert err.max().item() <= 1e-5
            else:
                assert err.max().item() <= 1.6e-2 and err.mean().item() <= 1e-3
        assert torch.equal(got, whole[:, a:b])


@pytest.mark.cuda
def test_cuda_sp_route(cuda):
    """The toy DA-V2 (6 heads) at 70^2 row-sharded over [cuda:0, cuda:0]
    against one device, float32 with TF32 off: within 1e-5 of the range."""
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        model = init_random_(DepthAnything(_six_heads(tconfigs.DA_TINY)),
                             torch.Generator().manual_seed(3))
        pred = DepthPredictor(model, 70, device=cuda)
        frames = torch.from_numpy(FRAMES).to(cuda)
        one = pred(frames)
        got = SPPredictor(pred, [cuda, cuda])(frames)
        rng_ = float(one.max() - one.min())
        assert float((got - one).abs().max()) <= 1e-5 * rng_
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
