"""Row bands of a frame (``parallel/halo.py``, ``stereo/bands.py``) and K3/K4's
band forms, on the CPU, against the one-device functions and the JAX package.

Inputs come from numpy seeds. The cases:

- the zero-padded ``halo_exchange_rows`` equals the JAX function run on one
  CPU device under ``jax.vmap(..., axis_name="sp")`` at sp 2 and 3, halos 1
  and 6, and ``crop_halo_rows`` undoes it; ``outer="none"`` leaves the edge
  bands unpadded;
- ``band_bounds``: even starts, sizes within two rows of each other, each
  band at least the halo; a frame too short raises naming the least height
  that splits;
- K3's and K4's band forms (plain versions): the sums of random splits,
  splits through the subject crop's edges and bands holding no crop row
  finish to the one-shot plain versions bit for bit (the band buffers too);
- ``render_chunk_bands`` over [cpu] * 2 and * 3 at 70 rows (bands of 24,
  22, 24 or 36, 34), float32 and bfloat16, with depth of field, Half-SBS and
  blank frames: every output and every tracker byte-identical to
  ``render_chunk``. The width is 64: PyTorch's CPU kernels take the last
  (numel mod 16) elements of an elementwise op through their scalar code,
  whose exp and pow may differ from the vector code's by an ulp, so at a
  width that is no multiple of 16 a band's last elements can differ by an
  ulp from the whole frame's (the statistics stay bit-identical: a case at
  66 columns holds that). Every product width is a multiple of 16;
- the banded chunk against the JAX one-device ``render_chunk`` (what GSPMD
  partitions for JAX's sp) at the stereo step tests' shipped-config gates
  (mean |d| <= one u8 step, SSIM >= 0.99 per frame);
- a band thinner than the halo raises;
- the render CLI with ``--mesh sp=2`` and ``--mesh pp=2,dp=2`` on the CPU
  writes the frames of one device (the depth-file route byte for byte, pp
  at the per-device chunk).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch
torch.set_num_threads(1)
from torch.utils._python_dispatch import TorchDispatchMode

from visiondepth3d_tpu_torch.kernels import stats
from visiondepth3d_tpu_torch.parallel.halo import (BandLayout, band_bounds, crop_halo_rows,
                                                   halo_exchange_rows)
from visiondepth3d_tpu_torch.state import init_trackers
from visiondepth3d_tpu_torch.stereo import StereoParams
from visiondepth3d_tpu_torch.stereo.bands import (init_band_trackers, render_chunk_bands,
                                                  stereo_halo)
from visiondepth3d_tpu_torch.stereo.step import render_chunk, stereo_frame_step

H, W, T = 70, 64, 4


def _clip(h=H, w=W, t=T, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    frames, depths = [], []
    for i in range(t):
        f = np.stack([0.5 + 0.4 * np.sin((xx + 3 * i) / (6.0 + c) + yy / 11.0)
                      for c in range(3)], -1) + 0.05 * rng.random((h, w, 3))
        d = 0.45 + 0.25 * np.sin(xx / 13.0 + 0.2 * i) * np.cos(yy / 9.0) + 0.2 * (xx / w)
        box = (xx > 20 + 3 * i) & (xx < 44 + 3 * i) & (yy > 15) & (yy < 50)
        d = np.where(box, 0.15, d) + 0.01 * rng.random((h, w))
        frames.append(np.clip(f, 0, 1))
        depths.append(np.clip(d, 0, 1))
    return (torch.from_numpy(np.asarray(frames, np.float32)),
            torch.from_numpy(np.asarray(depths, np.float32)))


# ------------------------------------------------------------------ halo

@pytest.mark.parametrize("sp,halo", [(2, 1), (2, 6), (3, 1), (3, 6)])
def test_halo_exchange_matches_jax(sp, halo):
    import jax
    import jax.numpy as jnp

    from visiondepth3d_tpu.parallel.halo import crop_halo_rows as jcrop
    from visiondepth3d_tpu.parallel.halo import halo_exchange_rows as jexchange

    x = np.random.default_rng(10 * sp + halo).random((sp, 8, 5)).astype(np.float32)
    want = np.asarray(jax.vmap(lambda b: jexchange(b, halo), axis_name="sp")(jnp.asarray(x)))
    got = halo_exchange_rows([torch.from_numpy(b) for b in x], halo)
    for i in range(sp):
        np.testing.assert_array_equal(got[i].numpy(), want[i])
        np.testing.assert_array_equal(crop_halo_rows(got[i], halo).numpy(),
                                      np.asarray(jcrop(jnp.asarray(want[i]), halo)))
        np.testing.assert_array_equal(crop_halo_rows(got[i], halo).numpy(), x[i])
    bare = halo_exchange_rows([torch.from_numpy(b) for b in x], halo, outer="none")
    assert bare[0].shape[0] == 8 + halo and bare[-1].shape[0] == 8 + halo
    np.testing.assert_array_equal(bare[0].numpy(), want[0][halo:])
    np.testing.assert_array_equal(bare[-1].numpy(), want[-1][:-halo])


@pytest.mark.parametrize("height,n,halo", [(70, 2, 13), (70, 3, 13), (1080, 3, 17),
                                           (2160, 4, 17), (33, 5, 1)])
def test_band_bounds(height, n, halo):
    bounds = band_bounds(height, n, halo)
    sizes = [b - a for a, b in bounds]
    assert bounds[0][0] == 0 and bounds[-1][1] == height and len(bounds) == n
    assert all(a % 2 == 0 for a, _ in bounds)
    assert all(bounds[i][1] == bounds[i + 1][0] for i in range(n - 1))
    assert min(sizes) >= halo and max(sizes) - min(sizes) <= 2


def test_thin_bands_raise():
    with pytest.raises(ValueError, match="at least 53 rows") as e:
        band_bounds(48, 3, 17)
    assert "sp=3" in str(e.value)
    band_bounds(53, 3, 17)
    p = StereoParams(dof_strength=2.0).with_shift_bound(W)
    assert stereo_halo(p) == 17
    frames, depths = _clip(h=48)
    with pytest.raises(ValueError, match="at least 53 rows"):
        BandLayout.make(48, ["cpu"] * 3, stereo_halo(p), W)
    with pytest.raises(ValueError, match="cannot lend"):
        halo_exchange_rows([depths[0, :10], depths[0, 10:14]], 6)


# ------------------------------------------------------------------ K3 / K4 band forms

def _splits(h, seed):
    """Row cuts of an h-row frame: random ones, the subject crop's edges
    and one row either side, and a first band that holds no crop row."""
    rng = np.random.default_rng(seed)
    r0, r1 = h // 5, h * 4 // 5
    return {"random": sorted({0, h, *rng.integers(1, h, size=3).tolist()}),
            "crop_edges": [0, r0, r1, h],
            "crop_edges_pm1": [0, r0 - 1, r0 + 1, r1 - 1, r1 + 1, h],
            "no_crop_rows": [0, max(r0 - 3, 1), h]}


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("split", ["random", "crop_edges", "crop_edges_pm1", "no_crop_rows"])
def test_band_stats_match_one_shot(seed, split):
    rng = np.random.default_rng(seed)
    h, w = int(rng.integers(30, 90)), int(rng.integers(20, 80))
    x = rng.random((h, w)).astype(np.float32)
    x[: h // 3] = np.round(x[: h // 3] * 64) / 64  # values on the 64-bin edges
    x[0, :3] = (0.0, 1.0, 1.5)
    xt = torch.from_numpy(x)
    cuts = _splits(h, seed)[split]
    hist = None
    for a, b in zip(cuts[:-1], cuts[1:]):
        hist = stats.quantile_hist_band(xt[a:b], hist)
    assert int(hist.sum()) == h * w
    assert torch.equal(stats.quantile_pair_finish(hist, h * w, 0.02, 0.98),
                       stats.quantile_pair_torch(xt, 0.02, 0.98))
    r0, r1, c0, c1 = h // 5, h * 4 // 5, w // 5, w * 4 // 5
    bufs = []
    for a, b in zip(cuts[:-1], cuts[1:]):
        lo, hi = max(a, r0), min(b, r1)
        bufs.append(stats.subject_hist_band(xt[lo:max(lo, hi), c0:c1]))
    if split == "no_crop_rows":
        assert int(bufs[0].sum()) == 0
    want = stats.subject_stats_torch(xt[r0:r1, c0:c1])
    got = stats.subject_stats_finish(sum(bufs[1:], bufs[0]))
    for a, b in zip(got, want):
        assert torch.equal(a, b), (a, b)
    one = stats.subject_hist_band(xt[r0:r1, c0:c1])
    assert torch.equal(sum(bufs[1:], bufs[0]), one)


# ------------------------------------------------------------------ the banded step

RENDER_CASES = {
    "f32": dict(),
    "bf16_healing": dict(image_dtype="bfloat16", enable_healing=True),
    "bf16_dof": dict(image_dtype="bfloat16", enable_healing=True, dof_strength=2.0),
    "f32_dof_exact": dict(dof_strength=1.0, quantile_mode="exact"),
    "half_sbs": dict(warp_hw=(H, W // 2)),
    "warp_rows": dict(warp_hw=(50, W // 2), image_dtype="bfloat16"),
}


def _banded(params, frames, depths, sp, blanks=None, width=W):
    layout = BandLayout.make(frames.shape[1], ["cpu"] * sp, stereo_halo(params), width)
    return render_chunk_bands(params, init_band_trackers(layout, width), frames, depths, layout,
                              blanks)


@pytest.mark.parametrize("sp", [2, 3])
@pytest.mark.parametrize("case", sorted(RENDER_CASES))
def test_banded_chunk_equals_one_device(case, sp):
    kw = RENDER_CASES[case]
    params = StereoParams(**kw).with_shift_bound(kw.get("warp_hw", (H, W))[1])
    frames, depths = _clip(seed=sp)
    blanks = torch.tensor([False, True, False, False])
    t1, want = render_chunk(params, init_trackers(H, W, device="cpu"), frames, depths, blanks)
    bt, got = _banded(params, frames, depths, sp, blanks)
    for k in want._fields:
        assert torch.equal(getattr(got, k), getattr(want, k)), k
    for f in dataclasses.fields(t1):
        if f.name in ("prev_depth", "prev_norm_depth"):
            assert torch.equal(torch.cat(getattr(bt, f.name)), getattr(t1, f.name)), f.name
        else:
            assert torch.equal(getattr(bt.lead, f.name), getattr(t1, f.name)), f.name


def test_banded_statistics_at_any_width():
    """At 66 columns the statistics and trackers stay bit-identical; the
    eyes within an ulp of float32 (the module docstring's vector tail)."""
    params = StereoParams().with_shift_bound(66)
    frames, depths = _clip(w=66, seed=4)
    t1, want = render_chunk(params, init_trackers(H, 66, device="cpu"), frames, depths)
    bt, got = _banded(params, frames, depths, 2, width=66)
    assert torch.equal(got.subject_depth, want.subject_depth)
    assert torch.equal(got.focal_depth, want.focal_depth)
    for name in ("norm_lo", "norm_hi", "focal", "conv_val", "bar_width", "fw_offset"):
        assert torch.equal(getattr(bt.lead, name), getattr(t1, name)), name
    assert torch.equal(torch.cat(bt.prev_norm_depth), t1.prev_norm_depth)
    assert float((got.left - want.left).abs().max()) <= 1e-6


@pytest.mark.parametrize("sp", [2, 3])
def test_banded_chunk_matches_jax(sp):
    import jax
    import jax.numpy as jnp
    from test_torch_stereo_step import _ssim

    from visiondepth3d_tpu.state import init_trackers as jinit
    from visiondepth3d_tpu.stereo import StereoParams as JParams
    from visiondepth3d_tpu.stereo.step import render_chunk as jrender_chunk

    kw = dict(enable_healing=True, image_dtype="bfloat16", dof_strength=2.0)
    jp = JParams(**kw).with_shift_bound(W)
    frames, depths = _clip(t=3, seed=5)
    _, jout = jax.jit(lambda t, f, d: jrender_chunk(jp, t, f, d))(
        jinit(H, W), jnp.asarray(frames.numpy()), jnp.asarray(depths.numpy()))
    _, got = _banded(StereoParams(**kw).with_shift_bound(W), frames, depths, sp)
    for name in ("left", "right"):
        a = np.asarray(getattr(jout, name), np.float32)
        b = getattr(got, name).float().numpy()
        for i in range(3):
            assert np.abs(a[i] - b[i]).mean() <= 1.0 / 255.0, (name, i)
            assert _ssim(a[i], b[i]) >= 0.99, (name, i)


def test_render_chunk_spatial_on_a_mesh():
    from visiondepth3d_tpu_torch.parallel import make_mesh, render_chunk_spatial
    from visiondepth3d_tpu_torch.parallel.dp import spatial_layout

    params = StereoParams().with_shift_bound(W)
    frames, depths = _clip(seed=6)
    mesh = make_mesh(dp=1, sp=2, devices=["cpu", "cpu"])
    layout = spatial_layout(params, H, W, mesh)
    _, got = render_chunk_spatial(params, init_band_trackers(layout, W), frames, depths, mesh)
    _, want = render_chunk(params, init_trackers(H, W, device="cpu"), frames, depths)
    assert torch.equal(got.left, want.left) and torch.equal(got.right, want.right)


class _OpCount(TorchDispatchMode):
    """Counts the aten ops dispatched inside it."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


# (params, blank frame) -> aten ops of one ``stereo_frame_step`` at 70 x 64
# and of ``render_chunk_bands`` over two frames at sp=2
OP_CASES = {
    "full_sbs": (dict(), False, 1703, 3492),
    "half_sbs": (dict(warp_hw=(H, W // 2)), False, 1706, 3400),
    "bf16_dof": (dict(image_dtype="bfloat16", enable_healing=True, dof_strength=2.0), False,
                 2356, 6104),
    "blank": (dict(), True, 1709, 3510),
    "half_sbs_dof": (dict(warp_hw=(H, W // 2), dof_strength=2.0), False, 2200, 5376),
}


@pytest.mark.parametrize("banded", [False, True], ids=["one_device", "sp2"])
@pytest.mark.parametrize("case", sorted(OP_CASES))
def test_stereo_step_op_counts(case, banded):
    """The stage sequence launches a pinned number of ops on each layout:
    a stage added, dropped or repeated, or a layout that adds work on one
    device, changes the count. The step runs once before it is counted, so
    the resize matrices are already cached."""
    kw, blank, one_device, sp2 = OP_CASES[case]
    params = StereoParams(**kw).with_shift_bound(kw.get("warp_hw", (H, W))[1])
    frames, depths = _clip(t=2)
    blanks, is_blank = (torch.tensor([False, True]), torch.tensor(True)) if blank else (None, None)

    def run():
        if banded:
            return _banded(params, frames, depths, 2, blanks)
        return stereo_frame_step(params, init_trackers(H, W, device="cpu"), frames[0], depths[0],
                                 is_blank)

    run()
    with _OpCount() as count:
        run()
    assert count.n == (sp2 if banded else one_device)


# ------------------------------------------------------------------ the CLI

def _write(path, frames):
    from visiondepth3d_tpu_torch.io import Y4MWriter

    with Y4MWriter(str(path), frames.shape[2], frames.shape[1], 24.0) as wr:
        for f in frames:
            wr.write(f)


@pytest.fixture(scope="module")
def cli_clip(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("halo_cli")
    frames, depths = _clip(h=48, t=8, seed=7)
    _write(tmp / "clip.y4m", (frames.numpy() * 255).astype(np.uint8))
    _write(tmp / "depth.y4m", np.repeat((depths.numpy() * 255).astype(np.uint8)[..., None],
                                        3, -1))
    return tmp


def _cli(tmp, name, *flags):
    from visiondepth3d_tpu_torch.cli.main import main as cli_main

    out = tmp / f"{name}.y4m"
    argv = ["render", "--input", str(tmp / "clip.y4m"), "--device", "cpu", "--output",
            str(out), "--preserve-aspect", "--chunk-size", "4", *flags]
    assert cli_main(argv) == 0
    return out.read_bytes()


def test_cli_render_sp(cli_clip):
    depth = ["--depth", str(cli_clip / "depth.y4m")]
    assert _cli(cli_clip, "sp", "--mesh", "sp=2", *depth) == _cli(cli_clip, "one", "--mesh",
                                                                  "off", *depth)


def test_cli_render_pp_dp(cli_clip):
    fused = ["--allow-random", "--inference-size", "28"]
    got = _cli(cli_clip, "pp", "--mesh", "pp=2,dp=2", *fused)
    want = _cli(cli_clip, "one2", "--mesh", "off", *fused, "--chunk-size", "2")
    assert got == want
