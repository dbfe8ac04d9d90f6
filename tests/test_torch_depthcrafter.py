"""The port's DepthCrafter (CLIP ViT, the spatio-temporal UNet, sliding
windows, the segment-streamed route) against the JAX package.

Every comparison takes one seeded diffusers-named state dict per module
(the port's parameter names, which the JAX converters read), float32:

- CLIP against the JAX ``CLIPVisionEncoder`` (max |d| <= 1e-4 x max |ref|)
  and against transformers' ``CLIPVisionModelWithProjection`` with
  ``hidden_act="gelu"`` (atol 3e-5, the JAX package's own bound);
- the ST-UNet against the JAX ``UNetSpatioTemporal`` with a scalar, a [B]
  and a [B, T] timestep, the latent divisible by 8: 1e-4 x max |ref|;
- F11: a latent whose rows do not halve evenly runs in the port (upsampled
  to the skip's size) where the JAX UNet cannot concatenate and raises;
- ``_denoise_window`` with injected initial latents: 1e-3 x max |ref| (the
  Euler step from sigma 700 cancels latents of magnitude 700);
- ``run_raw`` with the JAX key chain replayed (``jax.random.split`` of
  ``PRNGKey(seed)``, drawn as the JAX ``run_raw`` draws it) through the
  port's ``_draw``: two windows and four windows (re-seeded overlaps, the
  cross-fade): max |d| <= 1e-3 of the depth's range;
- the overlap clamp and ``_windows`` against the JAX pipeline's;
- ``load_depthcrafter`` from the diffusers layout and from the reference's
  flat layout (the UNet at the root with ``unet_config.json``): the
  weights load as saved and run as the pipeline built from them;
- the route against the JAX ``render_depth_video_file`` at 8 and 16 bits:
  a letterboxed 24 fps clip strided to 12 fps, two segments of 6 frames
  sharing 2 (window 4, overlap 2), the same replayed noise on both sides:
  mean |d| <= 1 u8 (257 u16), the letterbox sidecar identical, the float16
  spill removed; a run cancelled after its first segment writes that
  segment and removes the spill too;
- the CLI ``depth --model depthcrafter --allow-random-weights``;
- under the K7 opt-in the spatial self-attention at 576 tokens reaches
  K7's entry, the temporal and cross attention never;
- on a card (``cuda`` marker): the tiny pipeline against the CPU.
"""

from __future__ import annotations

import dataclasses
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
torch.set_num_threads(1)
import torch.nn.functional as F

from visiondepth3d_tpu.depth.diffusion import convert_diffusers as jconv
from visiondepth3d_tpu.depth.diffusion import depthcrafter as jdc
from visiondepth3d_tpu.depth.diffusion.clip_vision import CLIP_TINY as JCLIP_TINY
from visiondepth3d_tpu.depth.diffusion.clip_vision import CLIPVisionEncoder as JCLIP
from visiondepth3d_tpu.depth.diffusion.unet_st import UNET_ST_TINY as JUNET_TINY
from visiondepth3d_tpu.depth.diffusion.unet_st import UNetSpatioTemporal as JUNet
from visiondepth3d_tpu.depth.diffusion.vae import VAE_TINY as JVAE_TINY
from visiondepth3d_tpu.pipeline.depth_pipeline import DepthConfig as JConfig
from visiondepth3d_tpu.pipeline.depth_pipeline import render_depth_video_file as jroute
from test_torch_depth_route import _read, _write_clip
from test_torch_diffusion import _quant_convs, _redraw, _tensors
from test_torch_reference import bounded
from visiondepth3d_tpu_torch.depth.diffusion import (CLIP_TINY, UNET_ST_TINY, VAE_TINY,
                                                     AutoencoderKL, CLIPVisionEncoder,
                                                     DepthCrafterPipeline, UNetSpatioTemporal,
                                                     UNetSTConfig, load_depthcrafter,
                                                     load_diffusers_state)
from visiondepth3d_tpu_torch.depth.diffusion.vae import identity_quant_convs
from visiondepth3d_tpu_torch.kernels import attention as kattention
from visiondepth3d_tpu_torch.ops import attention as tattention
from visiondepth3d_tpu_torch.pipeline.depth_pipeline import DepthConfig, render_depth_video_file

CLIP = dataclasses.replace(CLIP_TINY, projection_dim=UNET_ST_TINY.cross_attention_dim)
JCLIP_CFG = dataclasses.replace(JCLIP_TINY, projection_dim=JUNET_TINY.cross_attention_dim)
WINDOW, OVERLAP = 4, 2
# the route's clip: 64 x 64 with 8-row bars (the tracker finds 6 and 6),
# cropped to 52 rows and to multiples of 8: 48 x 64 frames, as run_raw's
CLIP_HW, BARS = (64, 64), 8
FRAME_HW = (48, 64)


def _close(got, want, tol=1e-4):
    assert got.shape == want.shape and np.isfinite(want).all()
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())


@pytest.fixture(scope="module")
def states():
    """Seeded diffusers-named state dicts of the tiny UNet (mix factors drawn
    too), VAE (quant convs, a bias-free post_quant_conv: the JAX fold is
    exact there, F12) and CLIP."""
    unet = _redraw(UNetSpatioTemporal(UNET_ST_TINY), seed=1)
    rng = np.random.default_rng(2)
    for k in unet:
        if k.endswith("mix_factor"):
            unet[k] = rng.standard_normal(1).astype(np.float32)
    vae = _quant_convs(_redraw(AutoencoderKL(VAE_TINY), seed=3), seed=4)
    vae["post_quant_conv.bias"] = np.zeros(4, np.float32)
    return unet, vae, _redraw(CLIPVisionEncoder(CLIP), seed=5)


def _port_modules(states):
    unet, vae, clip = states
    return (load_diffusers_state(UNetSpatioTemporal(UNET_ST_TINY), _tensors(unet)),
            load_diffusers_state(AutoencoderKL(VAE_TINY), identity_quant_convs(_tensors(vae), 4)),
            load_diffusers_state(CLIPVisionEncoder(CLIP), _tensors(clip)))


def _port_pipe(states, device="cpu", **kw):
    kw = {"num_steps": 2, "window_size": WINDOW, "overlap": OVERLAP, **kw}
    return DepthCrafterPipeline(*_port_modules(states), device=device, **kw)


@pytest.fixture(scope="module")
def jpipe(states):
    unet, vae, clip = states
    return jdc.DepthCrafterPipeline(
        JUNET_TINY, JVAE_TINY, JCLIP_CFG, jconv.convert_unet_st(unet, JUNET_TINY),
        jconv.convert_vae(vae, JVAE_TINY.layers_per_block, len(JVAE_TINY.block_out_channels)),
        jconv.convert_clip_vision(clip, JCLIP_CFG), num_steps=2, window_size=WINDOW,
        overlap=OVERLAP)


def _replay_jax_noise(pipe):
    """Make ``pipe._draw`` give what the JAX ``run_raw`` draws from
    ``PRNGKey(0)``: each run starts with the augmentation noise (a 4-d
    shape) split from a fresh key, then one split per window."""
    state = {}

    def draw(shape, gen):
        if len(shape) == 4:
            state["key"] = jax.random.PRNGKey(0)
        state["key"], k = jax.random.split(state["key"])
        return torch.from_numpy(np.array(jax.random.normal(k, shape)))

    pipe._draw = draw


# ---------------------------------------------------------------- modules


def test_clip_matches_jax(states):
    clip = _port_modules(states)[2].eval()
    img = np.random.default_rng(6).standard_normal((2, 28, 28, 3)).astype(np.float32)
    want = np.asarray(JCLIP(JCLIP_CFG).apply(
        {"params": jconv.convert_clip_vision(states[2], JCLIP_CFG)}, jnp.asarray(img)))
    with torch.no_grad():
        got = clip(torch.from_numpy(img)).numpy()
    _close(got, want)


def test_clip_matches_transformers():
    from transformers import CLIPVisionConfig as HFConfig
    from transformers import CLIPVisionModelWithProjection

    hf_cfg = HFConfig(hidden_size=CLIP.hidden_size, intermediate_size=4 * CLIP.hidden_size,
                      num_hidden_layers=CLIP.num_layers, num_attention_heads=CLIP.num_heads,
                      image_size=CLIP.image_size, patch_size=CLIP.patch_size,
                      projection_dim=CLIP.projection_dim, hidden_act="gelu")
    torch.manual_seed(0)
    hf = CLIPVisionModelWithProjection(hf_cfg).eval()
    clip = load_diffusers_state(CLIPVisionEncoder(CLIP), hf.state_dict()).eval()
    x = torch.from_numpy(np.random.default_rng(7).standard_normal((2, 28, 28, 3)).astype(
        np.float32))
    with torch.no_grad():
        want = hf(x.permute(0, 3, 1, 2)).image_embeds
        got = clip(x)
    torch.testing.assert_close(got, want, atol=3e-5, rtol=0)


def _unet_inputs():
    """B = 2, T = 3 frames of 16 x 8 latents (divisible by 8), the three
    timestep forms, and a 9 x 12 latent for F11."""
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 3, 16, 8, 8)).astype(np.float32)  # [B, T, H, W, C]
    ctx = rng.standard_normal((2, 1, 16)).astype(np.float32)
    ts = {"scalar": np.float32(-1.3), "batch": rng.standard_normal(2).astype(np.float32),
          "frames": rng.standard_normal((2, 3)).astype(np.float32)}
    odd = rng.standard_normal((1, 2, 9, 12, 8)).astype(np.float32)
    return x, ctx, ts, odd


@pytest.fixture(scope="module")
def junet_out(states):
    """The JAX UNet's outputs for each timestep form, from one jitted call."""
    x, ctx, ts, _ = _unet_inputs()
    params = jconv.convert_unet_st(states[0], JUNET_TINY)
    fn = jax.jit(lambda p, x, c, t: {k: JUNet(JUNET_TINY).apply({"params": p}, x, v, c)
                                     for k, v in t.items()})
    return {k: np.asarray(v) for k, v in fn(params, x, ctx, ts).items()}


@pytest.mark.parametrize("timesteps", ["scalar", "batch", "frames"])
def test_unet_st_matches_jax(states, junet_out, timesteps):
    x, ctx, ts, _ = _unet_inputs()
    unet = _port_modules(states)[0].eval()
    with torch.no_grad():
        got = unet(torch.from_numpy(x).permute(0, 1, 4, 2, 3),
                   torch.from_numpy(np.asarray(ts[timesteps])), torch.from_numpy(ctx))
    _close(got.permute(0, 1, 3, 4, 2).numpy(), junet_out[timesteps])


def test_f11_odd_latent(states):
    """A 9 x 12 latent: 5 x 6 one level down; the JAX UNet upsamples 5 to 10
    and cannot concatenate the 9-row skip."""
    _, ctx, _, x = _unet_inputs()
    ctx = ctx[:1]
    params = jconv.convert_unet_st(states[0], JUNET_TINY)
    with pytest.raises(TypeError, match="Cannot concatenate"):
        jax.jit(lambda p, x, c: JUNet(JUNET_TINY).apply({"params": p}, x, 0.5, c))(
            params, x, ctx)
    with torch.no_grad():
        got = _port_modules(states)[0](torch.from_numpy(x).permute(0, 1, 4, 2, 3), 0.5,
                                       torch.from_numpy(ctx))
    assert got.shape == (1, 2, 4, 9, 12) and torch.isfinite(got).all() and got.std() > 0


# ---------------------------------------------------------------- the pipeline


def test_denoise_window_matches_jax(states, jpipe):
    h, w = FRAME_HW[0] // 2, FRAME_HW[1] // 2
    rng = np.random.default_rng(10)
    cond = rng.standard_normal((1, WINDOW, h, w, 4)).astype(np.float32)
    init = rng.standard_normal((1, WINDOW, h, w, 4)).astype(np.float32) * 700.0
    ctx = rng.standard_normal((1, 1, 16)).astype(np.float32)
    want = np.asarray(jpipe._denoise_window(jpipe.unet_params, cond, ctx, init))

    def nchw(a):
        return torch.from_numpy(a).permute(0, 1, 4, 2, 3)

    got = _port_pipe(states)._denoise_window(nchw(cond), torch.from_numpy(ctx), nchw(init))
    # the Euler step from sigma 700 to 0.002 cancels latents of magnitude 700
    # (their float32 ulp is 6e-5) down to the O(1) result
    _close(got.permute(0, 1, 3, 4, 2).numpy(), want, tol=1e-3)


@pytest.mark.parametrize("t", [6, 9])
def test_run_raw_matches_jax(states, jpipe, t):
    """6 frames: windows at 0 and 2; 9 frames: windows at 0, 2, 4, 5 (the
    last re-seeds 3 overlapping frames, the cross-fade ramps 2)."""
    frames = np.random.default_rng(11 + t).random((t, *FRAME_HW, 3)).astype(np.float32)
    want = np.asarray(jpipe.run_raw(frames, seed=0))
    pipe = _port_pipe(states)
    _replay_jax_noise(pipe)
    got = pipe.run_raw(frames)
    assert got.shape == want.shape == (t, *FRAME_HW) and got.dtype == torch.float32
    span = float(want.max() - want.min())
    assert span > 0.05 and np.abs(got.numpy() - want).max() <= 1e-3 * span
    # __call__: the whole-clip min-max of the same depth
    norm = pipe(frames).numpy()
    np.testing.assert_allclose(norm, (got.numpy() - got.min().item()) / (got.max() - got.min())
                               .item(), atol=1e-6)


def test_seeded_draws_repeat(states):
    pipe = _port_pipe(states)
    frames = torch.rand(5, 16, 16, 3, generator=torch.Generator().manual_seed(0))
    one = pipe.run_raw(frames, seed=3)
    assert torch.equal(one, pipe.run_raw(frames, seed=3))
    assert not torch.equal(one, pipe.run_raw(frames, seed=4))


@pytest.mark.parametrize("window,overlap", [(4, 2), (24, 6), (24, 25), (6, 6), (5, 1)])
def test_windows_and_overlap_clamp(states, window, overlap):
    """The reference GUI's 24 / 25 (and any overlap >= window) clamps to
    window - 1; the window starts equal the JAX pipeline's."""
    pipe = _port_pipe(states, window_size=window, overlap=overlap)
    assert pipe.overlap == min(overlap, window - 1)
    jself = types.SimpleNamespace(window_size=window, overlap=pipe.overlap)
    for t in (1, window - 1, window, window + 1, 3 * window + 2, 97):
        starts = pipe._windows(t)
        assert starts == jdc.DepthCrafterPipeline._windows(jself, t)
        covered = set()
        for s in starts:
            covered.update(range(s, s + min(window, t)))
        assert covered == set(range(t))


# ---------------------------------------------------------------- loading


def _save(path, state):
    from safetensors.numpy import save_file

    save_file({k: np.ascontiguousarray(v) for k, v in state.items()}, str(path))


UNET_JSON = dict(block_out_channels=[16, 32], layers_per_block=1, cross_attention_dim=16,
                 attention_head_dim=[2, 4], in_channels=8, out_channels=4, norm_num_groups=4,
                 down_block_types=["CrossAttnDownBlockSpatioTemporal", "DownBlockSpatioTemporal"])
VAE_JSON = dict(block_out_channels=[16, 32], layers_per_block=1, latent_channels=4,
                norm_num_groups=4)
CLIP_JSON = dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=2, patch_size=14,
                 image_size=28, projection_dim=16)


@pytest.mark.parametrize("layout", ["diffusers", "flat"])
def test_load_depthcrafter(states, layout, tmp_path):
    """diffusers: unet/, vae/ and image_encoder/ folders; flat (the
    reference's weights/DepthCrafter): the UNet's safetensors and
    unet_config.json at the root, the other two in their folders."""
    unet, vae, clip = states
    comps = [("vae", vae, VAE_JSON, "diffusion_pytorch_model"),
             ("image_encoder", clip, CLIP_JSON, "model")]
    if layout == "diffusers":
        comps.append(("unet", unet, UNET_JSON, "diffusion_pytorch_model"))
    else:
        _save(tmp_path / "diffusion_pytorch_model.safetensors", unet)
        (tmp_path / "unet_config.json").write_text(json.dumps(UNET_JSON))
    for name, state, cfg, stem in comps:
        (tmp_path / name).mkdir()
        _save(tmp_path / name / f"{stem}.safetensors", state)
        (tmp_path / name / "config.json").write_text(json.dumps(cfg))
    pipe = load_depthcrafter(tmp_path, steps=2, window=WINDOW, overlap=OVERLAP, device="cpu")
    assert (pipe.unet_cfg, pipe.vae_cfg, pipe.clip_cfg) == (UNET_ST_TINY, VAE_TINY, CLIP)
    for module, state in ((pipe.unet, unet), (pipe.clip, clip)):
        for k, v in module.state_dict().items():
            assert torch.equal(v, torch.from_numpy(state[k])), k
    frames = torch.rand(5, 16, 16, 3, generator=torch.Generator().manual_seed(1))
    torch.testing.assert_close(pipe.run_raw(frames, seed=2),
                               _port_pipe(states).run_raw(frames, seed=2), atol=0, rtol=0)


# ---------------------------------------------------------------- the route


def _route_cfg(bits, **kw):
    return dict(model="depthcrafter", bits=bits, invert=bits == 16, track_letterbox=True,
                target_fps=12.0, window_size=WINDOW, overlap=OVERLAP, max_segment_frames=6,
                **kw)


@pytest.mark.parametrize("bits", [8, 16])
def test_route_matches_jax(states, jpipe, bits, tmp_path):
    """20 frames at 24 fps -> 10 at 12 fps: a segment of 6 (4 written, 2
    held), a second of 2 + 4, its last 2 written at the end."""
    from visiondepth3d_tpu.io.depth_io import Depth16Reader
    from visiondepth3d_tpu.io.y4m import Y4MReader

    n_src, n = 20, 10
    clip = tmp_path / "clip.y4m"
    _write_clip(clip, *CLIP_HW, n_src, BARS)
    ext = "vd16" if bits == 16 else "y4m"
    assert bounded(jroute, clip, tmp_path / f"jax.{ext}",
                   JConfig(mesh="off", **_route_cfg(bits)), predictor=jpipe) == n
    pipe = _port_pipe(states)
    _replay_jax_noise(pipe)
    out = tmp_path / f"port.{ext}"
    assert render_depth_video_file(clip, out, DepthConfig(device="cpu", **_route_cfg(bits)),
                                   predictor=pipe) == n
    assert not (tmp_path / f"port.{ext}.raw16.tmp").exists()
    side = [json.loads((tmp_path / f"{s}.{ext}.letterbox.json").read_text())
            for s in ("jax", "port")]
    assert side[0] == side[1] and side[0]["top"] > 0, side
    rows = FRAME_HW[0] + side[0]["top"] + side[0]["bottom"]
    want, got = _read(tmp_path / f"jax.{ext}"), _read(out)
    assert got.shape == want.shape == (n, rows, FRAME_HW[1]) and got.std() > 0
    assert np.abs(got - want).mean() <= (257 if bits == 16 else 1)
    reader = Depth16Reader if bits == 16 else Y4MReader
    with reader(str(out)) as rd:  # read to the end (F23)
        assert rd.fps == 12.0 and len(list(rd)) == n


def test_cancel_after_a_segment(states, tmp_path):
    clip = tmp_path / "clip.y4m"
    _write_clip(clip, 48, 64, 20)
    polls = []
    out = tmp_path / "depth.y4m"
    n = render_depth_video_file(clip, out, DepthConfig(device="cpu", **_route_cfg(8)),
                                predictor=_port_pipe(states),
                                cancel_check=lambda: polls.append(1) or len(polls) > 1)
    assert n == 6 and len(polls) == 2 and _read(out).shape == (6, 48, 64)
    assert not (tmp_path / "depth.y4m.raw16.tmp").exists()


def test_cli_depth_depthcrafter(tmp_path):
    """The tiny random pipeline on the CPU: a 30-frame 24 fps clip strided
    at the default 15 fps target (stride round(24 / 15) = 2, 12 fps out) -> 15
    frames; without weights the CLI refuses."""
    from visiondepth3d_tpu.io import Y4MReader
    from visiondepth3d_tpu_torch.cli.main import main as cli_main

    clip, out = tmp_path / "clip.y4m", tmp_path / "depth.y4m"
    _write_clip(clip, 36, 44, 30)
    args = ["depth", "--input", str(clip), "--model", "depthcrafter", "--output", str(out),
            "--device", "cpu", "--steps", "1", "--window", "6", "--overlap", "2"]
    assert cli_main(args) == 2
    assert cli_main(args + ["--allow-random-weights"]) == 0
    with Y4MReader(str(out)) as rd:
        fps = rd.fps
        depth = np.stack(list(rd))
    assert depth.shape == (15, 32, 40, 3) and fps == 12.0 and depth.std() > 0


def test_k7_route_in_st_unet(monkeypatch):
    """A tiny ST-UNet with 16-wide heads at level 0 and a 24 x 24 latent
    (576 tokens): per call the spatial self-attention of down0 and of up1's
    two layers reach K7; the temporal (T tokens) and cross attention go to
    SDPA."""
    cfg = UNetSTConfig(block_out_channels=(32, 64), layers_per_block=1,
                       attention_head_dim=(2, 4), cross_attention_dim=16, norm_groups=4,
                       with_attn=(True, False))
    gen = torch.Generator().manual_seed(12)
    unet = UNetSpatioTemporal(cfg).eval()
    with torch.no_grad():
        for p in unet.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * p[0].numel() ** -0.5)
    x = torch.randn(1, 2, 8, 24, 24, generator=gen)
    ctx = torch.randn(1, 1, 16, generator=gen)
    with torch.no_grad():
        want = unet(x, 0.3, ctx)
    k7, sdpa = [], []
    plain, lib = kattention.vmem_attention, F.scaled_dot_product_attention
    monkeypatch.setattr(kattention, "vmem_attention",
                        lambda q, k, v: k7.append(tuple(q.shape)) or plain(q, k, v))
    monkeypatch.setattr(F, "scaled_dot_product_attention",
                        lambda q, k, v: sdpa.append(tuple(q.shape)) or lib(q, k, v))
    monkeypatch.setattr(tattention, "USE_VMEM_KERNEL", True)
    with torch.no_grad():
        got = unet(x, 0.3, ctx)
    assert k7 == [(2, 576, 2, 16)] * 3
    # SDPA takes BHND: the spatial cross attention (576 queries, one key), the
    # temporal self and cross attention (2 frames at 576 positions), and the
    # mid block's at 12 x 12 (144 tokens, under K7's 512)
    assert sorted(set(sdpa)) == [(2, 2, 576, 16), (2, 4, 144, 16), (144, 4, 2, 16),
                                 (576, 2, 2, 16)]
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)


# ---------------------------------------------------------------- the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_depthcrafter_matches_cpu(states, cuda):
    """The tiny pipeline in float32 (TF32 off) on the card against the CPU,
    the same noise on both sides: 1e-4 of the depth's range."""
    frames = torch.from_numpy(np.random.default_rng(13).random((9, 32, 48, 3)).astype(
        np.float32))
    rng = np.random.default_rng(14)
    noise = {4: rng.standard_normal((9, 32, 48, 3)), 5: rng.standard_normal((1, 4, 16, 24, 4))}
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        out = {}
        for dev in ("cpu", "cuda"):
            pipe = _port_pipe(states, device=dev)
            pipe._draw = lambda shape, gen: torch.from_numpy(noise[len(shape)].astype(np.float32))
            out[dev] = pipe.run_raw(frames.to(dev)).cpu()
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    span = (out["cpu"].max() - out["cpu"].min()).item()
    assert span > 0.05 and (out["cuda"] - out["cpu"]).abs().max().item() <= 1e-4 * span
