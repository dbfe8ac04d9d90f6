"""The port's diffusion stack (schedulers, SD VAE, SD2 UNet, Marigold) and
the two attention repairs that came with it, against the JAX package.

- The dispatcher promotes mixed q, k, v types to their common type, as the
  JAX package does (SDPA itself refuses them): an f32 q with bf16 k and v
  equals the JAX dispatcher's promoted result (1e-6).
- K7's head-dim gate: under the opt-in, a head dim K7 is not built for
  (the VAE's one head of 512) goes to SDPA; the routes are recorded.
- DDIM (trailing spacing, v-prediction, eta 0) and Euler against the JAX
  schedulers: timesteps and sigmas equal, steps within 1e-6.
- ``UNET2D_TINY`` and ``VAE_TINY`` from one seeded diffusers-named state
  dict (the port's parameter names, which the JAX converters read and
  ``tests/test_diffusion_convert.py`` builds from the JAX trees): float32
  max |d| <= 1e-4 x max |ref|. The port keeps ``quant_conv`` /
  ``post_quant_conv`` as layers; the JAX converter folds them into the
  neighbouring convs, which is exact for ``quant_conv`` and for a
  bias-free ``post_quant_conv``, and not on the latent's border ring where
  ``post_quant_conv`` has a bias (ROADMAP Queue 3, F12): there the port
  equals the JAX decoder fed the 1x1-transformed latent.
- Marigold's ``_run`` with the same numpy noise: max |d| <= 1e-3 of the
  depth's range (the DDIM loop); bfloat16 no further from the JAX float32
  depth than the JAX bf16 depth is, plus 25 %. ``_run_ens`` at E = 2 and 3
  (the median: for an even E the mean of the two middle values).
- F11: at a latent of 9 rows the JAX UNet cannot concatenate its skip and
  raises; the port upsamples to the skip's size and returns the depth.
  Where the latent divides evenly the upsample is the JAX package's bit
  for bit.
- ``load_marigold`` from a diffusers checkpoint directory, against the JAX
  loader on the same directory; the dispatcher's refusals.
- ``render_depth_video_file`` with ``marigold`` on tiny y4m clips against
  the JAX route, both pipelines drawing their noise from one numpy array
  (the test wraps each pipeline's ``_run``): mean |d| <= 1 u8 (257 u16).
- With the K7 opt-in the UNet's and the VAE's self-attention at 512 <= N <
  4096 goes to K7, cross-attention never.
"""

from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
torch.set_num_threads(1)
import torch.nn.functional as F

from visiondepth3d_tpu.depth.diffusion import loaders as jloaders
from visiondepth3d_tpu.depth.diffusion import marigold as jmarigold
from visiondepth3d_tpu.depth.diffusion import schedulers as jsched
from visiondepth3d_tpu.depth.diffusion import (UNET2D_TINY as JUNET_TINY, VAE_TINY as JVAE_TINY,
                                               AutoencoderKL as JVAE, UNet2DCondition as JUNet,
                                               convert_unet2d, convert_vae)
from visiondepth3d_tpu.ops.attention import multi_head_attention as jmha
from visiondepth3d_tpu.pipeline.depth_pipeline import DepthConfig as JConfig
from visiondepth3d_tpu.pipeline.depth_pipeline import render_depth_video_file as jroute
from test_torch_depth_route import _read, _write_clip
from test_torch_reference import bounded
from visiondepth3d_tpu_torch.depth import registry as tregistry
from visiondepth3d_tpu_torch.depth.diffusion import (UNET2D_TINY, VAE_TINY, AutoencoderKL,
                                                     DDIMSchedule, EulerSchedule,
                                                     MarigoldPipeline, UNet2DCondition,
                                                     VAEConfig, load_diffusers_state,
                                                     load_diffusion_pipeline, load_marigold,
                                                     svd_precondition)
from visiondepth3d_tpu_torch.depth.diffusion.marigold import median0
from visiondepth3d_tpu_torch.depth.diffusion.vae import identity_quant_convs
from visiondepth3d_tpu_torch.kernels import attention as kattention
from visiondepth3d_tpu_torch.ops import attention as tattention
from visiondepth3d_tpu_torch.pipeline.depth_pipeline import DepthConfig, render_depth_video_file

CTX_TOKENS = 7


# ---------------------------------------------------------------- the repairs


def test_mixed_dtype_attention_promotes_as_jax():
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((2, 40, 2, 16)).astype(np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((2, 7, 2, 16)).astype(np.float32))
            .bfloat16() for _ in range(2))
    with pytest.raises(RuntimeError):  # what the dispatcher used to pass on
        F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
    got = tattention.multi_head_attention(q, k, v)
    want = np.asarray(jmha(jnp.asarray(q.numpy()), jnp.asarray(k.float().numpy(), jnp.bfloat16),
                           jnp.asarray(v.float().numpy(), jnp.bfloat16)))
    assert got.dtype == torch.float32 and want.dtype == np.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)


def test_k7_head_dim_gate(monkeypatch):
    """Under the opt-in: head dim 64 at N = 600 goes to K7; 512 (the VAE's
    mid block) and 48 go to SDPA, without a K7 call."""
    routes = []
    plain, sdpa = kattention.vmem_attention, F.scaled_dot_product_attention
    monkeypatch.setattr(kattention, "vmem_attention",
                        lambda q, k, v: routes.append(("K7", q.shape[-1])) or plain(q, k, v))
    monkeypatch.setattr(F, "scaled_dot_product_attention",
                        lambda q, k, v: routes.append(("SDPA", q.shape[-1])) or sdpa(q, k, v))
    monkeypatch.setattr(tattention, "USE_VMEM_KERNEL", True)
    for d in (64, 512, 48):
        x = torch.randn(1, 600, 1, d, generator=torch.Generator().manual_seed(d))
        want = sdpa(x.transpose(1, 2), x.transpose(1, 2), x.transpose(1, 2)).transpose(1, 2)
        torch.testing.assert_close(tattention.multi_head_attention(x, x, x), want,
                                   atol=1e-5, rtol=0)
    assert routes == [("K7", 64), ("SDPA", 512), ("SDPA", 48)]
    # the VAE's mid block at 24 x 24 latents (576 tokens, one head of 512)
    vae = AutoencoderKL(VAEConfig(block_out_channels=(512,), layers_per_block=1)).eval()
    routes.clear()
    with torch.no_grad():
        vae.encode_mode(torch.rand(1, 3, 24, 24))
    assert routes == [("SDPA", 512)]


# ---------------------------------------------------------------- schedulers


@pytest.mark.parametrize("steps", [1, 2, 4, 10])
@pytest.mark.parametrize("prediction", ["v_prediction", "epsilon"])
def test_ddim_matches_jax(steps, prediction):
    mine = DDIMSchedule(num_inference_steps=steps, prediction_type=prediction)
    theirs = jsched.DDIMSchedule(num_inference_steps=steps, prediction_type=prediction)
    np.testing.assert_array_equal(mine.timesteps, theirs.timesteps)
    rng = np.random.default_rng(steps)
    x, v = (rng.standard_normal((2, 4, 5, 6)).astype(np.float32) for _ in range(2))
    for i in range(steps):
        got = mine.step(torch.from_numpy(v), i, torch.from_numpy(x)).numpy()
        want = np.asarray(theirs.step(jnp.asarray(v), i, jnp.asarray(x)))
        np.testing.assert_allclose(got, want, atol=1e-6)
        got = mine.add_noise(torch.from_numpy(x), torch.from_numpy(v), mine.timesteps[i])
        np.testing.assert_allclose(got.numpy(), np.asarray(theirs.add_noise(
            jnp.asarray(x), jnp.asarray(v), theirs.timesteps[i])), atol=1e-6)


def test_euler_matches_jax():
    mine, theirs = EulerSchedule(num_inference_steps=3), jsched.EulerSchedule(num_inference_steps=3)
    np.testing.assert_array_equal(mine.sigmas, theirs.sigmas)
    assert mine.init_noise_sigma() == theirs.init_noise_sigma()
    rng = np.random.default_rng(1)
    x, d = (rng.standard_normal((2, 3, 4)).astype(np.float32) for _ in range(2))
    for i in range(3):
        np.testing.assert_allclose(mine.step(torch.from_numpy(d), i, torch.from_numpy(x)).numpy(),
                                   np.asarray(theirs.step(jnp.asarray(d), i, jnp.asarray(x))),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(mine.scale_input(torch.from_numpy(x), i).numpy(),
                                   np.asarray(theirs.scale_input(jnp.asarray(x), i)), rtol=1e-6)
    for sigma in (0.002, 1.0, 700.0):
        assert svd_precondition(sigma) == jsched.svd_precondition(sigma)


# ---------------------------------------------------------------- UNet and VAE


def _redraw(module: torch.nn.Module, seed: int) -> dict[str, np.ndarray]:
    """Seeded values on a module's (diffusers) keys: fan-in scaled weights,
    norm scales near 1, small biases."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in sorted(module.state_dict().items()):
        s = tuple(v.shape)
        if "norm" in k and k.endswith("weight"):
            out[k] = 1.0 + 0.1 * rng.standard_normal(s)
        elif len(s) >= 2:
            out[k] = rng.standard_normal(s) / np.sqrt(np.prod(s[1:]))
        else:
            out[k] = 0.05 * rng.standard_normal(s)
    return {k: v.astype(np.float32) for k, v in out.items()}


def _quant_convs(flat: dict, seed: int) -> dict:
    """Near-identity quant convs with biases."""
    rng = np.random.default_rng(seed)
    flat = dict(flat)
    flat["quant_conv.weight"] = (np.eye(8) + 0.3 * rng.standard_normal((8, 8)))[:, :, None, None]
    flat["quant_conv.bias"] = 0.1 * rng.standard_normal(8)
    flat["post_quant_conv.weight"] = (np.eye(4) + 0.3 * rng.standard_normal((4, 4)))[
        :, :, None, None]
    flat["post_quant_conv.bias"] = 0.1 * rng.standard_normal(4)
    return {k: np.asarray(v, np.float32) for k, v in flat.items()}


@pytest.fixture(scope="module")
def unet_state():
    return _redraw(UNet2DCondition(UNET2D_TINY), seed=1)


@pytest.fixture(scope="module")
def vae_state():
    return _quant_convs(_redraw(AutoencoderKL(VAE_TINY), seed=2), seed=3)


def _tensors(flat: dict) -> dict[str, torch.Tensor]:
    return {k: torch.from_numpy(v) for k, v in flat.items()}


def _port_unet(state):
    return load_diffusers_state(UNet2DCondition(UNET2D_TINY), _tensors(state)).eval()


def _port_vae(state):
    return load_diffusers_state(AutoencoderKL(VAE_TINY),
                                identity_quant_convs(_tensors(state), 4)).eval()


def _jvae_params(state):
    return convert_vae(state, JVAE_TINY.layers_per_block, len(JVAE_TINY.block_out_channels))


def _nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> np.ndarray:
    return x.permute(0, 2, 3, 1).numpy()


def _close(got, want, tol=1e-4):
    assert got.shape == want.shape and np.isfinite(want).all()
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())


def test_unet_matches_jax(unet_state):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 8, 12, 8)).astype(np.float32)
    ctx = rng.standard_normal((2, CTX_TOKENS, 32)).astype(np.float32)
    params = convert_unet2d(unet_state, JUNET_TINY)
    jfn = jax.jit(lambda t: JUNet(JUNET_TINY).apply({"params": params}, jnp.asarray(x), t,
                                                     jnp.asarray(ctx)))
    unet = _port_unet(unet_state)
    for t in (999.0, 1.0):
        want = np.asarray(jfn(jnp.asarray(t)))
        with torch.no_grad():
            got = _nhwc(unet(_nchw(x), t, torch.from_numpy(ctx)))
        _close(got, want)


def test_vae_matches_jax(vae_state):
    """Encode with ``quant_conv`` (the JAX fold is exact there), decode with
    a bias-free ``post_quant_conv``."""
    state = dict(vae_state, **{"post_quant_conv.bias": np.zeros(4, np.float32)})
    params, jm = _jvae_params(state), JVAE(JVAE_TINY)
    img = np.random.default_rng(5).random((2, 16, 20, 3)).astype(np.float32) * 2 - 1
    lat = np.asarray(jm.apply({"params": params}, jnp.asarray(img), method=JVAE.encode_mode))
    dec = np.asarray(jm.apply({"params": params}, jnp.asarray(lat), method=JVAE.decode))
    vae = _port_vae(state)
    with torch.no_grad():
        _close(_nhwc(vae.encode_mode(_nchw(img))), lat)
        _close(_nhwc(vae.decode(_nchw(lat))), dec)


def test_post_quant_conv_kept_as_a_layer(vae_state):
    """F12: the JAX converter folds post_quant_conv's bias into
    decoder.conv_in as if every tap saw it, including the taps on the zero
    padding; the port applies the 1x1 layer first (diffusers' order)."""
    lat = np.random.default_rng(6).standard_normal((1, 8, 10, 4)).astype(np.float32)
    vae = _port_vae(vae_state)
    with torch.no_grad():
        got = _nhwc(vae.decode(_nchw(lat)))
        z = vae.post_quant_conv(_nchw(lat) / VAE_TINY.scaling_factor)
    # the JAX decoder without post_quant_conv, fed the transformed latent
    bare = {k: v for k, v in vae_state.items() if not k.startswith("post_quant_conv")}
    jm = JVAE(JVAE_TINY)
    want = np.asarray(jm.apply({"params": _jvae_params(bare)},
                               jnp.asarray(_nhwc(z) * VAE_TINY.scaling_factor),
                               method=JVAE.decode))
    _close(got, want)
    folded = np.asarray(jm.apply({"params": _jvae_params(vae_state)}, jnp.asarray(lat),
                                 method=JVAE.decode))
    assert np.abs(folded - want).max() > 1e-3 * np.abs(want).max()


def test_upsample_to_skip_is_jax_nearest_where_it_divides():
    x = np.random.default_rng(7).standard_normal((1, 5, 7, 3)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (1, 10, 14, 3), "nearest"))
    got = _nhwc(F.interpolate(_nchw(x), size=(10, 14), mode="nearest"))
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------- Marigold


def _pipelines(unet_state, vae_state, steps=2, dtype="float32"):
    ctx = np.random.default_rng(8).standard_normal((1, CTX_TOKENS, 32)).astype(np.float32)
    jpipe = jmarigold.MarigoldPipeline(JUNET_TINY, JVAE_TINY, convert_unet2d(unet_state,
                                                                            JUNET_TINY),
                                       _jvae_params(vae_state), ctx, num_steps=steps)
    jpipe = jloaders._cast_pipeline(jpipe, dtype)
    tpipe = MarigoldPipeline(_port_unet(unet_state), _port_vae(vae_state), ctx,
                             num_steps=steps, dtype=dtype, device="cpu")
    return jpipe, tpipe


def _no_post_bias(vae_state):
    return dict(vae_state, **{"post_quant_conv.bias": np.zeros(4, np.float32)})


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_marigold_run_matches_jax(unet_state, vae_state, dtype):
    rng = np.random.default_rng(9)
    rgb = rng.random((2, 16, 24, 3)).astype(np.float32)
    noise = rng.standard_normal((2, 8, 12, 4)).astype(np.float32)
    jpipe, tpipe = _pipelines(unet_state, _no_post_bias(vae_state), dtype=dtype)
    want = np.asarray(jpipe._run(jpipe.unet_params, jpipe.vae_params, rgb, noise))
    got = tpipe._run(torch.from_numpy(rgb), torch.from_numpy(noise)).numpy()
    assert got.shape == want.shape == (2, 16, 24) and got.dtype == np.float32
    span = float(want.max() - want.min())
    assert span > 0.05
    if dtype == "float32":
        assert np.abs(got - want).max() <= 1e-3 * span
    else:
        jref, _ = _pipelines(unet_state, _no_post_bias(vae_state))
        ref = np.asarray(jref._run(jref.unet_params, jref.vae_params, rgb, noise))
        mine, theirs = np.abs(got - ref), np.abs(want - ref)
        assert mine.max() <= 1.25 * theirs.max(), (mine.max(), theirs.max())


@pytest.mark.parametrize("e", [2, 3])
def test_marigold_ensemble_matches_jax(unet_state, vae_state, e):
    rng = np.random.default_rng(10 + e)
    rgb = rng.random((2, 16, 16, 3)).astype(np.float32)
    noise = rng.standard_normal((e, 2, 8, 8, 4)).astype(np.float32)
    jpipe, tpipe = _pipelines(unet_state, _no_post_bias(vae_state))
    want = np.asarray(jpipe._run_ens(jpipe.unet_params, jpipe.vae_params, rgb, noise))
    got = tpipe._run_ens(torch.from_numpy(rgb), torch.from_numpy(noise)).numpy()
    assert got.shape == want.shape == (2, 16, 16)
    assert np.abs(got - want).max() <= 1e-3 * float(want.max() - want.min())
    # the ensemble is the median of the members run one by one
    members = torch.stack([tpipe._run(torch.from_numpy(rgb), torch.from_numpy(n))
                           for n in noise])
    torch.testing.assert_close(torch.from_numpy(got), median0(members), atol=1e-5, rtol=0)


def test_median_is_jax_median():
    x = np.random.default_rng(11).standard_normal((4, 3, 5)).astype(np.float32)
    for e in (1, 2, 3, 4):
        np.testing.assert_array_equal(median0(torch.from_numpy(x[:e])).numpy(),
                                      np.asarray(jnp.median(jnp.asarray(x[:e]), axis=0)))


def test_seeded_call_draws_per_member_noise(unet_state, vae_state):
    _, tpipe = _pipelines(unet_state, vae_state, steps=1)
    rgb = torch.rand(1, 16, 16, 3, generator=torch.Generator().manual_seed(0))
    one = tpipe(rgb, seed=3)
    assert torch.equal(one, tpipe(rgb, seed=3)) and not torch.equal(one, tpipe(rgb, seed=4))
    tpipe.ensemble_size = 3
    members = torch.stack([tpipe._run(rgb, torch.randn(
        (1, 8, 8, 4), generator=torch.Generator().manual_seed(3 + m))) for m in range(3)])
    torch.testing.assert_close(tpipe(rgb, seed=3), median0(members), atol=0, rtol=0)


def test_f11_odd_latent(unet_state, vae_state):
    """An 18 x 32 frame: a 9 x 16 latent, 5 x 8 one level down. The JAX
    UNet upsamples 5 to 10 and cannot concatenate the 9-row skip."""
    rng = np.random.default_rng(12)
    rgb = rng.random((1, 18, 32, 3)).astype(np.float32)
    noise = rng.standard_normal((1, 9, 16, 4)).astype(np.float32)
    jpipe, tpipe = _pipelines(unet_state, vae_state, steps=1)
    with pytest.raises(TypeError, match="Cannot concatenate"):
        jpipe._run(jpipe.unet_params, jpipe.vae_params, rgb, noise)
    got = tpipe._run(torch.from_numpy(rgb), torch.from_numpy(noise))
    assert got.shape == (1, 18, 32) and torch.isfinite(got).all() and got.std() > 0


# ---------------------------------------------------------------- loading


def _save_checkpoint(root, unet_state, vae_state, embed=None):
    from safetensors.numpy import save_file

    for name, state, cfg in (
            ("unet", unet_state, dict(in_channels=8, out_channels=4, block_out_channels=[32, 64],
                                      layers_per_block=1, attention_head_dim=[2, 4],
                                      cross_attention_dim=32, norm_num_groups=8,
                                      down_block_types=["CrossAttnDownBlock2D",
                                                        "DownBlock2D"])),
            ("vae", vae_state, dict(block_out_channels=[16, 32], layers_per_block=1,
                                    latent_channels=4, norm_num_groups=4))):
        (root / name).mkdir(parents=True)
        save_file(state, str(root / name / "diffusion_pytorch_model.safetensors"))
        (root / name / "config.json").write_text(json.dumps(cfg))
    if embed is not None:
        np.save(root / "empty_text_embed.npy", embed)


def test_load_marigold_matches_jax_loader(unet_state, vae_state, tmp_path):
    embed = np.random.default_rng(13).standard_normal((1, CTX_TOKENS, 32)).astype(np.float32)
    _save_checkpoint(tmp_path, unet_state, _no_post_bias(vae_state), embed)
    jpipe = jloaders.load_marigold(tmp_path, steps=2)
    tpipe = load_marigold(tmp_path, steps=2, device="cpu")
    assert tpipe.unet_cfg == UNET2D_TINY and tpipe.vae_cfg == VAE_TINY
    rng = np.random.default_rng(14)
    rgb = rng.random((1, 16, 16, 3)).astype(np.float32)
    noise = rng.standard_normal((1, 8, 8, 4)).astype(np.float32)
    want = np.asarray(jpipe._run(jpipe.unet_params, jpipe.vae_params, rgb, noise))
    got = tpipe._run(torch.from_numpy(rgb), torch.from_numpy(noise)).numpy()
    assert np.abs(got - want).max() <= 1e-3 * float(want.max() - want.min())
    # the catalog's route to it
    pred = tregistry.load_predictor("marigold", str(tmp_path), device="cpu", steps=3)
    assert isinstance(pred, MarigoldPipeline) and pred.num_steps == 3


def test_missing_text_embed_is_zeros_with_a_warning(unet_state, vae_state, tmp_path):
    _save_checkpoint(tmp_path, unet_state, vae_state)
    with pytest.warns(UserWarning, match="empty_text_embed"):
        pipe = load_marigold(tmp_path, device="cpu")
    assert pipe.ctx.shape == (1, 77, 32) and not pipe.ctx.any()


def test_dispatcher_refusals(tmp_path):
    """Without a checkpoint or allow_random both diffusion entries refuse;
    DepthCrafter's tiny random pipeline loads and routes now."""
    for name in ("marigold", "depthcrafter"):
        with pytest.raises(ValueError, match="checkpoint directory"):
            tregistry.load_predictor(name, device="cpu")
    dc = load_diffusion_pipeline("depthcrafter", allow_random=True, device="cpu", window=4,
                                 overlap=2)
    assert dc.unet_cfg.block_out_channels == (16, 32) and (dc.window_size, dc.overlap) == (4, 2)
    tiny = tregistry.load_predictor("marigold", device="cpu", allow_random=True)
    assert tiny.unet_cfg == UNET2D_TINY and tiny.num_steps == 2
    out = tiny(torch.rand(1, 16, 16, 3))
    assert out.shape == (1, 16, 16) and 0 <= out.min() and out.max() <= 1
    clip = tmp_path / "clip.y4m"
    _write_clip(clip, 16, 16, 1)
    with pytest.raises(ValueError, match="checkpoint directory"):
        render_depth_video_file(clip, tmp_path / "x.y4m",
                                DepthConfig(model="depthcrafter", device="cpu"))
    assert render_depth_video_file(clip, tmp_path / "x.y4m",
                                   DepthConfig(model="depthcrafter", device="cpu",
                                               allow_random=True)) == 1


# ---------------------------------------------------------------- the route


def _feed_noise(pipe, noise: np.ndarray, jax_side: bool):
    """Wrap the pipeline's ``_run`` to take consecutive batches of ``noise``
    (one array for both sides) instead of the noise it drew."""
    orig, pos = pipe._run, [0]

    def take(b):
        out = noise[pos[0]: pos[0] + b]
        pos[0] += b
        return out

    if jax_side:
        pipe._run = lambda up, vp, rgb, _: orig(up, vp, rgb, take(rgb.shape[0]))
    else:
        pipe._run = lambda rgb, _: orig(rgb, torch.from_numpy(take(rgb.shape[0])))


@pytest.mark.parametrize("bits", [8, 16])
def test_route_matches_jax(unet_state, vae_state, bits, tmp_path):
    """A 5-frame 52 x 70 clip (cropped to 48 x 64), batches of 2, 2 and 1."""
    n = 5
    clip = tmp_path / "clip.y4m"
    _write_clip(clip, 52, 70, n)
    noise = np.random.default_rng(15).standard_normal((n, 24, 32, 4)).astype(np.float32)
    jpipe, tpipe = _pipelines(unet_state, _no_post_bias(vae_state))
    _feed_noise(jpipe, noise, True)
    _feed_noise(tpipe, noise, False)
    ext = "vd16" if bits == 16 else "y4m"
    kw = dict(model="marigold", batch_size=2, bits=bits, invert=bits == 16)
    assert bounded(jroute, clip, tmp_path / f"jax.{ext}", JConfig(mesh="off", **kw),
                   predictor=jpipe) == n
    assert render_depth_video_file(clip, tmp_path / f"port.{ext}",
                                   DepthConfig(device="cpu", **kw), predictor=tpipe) == n
    want, got = _read(tmp_path / f"jax.{ext}"), _read(tmp_path / f"port.{ext}")
    assert got.shape == want.shape == (n, 48, 64) and got.std() > 0
    assert np.abs(got - want).mean() <= (257 if bits == 16 else 1)


def test_k7_route_in_unet_and_vae(unet_state, vae_state, monkeypatch):
    """48 x 48 frames: 24 x 24 latents (576 tokens). Per UNet call the level-0
    self-attentions (one down, two up) go to K7; the VAE's mid blocks
    (encoder and decoder, one head of 32) too; cross-attention never."""
    rng = np.random.default_rng(16)
    rgb = torch.from_numpy(rng.random((1, 48, 48, 3)).astype(np.float32))
    noise = torch.from_numpy(rng.standard_normal((1, 24, 24, 4)).astype(np.float32))
    _, tpipe = _pipelines(unet_state, vae_state, steps=2)
    want = tpipe._run(rgb, noise)
    calls = []
    plain = kattention.vmem_attention
    monkeypatch.setattr(kattention, "vmem_attention",
                        lambda q, k, v: calls.append(tuple(q.shape)) or plain(q, k, v))
    monkeypatch.setattr(tattention, "USE_VMEM_KERNEL", True)
    got = tpipe._run(rgb, noise)
    assert calls == [(1, 576, 1, 32)] + [(1, 576, 2, 16)] * 3 * 2 + [(1, 576, 1, 32)]
    torch.testing.assert_close(got, want, atol=1e-4, rtol=0)


def test_cli_depth_marigold(tmp_path):
    """``vd3d-torch depth --model marigold --allow-random-weights --steps 1``
    on the CPU: the tiny random pipeline, frames cropped to multiples of 8;
    without either flag the CLI refuses."""
    from visiondepth3d_tpu.io import Y4MReader
    from visiondepth3d_tpu_torch.cli.main import main as cli_main

    clip, out = tmp_path / "clip.y4m", tmp_path / "depth.y4m"
    _write_clip(clip, 36, 44, 3)
    args = ["depth", "--input", str(clip), "--model", "marigold", "--output", str(out),
            "--device", "cpu", "--steps", "1", "--batch-size", "2"]
    assert cli_main(args) == 2
    assert cli_main(args + ["--allow-random-weights"]) == 0
    with Y4MReader(str(out)) as rd:
        depth = np.stack(list(rd))
    assert depth.shape == (3, 32, 40, 3) and depth.std() > 0
