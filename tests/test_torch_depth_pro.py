"""The port's Depth Pro against the JAX package and against transformers.

At the JAX package's tiny config (``DEPTH_PRO_TINY``: three ViTs of width
32 and 4 layers, 32 px windows over the image at ratios 0.5 and 1):
- One seeded state dict with transformers' ``DepthProForDepthEstimation``
  keys loads into the port through ``load_predictor`` and goes through the
  JAX package's ``convert_depth_pro``; both predictors see the same frames
  at 64 px. float32: max |d| <= 1e-4 x max |ref|, the field of view too.
  bfloat16: no further from the JAX float32 depth than the JAX bf16 depth
  is, plus 25 %. float32 with the decoder in frame groups (one frame each,
  ``depth_pro.MAX_ELEMENTS`` patched): the same limits.
- transformers' model built as ``tests/test_depth_models.py`` builds it,
  with the same weights: max |d| <= 1e-4 x max |ref| (depth and field of
  view).
- ``load_predictor``: square only; the size is image_size x 2^k, the power
  nearest the requested size.
- The catalog config carries the published widths of ``apple/DepthPro-hf``
  (the JAX catalog's does not: ROADMAP Queue 3, F10).
- ``vd3d-torch render --model depth-pro`` end to end on the CPU (the
  catalog config swapped for the tiny one), and the render's refusal of the
  video and diffusion models, as the JAX CLI refuses them.
- With the K7 opt-in, every layer of the three ViTs goes to K7 where their
  token count is in [512, 4096).
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
torch.set_num_threads(1)

from visiondepth3d_tpu.depth import registry as jregistry
from visiondepth3d_tpu.depth.depth_pro import DEPTH_PRO_TINY as JTINY
from visiondepth3d_tpu.depth.depth_pro import DepthPro as JDepthPro
from visiondepth3d_tpu.depth.depth_pro import convert_depth_pro
from visiondepth3d_tpu.depth.model import DepthPredictor as JPredictor
from test_torch_families import _write_clip
from visiondepth3d_tpu.io import Y4MReader
from visiondepth3d_tpu_torch.cli.main import main as cli_main
from visiondepth3d_tpu_torch.depth import registry as tregistry
from visiondepth3d_tpu_torch.depth.depth_pro import DEPTH_PRO_TINY, DepthPro, DepthProConfig
from visiondepth3d_tpu_torch.kernels import attention as kattention
from visiondepth3d_tpu_torch.ops import attention as tattention

SIZE = 64


def _hf_config():
    from transformers import DepthProConfig as HFConfig
    from transformers.models.dinov2 import Dinov2Config

    tiny = dict(hidden_size=32, num_hidden_layers=4, num_attention_heads=2, image_size=32,
                patch_size=16, layerscale_value=1.0)
    return HFConfig(
        patch_model_config=Dinov2Config(**tiny), image_model_config=Dinov2Config(**tiny),
        fov_model_config=Dinov2Config(**tiny), patch_size=32, scaled_images_ratios=[0.5, 1.0],
        scaled_images_overlap_ratios=[0.0, 0.25], scaled_images_feature_dims=[16, 16],
        intermediate_hook_ids=[1], intermediate_feature_dims=[16], fusion_hidden_size=16,
        merge_padding_value=1, num_fov_head_layers=1, use_fov_model=True)


def hf_state(seed: int = 0) -> dict[str, torch.Tensor]:
    """Seeded random weights on transformers' keys of the tiny model: He
    scaling by the fan-in, norms and layer scales near 1, small biases; the
    depth head's last conv positive (its ReLU would zero the output)."""
    from transformers import DepthProForDepthEstimation

    torch.manual_seed(0)
    shapes = {k: tuple(v.shape)
              for k, v in DepthProForDepthEstimation(_hf_config()).state_dict().items()}
    rng = np.random.default_rng(seed)
    out = {}
    for k, s in sorted(shapes.items()):
        if "lambda1" in k or ("norm" in k and k.endswith("weight")):
            v = 1.0 + 0.1 * rng.standard_normal(s)
        elif len(s) >= 2 and "token" not in k and "position_embeddings" not in k:
            v = rng.standard_normal(s) * np.sqrt(2.0 / np.prod(s[1:]))
            v = np.abs(v) if k.startswith("head.layers.4") else v
        else:
            v = 0.02 * rng.standard_normal(s)
            v = np.abs(v) + 0.1 if k.startswith("head.layers.4") else v
        out[k] = torch.from_numpy(v.astype(np.float32))
    return out


def _frames(seed=0):
    return np.random.default_rng(seed).random((2, 40, 52, 3), dtype=np.float32)


def _jax(state, dtype="float32", size=SIZE):
    params = convert_depth_pro({k: v.numpy() for k, v in state.items()}, JTINY)
    return JPredictor(JTINY, params, size, dtype=dtype, model=JDepthPro(JTINY),
                      mean=jregistry.STANDARD_MEAN, std=jregistry.STANDARD_STD, select=0,
                      snap_multiple=size), params


def _port(state, dtype="float32", size=SIZE):
    return tregistry.load_predictor("depth-pro", dict(state), inference_size=size, dtype=dtype,
                                    device="cpu", config=DEPTH_PRO_TINY)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_depth_pro_matches_jax(dtype):
    state = hf_state(seed=1)
    frames = _frames()
    jpred, params = _jax(state, dtype)
    want = np.asarray(jpred(frames))
    pred = _port(state, dtype)
    got = pred(torch.from_numpy(frames)).numpy()
    # the tiny config's fusion ends at half the input's size (the published
    # one at the input's: 1536 -> 1536)
    assert got.shape == want.shape == (2, SIZE // 2, SIZE // 2) and got.dtype == np.float32
    assert np.isfinite(want).all() and want.std() > 1e-3 * np.abs(want).max()
    if dtype == "float32":
        assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
        # the field of view, from the model itself on the same pixels
        x = np.random.default_rng(2).standard_normal((2, SIZE, SIZE, 3)).astype(np.float32)
        _, jfov = JDepthPro(JTINY).apply({"params": params}, jnp.asarray(x))
        with torch.no_grad():
            _, fov = pred.model(torch.from_numpy(x).permute(0, 3, 1, 2))
        np.testing.assert_allclose(fov.numpy(), np.asarray(jfov),
                                   atol=1e-4 * np.abs(np.asarray(jfov)).max())
    else:
        ref = np.asarray(_jax(state)[0](frames))
        scale = np.abs(ref).max()
        mine, theirs = np.abs(got - ref) / scale, np.abs(want - ref) / scale
        assert mine.max() <= 1.25 * theirs.max(), (mine.max(), theirs.max())


def test_depth_pro_in_frame_groups_matches_jax(monkeypatch):
    """float32, ``MAX_ELEMENTS`` at one frame's largest decoder tensor: each
    forward runs its decoder in groups of one frame, and the depth and the
    field of view hold to the JAX package's at the ungrouped limits."""
    from visiondepth3d_tpu_torch.depth import depth_pro as tdp

    state = hf_state(seed=1)
    frames = _frames()
    jpred, params = _jax(state)
    want = np.asarray(jpred(frames))
    pred = _port(state)
    # the tiny config's last fusion level is a quarter of the input's side
    monkeypatch.setattr(tdp, "MAX_ELEMENTS", pred.model._decoder_elements(SIZE // 4, SIZE // 4))
    groups = []
    decode = tdp.DepthPro._decode

    def spy(self, features):
        groups.append(features[0].shape[0])
        return decode(self, features)

    monkeypatch.setattr(tdp.DepthPro, "_decode", spy)
    got = pred(torch.from_numpy(frames)).numpy()
    assert groups == [1, 1]
    assert got.shape == want.shape == (2, SIZE // 2, SIZE // 2)
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
    x = np.random.default_rng(2).standard_normal((2, SIZE, SIZE, 3)).astype(np.float32)
    _, jfov = JDepthPro(JTINY).apply({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        _, fov = pred.model(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert groups == [1, 1, 1, 1]
    np.testing.assert_allclose(fov.numpy(), np.asarray(jfov),
                               atol=1e-4 * np.abs(np.asarray(jfov)).max())


def test_depth_pro_matches_transformers():
    from transformers import DepthProForDepthEstimation

    state = hf_state(seed=3)
    hf = DepthProForDepthEstimation(_hf_config()).eval()
    hf.load_state_dict(state)
    model = _port(state).model
    x = torch.from_numpy(np.random.default_rng(4).random((2, 3, SIZE, SIZE), dtype=np.float32))
    with torch.no_grad():
        out = hf(x)
        depth, fov = model(x)
    want = out.predicted_depth
    assert depth.shape == want.shape == (2, SIZE // 2, SIZE // 2)
    assert (depth - want).abs().max().item() <= 1e-4 * want.abs().max().item()
    assert (fov - out.field_of_view).abs().max().item() <= \
        1e-4 * out.field_of_view.abs().max().item()


def test_load_predictor_square_and_power_of_two_size():
    """image_size x 2^k with k the nearest power, as the JAX registry picks
    it, but never so small that the smallest scale holds no window (F13:
    the tiny config's 0.5 scale needs 64 for its 32 px window; the
    published one's 0.25 scale 1536 for 384); rectangles refused."""
    base = DEPTH_PRO_TINY.image_model.image_size
    for asked, want in ((20, 64), (40, 64), (64, 64), (100, 128), (200, 256), ((64, 64), 64)):
        pred = tregistry.load_predictor("depth-pro", None, inference_size=asked, device="cpu",
                                        config=DEPTH_PRO_TINY)
        assert pred._size == (want, want) and want % base == 0, asked
        assert pred.select == 0 and pred.inference_size == want
    with pytest.raises(ValueError, match="square"):
        tregistry.load_predictor("depth-pro", None, inference_size=(64, 96), device="cpu",
                                 config=DEPTH_PRO_TINY)
    # the published config: 518 (the CLI's default) and 768 (a JAX catalog size) -> 1536
    for asked, want in ((518, 1536), (768, 1536), (1536, 1536), (3000, 3072)):
        assert tregistry.depth_pro_size(DepthProConfig(), asked) == want, asked


def test_catalog_config_has_the_published_widths():
    cfg = tregistry.CATALOG["depth-pro"].config
    assert tregistry.CATALOG["depth-pro"].hf_id == "apple/DepthPro-hf"
    for vit in (cfg.patch_model, cfg.image_model, cfg.fov_model):
        assert (vit.hidden_size, vit.num_layers, vit.num_heads, vit.patch_size,
                vit.image_size) == (1024, 24, 16, 16, 384)
    assert (cfg.patch_size, cfg.scaled_images_ratios, cfg.scaled_images_overlap_ratios,
            cfg.scaled_images_feature_dims, cfg.intermediate_hook_ids,
            cfg.intermediate_feature_dims, cfg.fusion_hidden_size, cfg.merge_padding_value,
            cfg.num_fov_head_layers) == (384, (0.25, 0.5, 1.0), (0.0, 0.5, 0.25),
                                         (1024, 1024, 512), (11, 5), (256, 256), 256, 3, 2)
    # the rest as the JAX config: only the encoders differ (F10)
    jcfg = jregistry.CATALOG["depth-pro"].config
    strip = dict(patch_model=None, image_model=None, fov_model=None)
    assert dataclasses.asdict(dataclasses.replace(cfg, **strip)) == \
        dataclasses.asdict(dataclasses.replace(jcfg, **strip))
    assert jcfg.image_model.patch_size == 14  # the JAX catalog's ViT-S/14
    with torch.device("meta"):  # shapes only
        model = DepthPro(DepthProConfig())
    assert sum(p.numel() for p in model.parameters()) > 9e8


def test_cli_render_depth_pro(tmp_path, monkeypatch):
    entry = tregistry.CATALOG["depth-pro"]
    monkeypatch.setitem(tregistry.CATALOG, "depth-pro",
                        dataclasses.replace(entry, config=DEPTH_PRO_TINY))
    clip, out = tmp_path / "clip.y4m", tmp_path / "sbs.y4m"
    _write_clip(clip)
    assert cli_main(["render", "--input", str(clip), "--model", "depth-pro", "--allow-random",
                     "--device", "cpu", "--output", str(out), "--preserve-aspect",
                     "--chunk-size", "4", "--inference-size", "64"]) == 0
    with Y4MReader(str(out)) as rd:
        frames = np.stack(list(rd))
    assert frames.shape == (4, 48, 128, 3)
    assert np.abs(frames[:, :, :64].astype(int) - frames[:, :, 64:].astype(int)).mean() > 0


@pytest.mark.parametrize("name", ["video-depth-anything", "marigold"])
def test_cli_render_refuses_video_and_diffusion_models(name, tmp_path, capsys):
    clip = tmp_path / "clip.y4m"
    _write_clip(clip, n=1)
    assert cli_main(["render", "--input", str(clip), "--model", name, "--allow-random",
                     "--device", "cpu", "--output", str(tmp_path / "x.y4m")]) == 2
    assert "fused single-pass route needs a feed-forward" in capsys.readouterr().err
    assert not (tmp_path / "x.y4m").exists()


def test_k7_route_in_all_three_vits(monkeypatch):
    """ViTs of 24 x 24 patches (577 tokens) send every layer to K7 (its
    plain version on the CPU, spied): the patch encoder's windows as one
    batch, the image encoder and the field-of-view encoder; the depth
    equals the SDPA route's."""
    vit = dataclasses.replace(DEPTH_PRO_TINY.patch_model, num_layers=2,
                              patch_size=2, image_size=48)
    cfg = dataclasses.replace(DEPTH_PRO_TINY, patch_model=vit, image_model=vit, fov_model=vit,
                              patch_size=48)
    pred = tregistry.load_predictor("depth-pro", None, inference_size=96, device="cpu",
                                    config=cfg)
    frames = torch.from_numpy(_frames(5)[:1])
    want = pred(frames)
    calls = []
    plain = kattention.vmem_attention
    monkeypatch.setattr(kattention, "vmem_attention",
                        lambda q, k, v: calls.append(tuple(q.shape)) or plain(q, k, v))
    monkeypatch.setattr(tattention, "USE_VMEM_KERNEL", True)
    got = pred(frames)
    # 96 px: one window at ratio 0.5, 2 x 2 at ratio 1 (overlap 0.25 -> stride 36)
    assert calls == [(5, 577, 2, 16)] * 2 + [(1, 577, 2, 16)] * 4
    torch.testing.assert_close(got, want, atol=1e-5 * want.abs().max().item(), rtol=0)
