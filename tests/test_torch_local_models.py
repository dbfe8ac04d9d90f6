"""The port's model folders, ``vd3d-torch convert`` and
``vd3d-torch verify-checkpoints`` against the JAX package.

- A ``local:`` folder written by either package loads in the other and
  gives the same depth, for ``dpt_dinov2`` (DA_TINY), ``depth_pro`` (a
  tree with ViT-S/14 encoders, the widths of the JAX catalog's Depth Pro,
  two blocks deep over 28 px windows), ``vda`` (VDA_TINY) and ``midas-v2``
  (MIDAS_V2_TINY). One seeded state dict on the upstream keys goes through
  the JAX family's converter; the JAX predictor on that tree is the
  reference. The JAX-written folder (the JAX ``save_local_params``) loads
  in the port: max |d| <= 1e-4 x max |ref|, float32, the families' bound.
  The port-written folder (``to_jax_params`` + ``save_local_params``, or
  ``vd3d-torch convert``) holds the JAX tree bit for bit on every leaf it
  writes, and the JAX ``load_predictor("local:...")`` runs it to the same
  bound.
- Every family's map runs both ways: ``to_jax_params`` after
  ``from_jax_params*`` gives the JAX leaves back bit for bit, and the other
  way round the port's tensors.
- ``discover_local_models``: the same keys and entries as the JAX one.
- ``convert``: the JAX CLI's rc-2 refusals with its messages, and the
  ``.vd16`` round trip without ffmpeg (as ``tests/test_depth16_formats.py``).
- ``verify_checkpoints``: the JAX walk's report schema and statuses on a
  folder the test writes (a tiny BSRGAN x2 ONNX that passes, a corrupt
  RIFE file that fails, the rest missing).
- On a card (``cuda`` marker): ``convert`` then a ``local:`` render is
  bit-identical to the ``--checkpoint`` render.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest
import torch
torch.set_num_threads(1)

from visiondepth3d_tpu.depth import registry as jregistry
from visiondepth3d_tpu.depth import vda as jvda
from visiondepth3d_tpu.depth.configs import DA_TINY as JDA_TINY
from visiondepth3d_tpu.depth.configs import ViTConfig as JViT
from visiondepth3d_tpu.depth.convert import convert_depth_anything
from visiondepth3d_tpu.depth.depth_pro import DepthProConfig as JDepthProConfig
from visiondepth3d_tpu.depth.depth_pro import convert_depth_pro
from visiondepth3d_tpu.depth.midas_v2 import MIDAS_V2_TINY as JMIDAS_TINY
from visiondepth3d_tpu.depth.midas_v2 import convert_midas_small
from visiondepth3d_tpu.io.depth_io import Depth16Writer
from test_torch_families import FAMILIES, JAX_TINY, hf_state, isl_org_state
from test_torch_vda import port_state as vda_port_state
from test_torch_vda import upstream_state as vda_upstream_state
from visiondepth3d_tpu_torch.cli.main import main as cli_main
from visiondepth3d_tpu_torch.depth import configs as tconfigs
from visiondepth3d_tpu_torch.depth import convert as tconvert
from visiondepth3d_tpu_torch.depth import registry as tregistry
from visiondepth3d_tpu_torch.depth.configs import ViTConfig
from visiondepth3d_tpu_torch.depth.depth_pro import DEPTH_PRO_TINY, DepthPro, DepthProConfig
from visiondepth3d_tpu_torch.depth.midas_v2 import MIDAS_V2_TINY
from visiondepth3d_tpu_torch.depth.vda import VDA_TINY
from visiondepth3d_tpu_torch.io.depth_io import Depth16Reader

# Depth Pro with the JAX catalog's ViT-S/14 encoder widths (F10), cut to two
# blocks and 28 px windows: a 56 px input, windows at ratios 0.5 and 1
_VIT_S14 = dict(hidden_size=384, num_layers=2, num_heads=6, patch_size=14, image_size=28)
_DP_REST = dict(patch_size=28, scaled_images_ratios=(0.5, 1.0),
                scaled_images_overlap_ratios=(0.0, 0.25), scaled_images_feature_dims=(16, 16),
                intermediate_hook_ids=(1,), intermediate_feature_dims=(16,),
                fusion_hidden_size=16, merge_padding_value=1, num_fov_head_layers=1)
DP_S14 = DepthProConfig(patch_model=ViTConfig(**_VIT_S14), image_model=ViTConfig(**_VIT_S14),
                        fov_model=ViTConfig(**_VIT_S14), **_DP_REST)
JDP_S14 = JDepthProConfig(patch_model=JViT(**_VIT_S14), image_model=JViT(**_VIT_S14),
                          fov_model=JViT(**_VIT_S14), **_DP_REST)


def _he(key: str, shape: tuple, rng, last: str) -> np.ndarray:
    """He-scaled weights, norms near 1, small biases; the last head conv
    positive (its ReLU would zero the depth)."""
    if "lambda1" in key or ("norm" in key and key.endswith("weight")):
        return 1.0 + 0.1 * rng.standard_normal(shape)
    if len(shape) >= 2 and "token" not in key and "position_embeddings" not in key:
        w = rng.standard_normal(shape) * np.sqrt(2.0 / np.prod(shape[1:]))
        return np.abs(w) if key.startswith(last) else w
    v = 0.02 * rng.standard_normal(shape)
    return np.abs(v) + 0.1 if key.startswith(last) else v


def _depth_pro_state(seed: int = 0) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    return {k: _he(k, tuple(v.shape), rng, "head.layers.4").astype(np.float32)
            for k, v in sorted(DepthPro(DP_S14).state_dict().items())}


# family -> (catalog name, port config, JAX config, input frames' shape, size)
CASES = {
    "dpt_dinov2": ("depth-anything-v2-small", tconfigs.DA_TINY, JDA_TINY, (2, 40, 52, 3), 56),
    "depth_pro": ("depth-pro", DP_S14, JDP_S14, (1, 40, 52, 3), 56),
    "vda": ("video-depth-anything", VDA_TINY, jvda.VDA_TINY, (3, 56, 56, 3), 56),
    "dpt_vit": ("midas-v2", MIDAS_V2_TINY, JMIDAS_TINY, (2, 40, 52, 3), 64),
}


def _upstream(family: str) -> tuple[dict, dict]:
    """(the JAX tree of one seeded upstream state dict, that state dict,
    with the upstream keys the port's model does not hold)."""
    if family == "dpt_dinov2":
        state = {k: v.numpy() for k, v in tregistry.load_predictor(
            "depth-anything-v2-small", None, inference_size=56, config=tconfigs.DA_TINY,
            device="cpu", seed=7).model.state_dict().items()}
        hf = dict(state)
        for conv in ("convolution1", "convolution2"):  # HF's unused residual unit
            pre = f"neck.fusion_stage.layers.0.residual_layer1.{conv}"
            hf[f"{pre}.weight"] = state[pre.replace("layer1", "layer2") + ".weight"]
            hf[f"{pre}.bias"] = state[pre.replace("layer1", "layer2") + ".bias"]
        return convert_depth_anything(hf, JDA_TINY), hf
    if family == "depth_pro":
        state = _depth_pro_state(1)
        return convert_depth_pro(state, JDP_S14), state
    if family == "vda":
        up = vda_upstream_state(vda_port_state(2))
        return jvda.convert_vda(up, jvda.VDA_TINY), up
    up = {k: v.numpy() for k, v in isl_org_state(MIDAS_V2_TINY, seed=3).items()}
    return convert_midas_small(up, JMIDAS_TINY), up


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from _leaves(v, key)
        else:
            yield key, np.asarray(v)


@pytest.mark.parametrize("family", sorted(CASES))
def test_local_folders_load_across_packages(family, tmp_path):
    name, tcfg, jcfg, shape, size = CASES[family]
    jtree, upstream = _upstream(family)
    frames = np.random.default_rng(4).random(shape, dtype=np.float32)
    jpred = jregistry.load_predictor(name, jtree, inference_size=size, config=jcfg)
    want = np.asarray(jpred(frames))
    assert np.isfinite(want).all() and want.std() > 1e-3 * np.abs(want).max()

    # a folder the JAX package wrote, loaded by the port
    jdir = tmp_path / "jax"
    jregistry.save_local_params(str(jdir), name, jax_to_host(jtree))
    load_cfg = tcfg
    if family == "depth_pro":  # the encoders must come from the tree's shapes
        load_cfg = dataclasses.replace(DEPTH_PRO_TINY, **_DP_REST)
    tpred = tregistry.load_predictor(f"local:{jdir}", inference_size=size, config=load_cfg,
                                     device="cpu")
    if family == "depth_pro":
        enc = tpred.model.cfg.patch_model
        assert (enc.hidden_size, enc.num_layers, enc.num_heads, enc.patch_size,
                enc.image_size) == (384, 2, 6, 14, 28)
    got = tpred(torch.from_numpy(frames)).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()

    # a folder the port wrote from the same weights, loaded by the JAX package
    pdir = tmp_path / "port"
    tregistry.save_local_params(
        str(pdir), name, tconvert.to_jax_params(family, tpred.model.state_dict(), tcfg))
    meta = json.loads((pdir / "vd3d.json").read_text())
    assert meta == {"base": name, "format": "native"}
    mine = dict(_leaves(jregistry.load_local_params(str(pdir))))
    ref = dict(_leaves(jtree))
    assert mine and set(mine) <= set(ref)
    for k, v in mine.items():
        np.testing.assert_array_equal(v, ref[k], err_msg=k)
    jlocal = jregistry.load_predictor(f"local:{pdir}", inference_size=size, config=jcfg)
    back = np.asarray(jlocal(frames))
    assert np.abs(back - want).max() <= 1e-4 * np.abs(want).max()


def jax_to_host(tree):
    """A params tree with contiguous numpy leaves, as the JAX CLI hands them to
    ``save_local_params`` (the safetensors writer takes a transposed view's
    buffer as it lies in memory)."""
    return {k: jax_to_host(v) if isinstance(v, dict) else np.ascontiguousarray(v)
            for k, v in tree.items()}


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_maps_run_both_ways(name):
    """The six families of ``test_torch_families``: JAX leaves -> the
    port's tensors -> the JAX leaves again, bit for bit."""
    family, tcfg = FAMILIES[name][0], FAMILIES[name][1]
    jconvert = FAMILIES[name][4]
    state = isl_org_state(tcfg) if family == "dpt_vit" else hf_state(name)
    jtree = jconvert({k: v.numpy() for k, v in state.items()}, JAX_TINY[name])
    port = tconvert.from_jax_tree(family, jtree, tcfg)
    back = dict(_leaves(tconvert.to_jax_params(family, port, tcfg)))
    ref = dict(_leaves(jtree))
    assert back and set(back) <= set(ref)
    for k, v in back.items():
        np.testing.assert_array_equal(v, ref[k], err_msg=k)
    again = tconvert.from_jax_tree(family, tconvert.to_jax_params(family, port, tcfg), tcfg)
    assert set(again) == set(port)
    for k, v in port.items():
        torch.testing.assert_close(again[k], v, atol=0, rtol=0)


def test_depth_pro_config_from_the_jax_catalog_tree():
    """The encoders of the JAX catalog's Depth Pro (ViT-S/14, 12 blocks; the
    JAX ``Dinov2Trunk``'s own tree, shapes only: that model cannot run, F10)
    give the port a config with those encoders and the rest of the
    catalog's."""
    import jax

    from visiondepth3d_tpu.depth.depth_pro import Dinov2Trunk

    vit = jregistry.CATALOG["depth-pro"].config.patch_model
    shapes = jax.eval_shape(Dinov2Trunk(vit).init, jax.random.PRNGKey(0),
                            jax.ShapeDtypeStruct((1, 378, 378, 3), np.float32))["params"]
    trunk = jax.tree.map(lambda a: np.broadcast_to(np.float32(0), a.shape), shapes)
    tree = {"patch_encoder": trunk, "image_encoder": trunk, "fov_encoder": trunk}
    cfg = tconvert.depth_pro_config_from_jax(tree, DepthProConfig())
    for enc in (cfg.patch_model, cfg.image_model, cfg.fov_model):
        assert (enc.hidden_size, enc.num_layers, enc.num_heads, enc.patch_size,
                enc.image_size) == (384, 12, 6, 14, 384)
    assert cfg.fusion_hidden_size == DepthProConfig().fusion_hidden_size
    assert tregistry.depth_pro_size(cfg, 384) == 1536  # F13: the smallest valid size


def test_discover_local_models_matches_jax(tmp_path):
    jtree, _ = _upstream("dpt_dinov2")
    jregistry.save_local_params(str(tmp_path / "from_jax"), "depth-anything-v2-small",
                                jax_to_host(jtree))
    tregistry.save_local_params(str(tmp_path / "from_port"), "midas-v2",
                                {"stem": {"kernel": np.zeros((3, 3, 3, 4), np.float32)}})
    (tmp_path / "no_meta").mkdir()
    (tmp_path / "unknown_base").mkdir()
    (tmp_path / "unknown_base" / "vd3d.json").write_text(json.dumps({"base": "nope"}))
    (tmp_path / "a_file.txt").write_text("x")
    mine = tregistry.discover_local_models(str(tmp_path))
    theirs = jregistry.discover_local_models(str(tmp_path))
    assert sorted(mine) == sorted(theirs) == ["[Local] from_jax", "[Local] from_port"]
    for key, entry in mine.items():
        assert entry.name == theirs[key].name and entry.family == theirs[key].family
    assert tregistry.discover_local_models(str(tmp_path / "missing")) == {}


def test_cli_convert_writes_a_folder_the_jax_package_loads(tmp_path, monkeypatch, capsys):
    """``vd3d-torch convert`` of an HF checkpoint (the catalog entry's
    config swapped for the tiny one) -> a native folder; the port's
    ``local:`` model equals its ``--checkpoint`` model bit for bit, and the
    JAX package reads the folder as its converter's tree of the file."""
    entry = tregistry.CATALOG["depth-anything-v2-small"]
    monkeypatch.setitem(tregistry.CATALOG, "depth-anything-v2-small",
                        dataclasses.replace(entry, config=tconfigs.DA_TINY))
    _, state = _upstream("dpt_dinov2")
    ckpt, out = tmp_path / "model.safetensors", tmp_path / "da_local"
    tconvert.save_safetensors(ckpt, state)
    assert cli_main(["convert", "--model", "depth-anything-v2-small", "--checkpoint", str(ckpt),
                     "--output", str(out), "--inference-size", "56", "--device", "cpu"]) == 0
    assert f"local:{out}" in capsys.readouterr().out
    a = tregistry.load_predictor(f"local:{out}", inference_size=56, device="cpu").model
    b = tregistry.load_predictor("depth-anything-v2-small", str(ckpt), inference_size=56,
                                 device="cpu").model
    sa, sb = a.state_dict(), b.state_dict()
    assert set(sa) == set(sb)
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    jtree, _ = _upstream("dpt_dinov2")
    ref = dict(_leaves(jtree))
    for k, v in _leaves(jregistry.load_local_params(str(out))):
        np.testing.assert_array_equal(v, ref[k], err_msg=k)


@pytest.mark.parametrize("argv", [
    ["convert"],
    ["convert", "--model", "depth-anything-v2-small"],
    ["convert", "--depth-in", "x.vd16"],
    ["convert", "--depth-out", "y.vd16"],
])
def test_convert_refusals_match_jax(argv, capsys):
    # imported here: the JAX CLI does not import where the card runner mocks jax
    from visiondepth3d_tpu.cli.main import main as jmain

    assert jmain(argv) == 2
    want = capsys.readouterr().out
    assert cli_main(argv) == 2
    assert capsys.readouterr().out == want


@pytest.mark.parametrize("model", ["marigold", "depthcrafter", "onnx:model.onnx"])
def test_convert_refuses_families_without_one_tree(model, tmp_path, capsys):
    assert cli_main(["convert", "--model", model, "--checkpoint", str(tmp_path),
                     "--output", str(tmp_path / "o"), "--device", "cpu"]) == 2
    assert "does not expose a single params tree" in capsys.readouterr().out


def test_convert_depth_stream_vd16_round_trip(tmp_path, capsys):
    frames = [((np.arange(24 * 32).reshape(24, 32) * 37 + i * 1000) % 65536).astype(np.uint16)
              for i in range(4)]
    src, dst = tmp_path / "in.vd16", tmp_path / "out.vd16"
    with Depth16Writer(src, 32, 24, 12.0) as wr:
        for f in frames:
            wr.write(f)
    assert cli_main(["convert", "--depth-in", str(src), "--depth-out", str(dst)]) == 0
    assert "4" in capsys.readouterr().out
    with Depth16Reader(dst) as rd:
        assert (rd.width, rd.height, rd.fps) == (32, 24, 12.0)
        got = list(rd)
    assert len(got) == 4
    for a, b in zip(got, frames):
        np.testing.assert_array_equal(a, b)
    assert dst.read_bytes() == src.read_bytes()
    (tmp_path / "x.txt").write_text("not depth")
    assert cli_main(["convert", "--depth-in", str(tmp_path / "x.txt"),
                     "--depth-out", str(dst)]) == 2


def test_verify_checkpoints_matches_jax(tmp_path, capsys):
    """One passing artifact (a tiny BSRGAN x2 ONNX export, geometry inferred),
    one corrupt file (reported as ``fail``, the walk goes on), the rest
    missing: the JAX walk's report, entry by entry."""
    import torch.nn as tnn
    import torch.nn.functional as tF

    from test_enhance import _bsrgan_net
    from visiondepth3d_tpu.utils.onnx_reader import write_onnx_initializers
    from visiondepth3d_tpu.utils.verify_checkpoints import verify_checkpoints as jverify
    from visiondepth3d_tpu_torch.utils.verify_checkpoints import verify_checkpoints

    net = _bsrgan_net(torch, tnn, tF, nf=8, gc=4, nb=1, sf=2).eval()
    state = {}
    for k, v in net.state_dict().items():
        k = k.replace(".rdb1.", ".RDB1.").replace(".rdb2.", ".RDB2.").replace(".rdb3.", ".RDB3.")
        if not k.startswith("upconv2."):
            state[k] = v.numpy().astype(np.float16)
    write_onnx_initializers(tmp_path / "BSRGANx2_fp16.onnx", state)
    (tmp_path / "rife.onnx").write_bytes(b"not a real onnx file")

    want = jverify(str(tmp_path), progress=lambda *_: None)
    got = verify_checkpoints(str(tmp_path), progress=lambda *_: None, device="cpu")
    assert set(got) == set(want) == {"dir", "passed", "failed", "missing", "results"}
    assert (got["passed"], got["failed"], got["missing"]) == \
        (want["passed"], want["failed"], want["missing"]) == (1, 1, len(want["results"]) - 2)
    assert set(got["results"]) == set(want["results"])
    for name, res in want["results"].items():
        assert got["results"][name]["status"] == res["status"], name
        assert got["results"][name]["file"] == res["file"], name
    assert got["results"]["esrgan:BSRGANx2"]["cfg"] == \
        "ESRGANConfig(nf=8, nb=1, gc=4, scale=2, n_up=1, unshuffle=False)"
    assert "error" in got["results"]["rife"]
    assert not (tmp_path / "vd3d_verify.json").exists()

    assert cli_main(["verify-checkpoints", str(tmp_path), "--device", "cpu"]) == 1
    out = capsys.readouterr().out
    assert json.loads(out.splitlines()[-2])["failed"] == 1
    saved = json.loads((tmp_path / "vd3d_verify.json").read_text())
    assert saved["results"]["esrgan:BSRGANx2"]["status"] == "pass"


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_local_render_matches_checkpoint_render(cuda, tmp_path, monkeypatch):
    """On the card (K1-K4): ``convert`` then ``render --model local:`` gives
    the ``--checkpoint`` render's bytes."""
    from test_torch_depth_route import _write_clip

    entry = tregistry.CATALOG["depth-anything-v2-small"]
    monkeypatch.setitem(tregistry.CATALOG, "depth-anything-v2-small",
                        dataclasses.replace(entry, config=tconfigs.DA_TINY))
    _, state = _upstream("dpt_dinov2")
    ckpt, folder, clip = tmp_path / "m.safetensors", tmp_path / "local", tmp_path / "c.y4m"
    tconvert.save_safetensors(ckpt, state)
    _write_clip(clip, 48, 64, 4)
    assert cli_main(["convert", "--model", "depth-anything-v2-small", "--checkpoint", str(ckpt),
                     "--output", str(folder)]) == 0
    outs = []
    for i, model in enumerate((["--model", f"local:{folder}"],
                               ["--model", "depth-anything-v2-small", "--checkpoint", str(ckpt)])):
        out = tmp_path / f"o{i}.y4m"
        assert cli_main(["render", "--input", str(clip), *model, "--inference-size", "56",
                         "--preserve-aspect", "--output", str(out)]) == 0
        outs.append(out.read_bytes())
    assert outs[0] == outs[1]
