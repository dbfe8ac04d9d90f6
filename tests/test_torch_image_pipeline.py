"""The port's image-folder depth and image files against the JAX package.

- ``process_images_in_folder``: the same tiny Depth Anything weights
  (DA_TINY, from ``from_jax_params``) in both packages over one folder of
  mixed-size PNGs (padded per batch to the largest, as JAX pads), named so
  that only a natural sort orders them; 8 bits, 16 bits inverted, and a
  batch of one. Same files in the same order; float32 depth, so the images
  agree within 1 step of 255 (8 bits) or 2e-3 of 65535 (16 bits):
  summation order moves a few values across a rounding boundary.
- ``process_image`` and ``natural_sort_key`` as the JAX ones.
- ``load_image01`` reads PNGs that Pillow saved (its adaptive row filters)
  in every mode the JAX one reads as the same array, and
  ``save_depth_image`` writes the JAX one's bytes at 8 and 16 bits.
- Without Pillow, reading and writing refuse with an ImportError naming
  Pillow; a colormap without matplotlib one naming matplotlib.
- On a card (``cuda`` marker): the folder loop with the K7 opt-in gives
  the CPU's images.
"""

from __future__ import annotations

import sys

import numpy as np
import pytest
import torch
torch.set_num_threads(1)
from PIL import Image

from visiondepth3d_tpu.depth.configs import DA_TINY
from visiondepth3d_tpu.depth.model import DepthPredictor as JPredictor
from visiondepth3d_tpu.depth.model import init_random
from visiondepth3d_tpu.pipeline import image_pipeline as jpipe
from visiondepth3d_tpu_torch.depth import configs as tconfigs
from visiondepth3d_tpu_torch.depth.convert import from_jax_params, load_hf_state_dict
from visiondepth3d_tpu_torch.depth.dpt import DepthAnything
from visiondepth3d_tpu_torch.depth.model import DepthPredictor
from visiondepth3d_tpu_torch.pipeline import image_pipeline as pipe

SIZE = 56


def read_png(path) -> np.ndarray:
    return np.asarray(Image.open(path))


@pytest.fixture(scope="module")
def params():
    return init_random(DA_TINY, seed=5, size=SIZE)


@pytest.fixture(scope="module")
def jpred(params):
    """One JAX predictor for the module's cases (its compiled shapes shared)."""
    return JPredictor(DA_TINY, params, SIZE)


def _port(params, device="cpu"):
    model = DepthAnything(tconfigs.DA_TINY)
    load_hf_state_dict(model, from_jax_params(params, tconfigs.DA_TINY))
    return DepthPredictor(model, SIZE, device=device)


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    """Five RGB PNGs of three sizes, named frame_1 ... frame_10."""
    d = tmp_path_factory.mktemp("imgs")
    rng = np.random.default_rng(0)
    for i, (h, w) in zip((1, 2, 9, 10, 3), ((30, 40), (36, 44), (30, 40), (24, 52), (36, 44))):
        yy, xx = np.mgrid[0:h, 0:w]
        img = np.stack([(xx * 6 + i * 20) % 256, (yy * 7) % 256,
                        rng.integers(0, 256, (h, w))], -1).astype(np.uint8)
        Image.fromarray(img).save(d / f"frame_{i}.png")
    (d / "notes.txt").write_text("not an image")
    return d


@pytest.mark.parametrize("bits,invert,batch", [(8, False, 2), (16, True, 3), (8, True, 1)])
def test_folder_matches_jax(params, jpred, folder, tmp_path, bits, invert, batch):
    jout, tout = tmp_path / "jax", tmp_path / "port"
    seen = []
    n_j = jpipe.process_images_in_folder(folder, jout, jpred, batch_size=batch, bits=bits,
                                         invert=invert)
    n_t = pipe.process_images_in_folder(folder, tout, _port(params), batch_size=batch,
                                        bits=bits, invert=invert,
                                        progress_cb=lambda m: seen.append(m.done))
    assert n_t == n_j == 5 and seen[-1] == 5
    names = sorted(p.name for p in jout.iterdir())
    assert names == sorted(p.name for p in tout.iterdir())
    for name in names:
        want = np.asarray(Image.open(jout / name))
        got = read_png(tout / name)
        assert got.shape == want.shape and got.dtype == want.dtype == \
            (np.uint16 if bits == 16 else np.uint8)
        tol = 1 if bits == 8 else 0.002 * 65535
        assert np.abs(got.astype(np.int64) - want).max() <= tol, name


def test_natural_sort_and_process_image(params, jpred, folder, tmp_path):
    names = ["frame_10.png", "frame_9.png", "Frame_1.png", "frame_2.png"]
    assert sorted(names, key=pipe.natural_sort_key) == sorted(names, key=jpipe.natural_sort_key)
    assert sorted(names, key=pipe.natural_sort_key)[:2] == ["Frame_1.png", "frame_2.png"]
    src = folder / "frame_2.png"
    jpipe.process_image(src, tmp_path / "j.png", jpred, bits=16)
    pipe.process_image(src, tmp_path / "t.png", _port(params), bits=16)
    want, got = np.asarray(Image.open(tmp_path / "j.png")), read_png(tmp_path / "t.png")
    assert got.shape == want.shape == (36, 44)
    assert np.abs(got.astype(np.int64) - want).max() <= 0.002 * 65535
    np.testing.assert_array_equal(pipe.load_image01(src), jpipe.load_image01(src))


def test_cancel_stops_the_folder_loop(params, folder, tmp_path):
    assert pipe.process_images_in_folder(folder, tmp_path, _port(params), batch_size=2,
                                         cancel_check=lambda: True) == 0


def _smooth(h=20, w=24) -> np.ndarray:
    """A gradient image: Pillow's adaptive filter choice gives its rows the
    Sub and Paeth filters."""
    yy, xx = np.mgrid[0:h, 0:w]
    return np.stack([(xx * 9) % 256, (yy * 11) % 256, (xx * yy) % 256], -1).astype(np.uint8)


@pytest.mark.parametrize("mode", ["RGB", "RGBA", "P", "LA", "L", "I;16"])
def test_load_image_matches_jax(tmp_path, mode):
    img = Image.fromarray(_smooth())
    if mode == "I;16":
        g = np.asarray(img.convert("L")).astype(np.uint16) * 257
        img = Image.frombytes("I;16", g.shape[::-1], g.astype("<u2").tobytes())
    else:
        img = img.convert(mode)
    img.save(tmp_path / "x.png")
    got = pipe.load_image01(tmp_path / "x.png")
    assert got.shape == (20, 24, 3) and got.dtype == np.float32
    np.testing.assert_array_equal(got, jpipe.load_image01(tmp_path / "x.png"))


@pytest.mark.parametrize("bits,invert", [(8, False), (16, False), (16, True)])
def test_save_depth_image_matches_jax(tmp_path, bits, invert):
    d = np.random.default_rng(bits).random((17, 23), dtype=np.float32)
    jpipe.save_depth_image(d, tmp_path / "j.png", bits=bits, invert=invert)
    pipe.save_depth_image(d, tmp_path / "t.png", bits=bits, invert=invert)
    got = read_png(tmp_path / "t.png")
    assert got.dtype == (np.uint16 if bits == 16 else np.uint8)
    np.testing.assert_array_equal(got, read_png(tmp_path / "j.png"))


def test_other_formats_refuse_without_pillow(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    d = np.linspace(0, 1, 12, dtype=np.float32).reshape(3, 4)
    for name, bits in (("d.jpg", 8), ("d.png", 8), ("d.png", 16)):
        with pytest.raises(ImportError, match="Pillow"):
            pipe.save_depth_image(d, tmp_path / name, bits=bits)
    with pytest.raises(ImportError, match="matplotlib"):
        pipe.save_depth_image(d, tmp_path / "d.png", colormap="inferno")
    (tmp_path / "x.png").write_bytes(b"\x89PNG")
    with pytest.raises(ImportError, match="Pillow"):
        pipe.load_image01(tmp_path / "x.png")
    assert not (tmp_path / "d.png").exists()


def test_colormap_matches_jax(tmp_path):
    d = np.linspace(0, 1, 20, dtype=np.float32).reshape(4, 5)
    jpipe.save_depth_image(d, tmp_path / "j.png", colormap="inferno")
    pipe.save_depth_image(d, tmp_path / "t.png", colormap="inferno")
    np.testing.assert_array_equal(read_png(tmp_path / "t.png"),
                                  np.asarray(Image.open(tmp_path / "j.png")))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_folder_with_k7_matches_cpu(cuda, folder, tmp_path, monkeypatch):
    """DA_TINY (the port's seeded random weights: the card runner mocks jax)
    at 322 px (N = 530 tokens) sends every layer to K7 on the card; the
    images are the CPU's within 1 step (float32, TF32 off)."""
    from visiondepth3d_tpu_torch.depth.registry import load_predictor
    from visiondepth3d_tpu_torch.kernels import _lib
    from visiondepth3d_tpu_torch.ops import attention

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(attention, "USE_VMEM_KERNEL", True)

    def big(device):
        return load_predictor("depth-anything-v2-small", None, inference_size=322, seed=5,
                              config=tconfigs.DA_TINY, device=device)

    pipe.process_images_in_folder(folder, tmp_path / "cpu", big("cpu"), batch_size=5)
    _lib.reset_launch_counts()
    pipe.process_images_in_folder(folder, tmp_path / "gpu", big(cuda), batch_size=5)
    assert _lib.launch_counts["vmem_attention"] == tconfigs.DA_TINY.backbone.num_layers
    for p in sorted((tmp_path / "cpu").iterdir()):
        diff = read_png(p).astype(int) - read_png(tmp_path / "gpu" / p.name)
        assert np.abs(diff).max() <= 1, p.name
