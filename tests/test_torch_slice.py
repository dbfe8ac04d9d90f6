"""The port's fused render route end to end, against the JAX one.

A 6-frame 64x48 y4m clip goes through both ``render_stereo_video``s (the
fused route with the same DA_TINY weights, and the depth-video route),
Full-SBS at the source size, chunks of 4 (so the trackers cross a chunk
boundary). float32 outputs: mean |d| <= 0.1 and
max |d| <= 3 u8 steps (summation-order differences move a few pixels
across a rounding or a bisection boundary).
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
torch.set_num_threads(1)

from visiondepth3d_tpu.depth.configs import DA_TINY
from visiondepth3d_tpu.depth.model import DepthPredictor as JPredictor
from visiondepth3d_tpu.depth.model import init_random
from visiondepth3d_tpu.io import Y4MReader, Y4MWriter
from visiondepth3d_tpu.pipeline.stereo_pipeline import RenderConfig as JConfig
from visiondepth3d_tpu.pipeline.stereo_pipeline import render_stereo_video as jrender
from test_torch_reference import bounded
from visiondepth3d_tpu_torch.cli.main import main as cli_main
from visiondepth3d_tpu_torch.depth import configs as tconfigs
from visiondepth3d_tpu_torch.depth.convert import from_jax_params, load_hf_state_dict
from visiondepth3d_tpu_torch.depth.dpt import DepthAnything
from visiondepth3d_tpu_torch.depth.model import DepthPredictor
from visiondepth3d_tpu_torch.pipeline.stereo_pipeline import RenderConfig, render_stereo_video

REPO = Path(__file__).resolve().parents[1]
SIZE = 56


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    path = tmp_path_factory.mktemp("slice") / "clip.y4m"
    h, w = 48, 64
    yy, xx = np.mgrid[0:h, 0:w]
    with Y4MWriter(str(path), w, h, 24.0) as wr:
        for i in range(6):
            f = np.zeros((h, w, 3), np.uint8)
            f[..., 0] = (xx * 4 + i * 4) % 256
            f[..., 1] = (yy * 5) % 256
            f[..., 2] = 100
            f[10:30, 10 + 4 * i: 25 + 4 * i] = (240, 50, 50)
            wr.write(f)
    return path


def _read(path):
    with Y4MReader(str(path)) as rd:
        return np.stack(list(rd))


def test_render_matches_jax(clip, tmp_path):
    params = init_random(DA_TINY, seed=1, size=SIZE)
    bounded(jrender, clip, None, tmp_path / "jax.y4m", None,
            JConfig(mesh="off", preserve_original_aspect=True, chunk_size=4,
                    device_yuv_in=False),
            predictor=JPredictor(DA_TINY, params, SIZE))
    model = DepthAnything(tconfigs.DA_TINY)
    load_hf_state_dict(model, from_jax_params(params, tconfigs.DA_TINY))
    prog = render_stereo_video(clip, None, tmp_path / "port.y4m", None,
                               RenderConfig(preserve_original_aspect=True, chunk_size=4,
                                            device="cpu"),
                               predictor=DepthPredictor(model, SIZE, device="cpu"))
    want, got = _read(tmp_path / "jax.y4m"), _read(tmp_path / "port.y4m")
    assert prog.frames_done == 6
    assert got.shape == want.shape == (6, 48, 128, 3)
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.mean() <= 0.1 and diff.max() <= 3, (diff.mean(), diff.max())


def test_depth_route_matches_jax(clip, tmp_path):
    """Video + depth video in (no predictor): the same stereo path."""
    depth = tmp_path / "depth.y4m"
    h, w = 48, 64
    yy, xx = np.mgrid[0:h, 0:w]
    with Y4MWriter(str(depth), w, h, 24.0) as wr:
        for i in range(6):
            d = (xx * 3 + 30).astype(np.uint8)
            d[10:30, 10 + 4 * i: 25 + 4 * i] = 220
            wr.write(np.repeat(d[..., None], 3, -1))
    bounded(jrender, clip, depth, tmp_path / "jax.y4m", None,
            JConfig(mesh="off", preserve_original_aspect=True, chunk_size=4,
                    device_yuv_in=False))
    render_stereo_video(clip, depth, tmp_path / "port.y4m", None,
                        RenderConfig(preserve_original_aspect=True, chunk_size=4,
                                     device="cpu"))
    want, got = _read(tmp_path / "jax.y4m"), _read(tmp_path / "port.y4m")
    assert got.shape == want.shape == (6, 48, 128, 3)
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.mean() <= 0.1 and diff.max() <= 3, (diff.mean(), diff.max())


def test_cli_render_cpu(clip, tmp_path):
    out = tmp_path / "cli.y4m"
    rc = cli_main(["render", "--input", str(clip), "--allow-random", "--device", "cpu",
                   "--output", str(out), "--preserve-aspect", "--chunk-size", "4",
                   "--inference-size", str(SIZE), "--enable_healing", "true"])
    assert rc == 0
    frames = _read(out)
    assert frames.shape == (6, 48, 128, 3)
    assert np.abs(frames[:, :, :64].astype(int) - frames[:, :, 64:].astype(int)).mean() > 0


# the render flags that raised before they were ported, and the output each
# gives now (--mesh dp=2 with --device cpu: two segments on the CPU)
CLI_FEATURES = {"mesh": (["--mesh", "dp=2"], (6, 48, 128, 3)),
                "skip_blank_frames": (["--skip-blank-frames"], (6, 48, 128, 3)),
                "auto_crop_black_bars": (["--auto-crop-black-bars"], (6, 48, 128, 3)),
                "vr": (["--format", "VR"], (6, 1600, 2880, 3)),
                "interlaced": (["--format", "Passive Interlaced"], (6, 48, 64, 3))}


@pytest.mark.parametrize("feature", sorted(CLI_FEATURES))
def test_cli_render_features(clip, tmp_path, feature):
    flag, shape = CLI_FEATURES[feature]
    argv = ["render", "--input", str(clip), "--allow-random", "--device", "cpu", "--output",
            str(tmp_path / "x.y4m"), "--inference-size", str(SIZE), "--preserve-aspect",
            "--chunk-size", "4", *flag]
    if shape is None:
        with pytest.raises(NotImplementedError):
            cli_main(argv)
        return
    assert cli_main(argv) == 0
    frames = _read(tmp_path / "x.y4m")
    assert frames.shape == shape and frames.std() > 1.0


def test_cli_render_dof_cpu(clip, tmp_path):
    """Depth of field through the CLI on the CPU (the plain ops): the
    output differs from the same render without it."""
    outs = {}
    for dof in ("0", "2"):
        outs[dof] = tmp_path / f"dof{dof}.y4m"
        rc = cli_main(["render", "--input", str(clip), "--allow-random", "--device", "cpu",
                       "--output", str(outs[dof]), "--preserve-aspect", "--chunk-size", "4",
                       "--inference-size", str(SIZE), "--dof_strength", dof])
        assert rc == 0
    sharp, blurred = _read(outs["0"]), _read(outs["2"])
    assert blurred.shape == sharp.shape == (6, 48, 128, 3)
    assert np.abs(blurred.astype(int) - sharp.astype(int)).mean() > 0.5


def test_cuda_device_without_card_raises(clip, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError):
        render_stereo_video(clip, None, tmp_path / "x.y4m", None, RenderConfig(device="cuda"),
                            predictor=DepthPredictor(DepthAnything(tconfigs.DA_TINY), SIZE,
                                                     device="cpu"))


_NO_JAX = """
import pkgutil
import sys
import tempfile
import numpy as np
import torch
import visiondepth3d_tpu_torch
for mod in pkgutil.walk_packages(visiondepth3d_tpu_torch.__path__, "visiondepth3d_tpu_torch."):
    if not mod.name.endswith("__main__"):  # that one runs the CLI
        __import__(mod.name)
for name in ("depth.depth_pro", "depth.vda", "depth.diffusion.schedulers",
             "depth.diffusion.vae", "depth.diffusion.unet2d", "depth.diffusion.marigold",
             "depth.diffusion.loaders", "depth.diffusion.clip_vision",
             "depth.diffusion.unet_st", "depth.diffusion.depthcrafter", "depth.onnx_exec",
             "utils.onnx_reader", "utils.observability", "utils.memory", "utils.scene_detect",
             "utils.verify_checkpoints", "io.audio", "pipeline.image_pipeline",
             "config.i18n", "config.settings", "preview", "preview.diagnostics",
             "preview.watch", "preview.server", "serve", "serve.jobs", "serve.app",
             "parallel", "parallel.mesh", "parallel.dp", "parallel.pp", "parallel.halo",
             "parallel.tp", "parallel.sp", "stereo.bands",
             "pipeline.mesh_render", "pipeline.pp_render", "train", "train.trainer"):
    assert "visiondepth3d_tpu_torch." + name in sys.modules, name
from visiondepth3d_tpu_torch.depth import DA_TINY
from visiondepth3d_tpu_torch.depth.registry import load_predictor
from visiondepth3d_tpu_torch.enhance import EnhanceConfig, run_merged_pipeline
from visiondepth3d_tpu_torch.io import Y4MWriter
from visiondepth3d_tpu_torch.state import init_trackers
from visiondepth3d_tpu_torch.stereo import StereoParams
from visiondepth3d_tpu_torch.stereo.step import render_chunk
pred = load_predictor("depth-anything-v2-small", None, inference_size=28, config=DA_TINY,
                      device="cpu")
frames = torch.rand(2, 24, 32, 3, generator=torch.Generator().manual_seed(0))
depths = pred.predict_01(frames, out_hw=(24, 32))
_, out = render_chunk(StereoParams().with_shift_bound(32), init_trackers(24, 32, device="cpu"),
                      frames, depths)
assert out.left.shape == (2, 24, 32, 3)
_, out = render_chunk(StereoParams(dof_strength=2.0).with_shift_bound(32),
                      init_trackers(24, 32, device="cpu"), frames, depths)
assert out.left.shape == (2, 24, 32, 3)
from visiondepth3d_tpu_torch.ops import attention
from visiondepth3d_tpu_torch.pipeline.depth_pipeline import DepthConfig, render_depth_video_file
attention.USE_VMEM_KERNEL = True
big = load_predictor("depth-anything-v2-small", None, inference_size=322, config=DA_TINY,
                     device="cpu")
with tempfile.TemporaryDirectory() as td:
    with Y4MWriter(td + "/in.y4m", 16, 12, 24.0) as wr:
        for i in range(3):
            wr.write(np.full((12, 16, 3), 40 * i, np.uint8))
    cfg = EnhanceConfig(esrgan_nf=8, esrgan_nb=1, esrgan_gc=8, rife_scales=(2, 1),
                        chunk_size=2, allow_random_weights=True)
    assert run_merged_pipeline(td + "/in.y4m", td + "/out.y4m", cfg, device="cpu") == 5
    for tiled in (False, True):
        dcfg = DepthConfig(inference_size=322, tile_size=322, tiled=tiled, batch_size=2,
                           device="cpu")
        assert render_depth_video_file(td + "/in.y4m", td + "/depth.y4m", dcfg,
                                       predictor=big) == 3
    # the row-sharded model (K7's query-band form) on the CPU twice
    dcfg = DepthConfig(inference_size=322, batch_size=2, mesh="sp=2", device="cpu")
    assert render_depth_video_file(td + "/in.y4m", td + "/sp.y4m", dcfg, predictor=big) == 3
    # the render surface: a preset, blank frames, black bars, a cancelled
    # render resumed, a batch pairing, the control file
    from visiondepth3d_tpu_torch.config import load_builtin
    from visiondepth3d_tpu_torch.pipeline.batch import pair_videos_with_depth
    from visiondepth3d_tpu_torch.pipeline.stereo_pipeline import render_stereo_video
    from visiondepth3d_tpu_torch.utils.observability import make_control_check
    params, rcfg = load_builtin("best3d")
    rcfg.__dict__.update(device="cpu", preserve_original_aspect=True, chunk_size=1,
                         skip_blank_frames=True, auto_crop_black_bars=True,
                         checkpoint_every_chunks=1, output_format="Red-Cyan Anaglyph")
    render_stereo_video(td + "/in.y4m", None, td + "/sbs.y4m", params, rcfg, predictor=pred,
                        cancel_check=make_control_check(td + "/no-such-file"))
    rcfg.resume = True
    render_stereo_video(td + "/in.y4m", None, td + "/sbs.y4m", params, rcfg, predictor=pred)
    assert pair_videos_with_depth(td, td, td) == []
    # DepthCrafter's tiny pipeline and an ONNX graph through the depth route
    dcfg = DepthConfig(model="depthcrafter", allow_random=True, window_size=2, overlap=1,
                       device="cpu")
    assert render_depth_video_file(td + "/in.y4m", td + "/dc.y4m", dcfg) == 2
    from visiondepth3d_tpu_torch.utils.onnx_reader import write_onnx_graph
    write_onnx_graph(td + "/m.onnx", [("x", [None, 3, None, None])], [("d", None)],
                     [{"op": "ReduceMean", "inputs": ["x"], "outputs": ["d"],
                       "attrs": {"axes": [1], "keepdims": 0}}], {})
    ocfg = DepthConfig(model="onnx:" + td + "/m.onnx", inference_size=32, device="cpu")
    assert render_depth_video_file(td + "/in.y4m", td + "/o.y4m", ocfg) == 3
    # the mesh routes on the CPU twice, and one training step
    from visiondepth3d_tpu_torch.pipeline import RenderConfig
    for spec in ("dp=2", "pp=2", "tp=2"):
        mcfg = RenderConfig(device="cpu", preserve_original_aspect=True, chunk_size=2,
                            mesh=spec)
        render_stereo_video(td + "/in.y4m", None, td + "/m.y4m", params, mcfg, predictor=pred)
    from visiondepth3d_tpu_torch.parallel import make_mesh, render_chunk_spatial
    from visiondepth3d_tpu_torch.parallel.dp import spatial_layout
    from visiondepth3d_tpu_torch.stereo.bands import init_band_trackers
    sp_params = StereoParams(enable_edge_masking=False, blur_ksize=3).with_shift_bound(32)
    mesh = make_mesh(dp=1, sp=2, devices=["cpu", "cpu"])
    layout = spatial_layout(sp_params, 24, 32, mesh)
    _, out = render_chunk_spatial(sp_params, init_band_trackers(layout, 32), frames, depths,
                                  mesh)
    assert out.left.shape == (2, 24, 32, 3)
    from visiondepth3d_tpu_torch.train import Trainer
    trainer = Trainer(DA_TINY, device="cpu").init(torch.Generator().manual_seed(0))
    assert np.isfinite(trainer.step(torch.rand(2, 28, 28, 3), torch.rand(2, 28, 28)))
    trainer = Trainer(DA_TINY, device="cpu").init(
        torch.Generator().manual_seed(0), mesh=make_mesh(dp=1, tp=2, devices=["cpu", "cpu"]))
    assert np.isfinite(trainer.step(torch.rand(2, 28, 28, 3), torch.rand(2, 28, 28)))
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "visiondepth3d_tpu"))
assert not bad, bad
print("ok")
"""


def test_port_imports_no_jax():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", _NO_JAX], capture_output=True, text=True,
                         cwd=REPO, env=env, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip().endswith("ok")
