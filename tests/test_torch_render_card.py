"""The render route's new surface on the card, against the same render on
the CPU (the plain versions of the kernels). Every case is ``cuda``-marked
and skips without a card; ``tests/run_cuda_tests.py`` runs them there.

- Each output format (Half-SBS, VR, Red-Cyan Anaglyph in both channel
  conventions, Passive Interlaced) through the depth-video route of a
  64x48 clip, bf16 image plane and healing on: mean |d| <= 1 u8 and SSIM
  >= 0.99 per frame, the render gate of ``chip_smoke.py``'s parity phase.
- A render cancelled after its second chunk and resumed on the card is
  byte-identical to an unbroken render on the card.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch
torch.set_num_threads(1)

from visiondepth3d_tpu_torch.io import Y4MReader, Y4MWriter
from visiondepth3d_tpu_torch.kernels import launch_counts, reset_launch_counts
from visiondepth3d_tpu_torch.pipeline.stereo_pipeline import RenderConfig, render_stereo_video
from visiondepth3d_tpu_torch.stereo import StereoParams

H, W, N = 48, 64, 8
PARAMS = StereoParams(enable_healing=True, image_dtype="bfloat16")


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    d = tmp_path_factory.mktemp("card")
    yy, xx = np.mgrid[0:H, 0:W]
    with Y4MWriter(str(d / "clip.y4m"), W, H, 24.0) as wr, \
            Y4MWriter(str(d / "depth.y4m"), W, H, 24.0) as wd:
        for i in range(N):
            f = np.empty((H, W, 3), np.uint8)
            f[..., 0] = (xx * 4 + i * 4) % 256
            f[..., 1] = (yy * 5) % 256
            f[..., 2] = 100
            f[10:30, 10 + 3 * i: 25 + 3 * i] = (240, 50, 50)
            wr.write(f)
            dd = (xx * 3 + 30).astype(np.uint8)
            dd[10:30, 10 + 3 * i: 25 + 3 * i] = 220
            wd.write(np.repeat(dd[..., None], 3, -1))
    return d / "clip.y4m", d / "depth.y4m"


def _read(path):
    with Y4MReader(str(path)) as rd:
        return np.stack(list(rd))


def _ssim(a, b):
    def box(x, k=7):
        c = np.cumsum(np.cumsum(np.pad(x, ((1, 0), (1, 0))), 0), 1)
        return (c[k:, k:] - c[:-k, k:] - c[k:, :-k] + c[:-k, :-k]) / (k * k)

    wts = np.array([0.299, 0.587, 0.114])
    x, y = a.astype(np.float64) @ wts, b.astype(np.float64) @ wts
    c1, c2 = (0.01 * 255) ** 2, (0.03 * 255) ** 2
    mx, my = box(x), box(y)
    vx, vy, cxy = box(x * x) - mx * mx, box(y * y) - my * my, box(x * y) - mx * my
    return float((((2 * mx * my + c1) * (2 * cxy + c2))
                  / ((mx * mx + my * my + c1) * (vx + vy + c2))).mean())


FORMATS = {"half_sbs": ("Half-SBS", False), "vr": ("VR", False),
           "anaglyph": ("Red-Cyan Anaglyph", False), "anaglyph_bgr": ("Red-Cyan Anaglyph", True),
           "interlaced": ("Passive Interlaced", False)}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(FORMATS))
def test_cuda_render_format_matches_cpu(case, pair, tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    fmt, bgr = FORMATS[case]
    clip, depth = pair
    outs = {}
    for device in ("cpu", "cuda"):
        cfg = RenderConfig(output_format=fmt, anaglyph_bgr_convention=bgr,
                           preserve_original_aspect=True, chunk_size=4, device=device)
        reset_launch_counts()
        render_stereo_video(clip, depth, tmp_path / f"{device}.y4m", PARAMS, cfg)
        if device == "cuda":
            torch.cuda.synchronize()
            assert all(launch_counts[k] == N * m for k, m in
                       (("stereo_warp", 1), ("feather_heal", 1), ("quantile_pair", 2),
                        ("subject_stats", 3))), dict(launch_counts)
        outs[device] = _read(tmp_path / f"{device}.y4m")
    a, b = outs["cpu"], outs["cuda"]
    assert a.shape == b.shape and a.shape[0] == N
    assert np.abs(a.astype(int) - b.astype(int)).mean() <= 1.0
    assert min(_ssim(x, y) for x, y in zip(a, b)) >= 0.99


@pytest.mark.cuda
def test_cuda_resume_is_byte_identical(pair, tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    clip, depth = pair
    cfg = RenderConfig(preserve_original_aspect=True, chunk_size=2, checkpoint_every_chunks=1,
                       device="cuda")
    render_stereo_video(clip, depth, tmp_path / "full.y4m", PARAMS, cfg)
    calls = {"n": 0}

    def cancel():
        calls["n"] += 1
        return calls["n"] > 2

    part = tmp_path / "part.y4m"
    render_stereo_video(clip, depth, part, PARAMS, cfg, cancel_check=cancel)
    assert _read(part).shape[0] == 4
    render_stereo_video(clip, depth, part, PARAMS, dataclasses.replace(cfg, resume=True))
    assert part.read_bytes() == (tmp_path / "full.y4m").read_bytes()
