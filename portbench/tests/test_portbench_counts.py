"""The work the benchmark counts: the model FLOPs of both configurations
against a hand count, and the kernels' bytes and operations against
``chip_smoke.py``'s figures at the 1080p render's shapes."""

import json
from pathlib import Path

import pytest

from portbench.core.spec import flops_model, rooflines
from portbench.reference.depth_anything import model_cfg

PKG = Path(__file__).resolve().parents[1]


def _cfg(name):
    return model_cfg(json.loads((PKG / "configs" / f"{name}.json").read_text()))


def _hand_count(c, L, neck, f, hh=32, g=37, p=14):
    """Written out layer by layer at 518^2 (g = 37 patches a side, N = 1370
    tokens): 2 FLOPs a multiply-add."""
    n = g * g + 1
    patch = 2 * g * g * (3 * p * p) * c
    block = (2 * n * c * 3 * c  # q, k, v
             + 2 * n * n * c + 2 * n * n * c  # q k^T, then the weights times v
             + 2 * n * c * c  # the output projection
             + 2 * n * c * 4 * c + 2 * n * 4 * c * c)  # the MLP
    sides = [148, 74, 37, 19]  # transposed x4, x2, identity, stride-2 conv
    neck_f = 0
    for ch, side in zip(neck, sides):
        neck_f += 2 * g * g * c * ch
        if side == 148:
            neck_f += 2 * 148 * 148 * ch * ch
        elif side == 74:
            neck_f += 2 * 74 * 74 * ch * ch
        elif side == 19:
            neck_f += 2 * 19 * 19 * 9 * ch * ch
        neck_f += 2 * side * side * 9 * ch * f
    c3 = 2 * 9 * f * f
    fusion = (2 * c3 * 19 * 19 + 2 * 37 * 37 * f * f  # the deepest: one residual unit
              + 4 * c3 * 37 * 37 + 2 * 74 * 74 * f * f
              + 4 * c3 * 74 * 74 + 2 * 148 * 148 * f * f
              + 4 * c3 * 148 * 148 + 2 * 296 * 296 * f * f)
    head = (2 * 296 * 296 * 9 * f * (f // 2)
            + 2 * 518 * 518 * 9 * (f // 2) * hh + 2 * 518 * 518 * hh)
    return patch + L * block + neck_f + fusion + head


@pytest.mark.parametrize("name, c, layers, neck, fusion", [
    ("da2-small", 384, 12, (48, 96, 192, 384), 64),
    ("da2-large", 1024, 24, (256, 512, 1024, 1024), 256),
])
def test_flops_against_a_hand_count(name, c, layers, neck, fusion):
    got = flops_model("dpt_dinov2").flops_per_frame(_cfg(name), 518)
    assert got == _hand_count(c, layers, neck, fusion)


def test_flops_orders_of_magnitude():
    large = flops_model("dpt_dinov2").flops_per_frame(_cfg("da2-large"), 518)
    small = flops_model("dpt_dinov2").flops_per_frame(_cfg("da2-small"), 518)
    assert 1.2e12 < large < 1.35e12  # ~1.27 TFLOP a frame
    assert 0.08e12 < small < 0.15e12


H, W = 1080, 1920
LAYER_1080 = {"geometry": {"eye_h": H, "eye_w": W, "warp_h": H, "warp_w": W},
              "image_bytes": 4,
              "stereo": {"enable_feathering": True, "enable_healing": True, "blur_ksize": 9}}


def test_rooflines_against_chip_smoke():
    """chip_smoke.py's kernels phase at 1080p, float32: K1 38 H W operations
    and H W (12 * 4 + 4) bytes, K2 376 H W and 17 * 4 H W (feather and heal
    at k = 9), K3 24 H W and 4 H W + 8, K4 on the 648 x 1152 crop 42 n and
    4 n + 4 * 66."""
    r = rooflines()
    assert r["stereo_warp"].launches(LAYER_1080) == [(38.0 * H * W, H * W * (12 * 4 + 4.0),
                                                      "float32")]
    assert r["feather_heal"].launches(LAYER_1080) == [(376.0 * H * W, 17.0 * 4 * H * W,
                                                       "float32")]
    assert r["quantile_pair"].launches(LAYER_1080) == [(24.0 * H * W, 4.0 * H * W + 8,
                                                        "float32")] * 2
    n = 648 * 1152
    assert r["subject_stats"].launches(LAYER_1080) == [(42.0 * n, 4.0 * n + 264, "float32")] * 3


def test_feather_without_healing_counts_the_feather_only():
    layer = dict(LAYER_1080, stereo={"enable_feathering": True, "enable_healing": False,
                                     "blur_ksize": 9})
    (ops, nbytes, _), = rooflines()["feather_heal"].launches(layer)
    assert ops == 2 * 99.0 * H * W and nbytes == 17.0 * 4 * H * W
