"""Shared pieces of the benchmark's own tests: a tiny Depth Anything
configuration and a tiny mix, small enough for the CPU."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY_CONFIG = {
    "name": "tiny", "port_model": "depth-anything-v2-small", "family": "dpt_dinov2",
    "dtype": "float32", "tf32": False, "inference_size": 70, "fast_head": False,
    "check_catalog": False,
    "backbone_config": {"hidden_size": 32, "num_hidden_layers": 4, "num_attention_heads": 2,
                        "mlp_ratio": 4, "patch_size": 14, "image_size": 70,
                        "layer_norm_eps": 1e-6, "layerscale_value": 1.0,
                        "out_indices": [1, 2, 3, 4]},
    "neck_hidden_sizes": [16, 24, 32, 40], "reassemble_factors": [4, 2, 1, 0.5],
    "fusion_hidden_size": 16, "head_hidden_size": 8, "depth_estimation_type": "relative",
    "max_depth": 1,
}

TINY_MIX = {
    "name": "tinymix", "route": "render_fused", "width": 128, "height": 72, "frames": 12,
    "fps": 24, "output_format": "Full-SBS", "output_height": 72, "preserve_aspect": True,
    "chunk_size": 4, "stereo": {}, "warmup_chunks": 2, "trace_chunks": 2, "check_chunks": 2,
}


@pytest.fixture
def tiny_config():
    return dict(TINY_CONFIG, backbone_config=dict(TINY_CONFIG["backbone_config"]))


@pytest.fixture
def tiny_mix(tmp_path, monkeypatch):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    import tempfile

    monkeypatch.setattr(tempfile, "tempdir", None)
    return dict(TINY_MIX)


@pytest.fixture
def bench():
    from portbench.core.spec import Benchmark

    return Benchmark(ROOT)


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"
