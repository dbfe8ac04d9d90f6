"""Depth Pro's decoder in frame groups (``depth/depth_pro.py``:
``frame_groups``, ``DepthPro._decoder_elements``, ``MAX_ELEMENTS``).

- At the published widths and 1536^2 (the model on the meta device, no
  arithmetic): a frame's largest decoder tensor is the head's 128 x 1536^2,
  so a chunk of 16 frames runs the decoder in groups of 6, 6 and 4, and 7
  frames or 1 frame in one group.
- ``_decoder_elements`` is the largest per-frame output of any module the
  decoder runs (forward hooks, the JAX package's tiny config).
- With ``MAX_ELEMENTS`` made small, ``DEPTH_PRO_TINY`` at 5 frames gives
  the ungrouped forward's depth and field of view within 1e-6 and the
  ``depth.fusion_groups`` counter reads the groups; unpatched it reads 1.
- In two groups each frame gets the depth it gets alone.
"""

from __future__ import annotations

import pytest
import torch
torch.set_num_threads(1)
from torch.profiler import ProfilerActivity, profile

from visiondepth3d_tpu_torch.depth import depth_pro as dp
from visiondepth3d_tpu_torch.depth.model import init_random_fan_in_
from visiondepth3d_tpu_torch.utils import observability

SIZE = 64  # DEPTH_PRO_TINY's image encoder (32) times 2


def _tiny_model():
    model = init_random_fan_in_(dp.DepthPro(dp.DEPTH_PRO_TINY).eval(),
                                torch.Generator().manual_seed(3))
    with torch.no_grad():  # a positive last conv: its ReLU would zero most of the depth
        model.head.layers[4].weight.abs_()
    return model


def _pixels(n):
    return torch.rand((n, 3, SIZE, SIZE), generator=torch.Generator().manual_seed(7)) * 2 - 1


def _run(model, x):
    """(depth, fov, the counters) of one forward under the CPU profiler."""
    observability.reset_records()
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU]):
        depth, fov = model(x)
    counts = observability.records().counts
    observability.reset_records()
    return depth, fov, counts


def _group_sizes(model, x, monkeypatch):
    sizes = []
    decode = dp.DepthPro._decode

    def spy(self, features):
        sizes.append(features[0].shape[0])
        return decode(self, features)

    monkeypatch.setattr(dp.DepthPro, "_decode", spy)
    with torch.no_grad():
        model(x)
    return sizes


def _per_frame(model, depth):
    """The decoder's largest tensor of a frame: the head doubles the last
    fusion level's side."""
    return model._decoder_elements(depth.shape[1] // 2, depth.shape[2] // 2)


def _close(a, b, rel=1e-6):
    return float((a - b).abs().max()) <= rel * float(b.abs().max())


@pytest.mark.parametrize("frames,want", [(16, [6, 6, 4]), (7, [7]), (1, [1])])
def test_group_rule_at_the_published_shapes(frames, want, monkeypatch):
    with torch.device("meta"):
        model = dp.DepthPro().eval()
        assert model._decoder_elements(768, 768) == 128 * 1536 ** 2
        assert _group_sizes(model, torch.empty(frames, 3, 1536, 1536), monkeypatch) == want


def test_frame_groups_are_consecutive_near_equal_and_under_the_limit():
    for frames in range(1, 40):
        for per_frame in (1, 10 ** 8, 3 * 10 ** 8, 10 ** 9, 3 * 10 ** 9):
            groups = dp.frame_groups(frames, per_frame)
            sizes = [g.stop - g.start for g in groups]
            assert groups[0].start == 0 and groups[-1].stop == frames
            assert all(a.stop == b.start for a, b in zip(groups, groups[1:]))
            assert max(sizes) - min(sizes[:-1] or sizes) == 0 and sizes[-1] <= sizes[0]
            assert max(sizes) == 1 or max(sizes) * per_frame <= dp.MAX_ELEMENTS
            fewest = -(-frames // max(1, dp.MAX_ELEMENTS // per_frame))
            assert len(groups) == fewest


def test_decoder_elements_is_the_largest_decoder_tensor(monkeypatch):
    model = _tiny_model()
    outputs, asked = [], []

    def hook(module, args, out):
        outputs.append(out[0].numel())  # one frame's

    decoder = [model.depth_pro.neck, model.fusion_stage, model.head]
    handles = [m.register_forward_hook(hook) for d in decoder for m in d.modules()
               if not list(m.children())]
    real = dp.frame_groups

    def spy(frames, per_frame):
        asked.append(per_frame)
        return real(frames, per_frame)

    monkeypatch.setattr(dp, "frame_groups", spy)
    try:
        with torch.no_grad():
            depth, _ = model(_pixels(2))
    finally:
        for h in handles:
            h.remove()
    assert asked == [max(outputs)]
    # at the tiny widths: the head's 32-channel conv at the depth's size
    assert asked[0] == 32 * depth.shape[1] * depth.shape[2]


def test_groups_match_the_whole_chunk(monkeypatch):
    model, x = _tiny_model(), _pixels(5)
    depth, fov, counts = _run(model, x)
    assert counts[("depth.fusion_groups", None)] == 1
    assert float((depth > 0).float().mean()) > 0.5
    monkeypatch.setattr(dp, "MAX_ELEMENTS", 2 * _per_frame(model, depth))
    g_depth, g_fov, g_counts = _run(model, x)
    assert g_counts[("depth.fusion_groups", None)] == 3
    assert _group_sizes(model, x, monkeypatch) == [2, 2, 1]
    assert g_depth.shape == depth.shape and g_fov.shape == fov.shape
    assert _close(g_depth, depth) and _close(g_fov, fov)


def test_each_frame_in_two_groups_gets_its_depth_alone(monkeypatch):
    model, x = _tiny_model(), _pixels(5)
    with torch.no_grad():
        alone = torch.cat([model(x[i:i + 1])[0] for i in range(5)])
    monkeypatch.setattr(dp, "MAX_ELEMENTS", 3 * _per_frame(model, alone))
    assert _group_sizes(model, x, monkeypatch) == [3, 2]
    with torch.no_grad():
        grouped, _ = model(x)
    assert _close(grouped, alone)
