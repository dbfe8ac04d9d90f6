"""Stage pipeline parallelism: depth on one slice, stereo on the next.

Counterpart of ``visiondepth3d_tpu/parallel/pp.py``. The device list is
split into two slices: depth inference runs on slice A while the stereo
composition of the previous chunk runs on slice B. Launches are
asynchronous, so with chunk i + 1's depth enqueued on A before chunk i's
stereo is enqueued on B, both cards are busy at steady state; the hand-off
is a device-to-device copy ordered after A's work by an event recorded on
A's stream.

Shape contract:
  depth_fn(item_a)                  -> depths           (runs on slice A)
  stage_b_fn(carry, item_b, depths) -> (carry, out)     (runs on slice B)

An item is a tensor or a tuple/list of tensors and host values (the
tensors are moved to each slice; other values pass as they are). The carry
(the tracker state) stays on slice B. A wider slice shards frames on A
(the depth is then a list of frame groups, one per A device, which stage B
scatters to its row bands itself) and rows on B (``stereo/bands.py``).
"""

from __future__ import annotations

import torch


def to_device(x, device: torch.device):
    """x with every tensor (in nested tuples and lists) on ``device``,
    copied asynchronously."""
    if isinstance(x, torch.Tensor):
        return x.to(device, non_blocking=True)
    if isinstance(x, (tuple, list)):
        return type(x)(to_device(v, device) for v in x)
    return x


class TwoStagePipeline:
    def __init__(self, devices, split: int, depth_fn, stage_b_fn):
        """devices: flat device list; split: how many go to stage A. Items
        land on each slice's first device."""
        devices = [torch.device(d) for d in devices]
        if not 0 < split < len(devices):
            raise ValueError(f"split {split} of {len(devices)} devices")
        self.device_a, self.device_b = devices[0], devices[split]
        self._depth = depth_fn
        self._stage_b = stage_b_fn

    def _hand_off(self, item, depths):
        """(item, depths) on slice B, after everything enqueued on A so far.
        A list of depth groups stays where it is: stage B copies each band's
        rows straight from the groups (copies across cards order
        themselves after their source's stream)."""
        a, b = self.device_a, self.device_b
        if a != b and a.type == "cuda" and b.type == "cuda":
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(a))
            torch.cuda.current_stream(b).wait_event(done)
        if isinstance(depths, list):
            return to_device(item, b), depths
        return to_device(item, b), to_device(depths, b)

    def run(self, chunks, carry):
        """Software-pipelined drive: yields stage B's output per chunk, in
        order. The depth of chunk i + 1 is enqueued on slice A before stage
        B of chunk i."""
        pending = None
        for item in chunks:
            d = self._depth(to_device(item, self.device_a))
            if pending is not None:
                carry, out = self._stage_b(carry, *pending)
                yield out
            pending = self._hand_off(item, d)
        if pending is not None:
            carry, out = self._stage_b(carry, *pending)
            yield out
