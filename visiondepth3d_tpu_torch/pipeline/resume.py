"""Checkpoint / resume for chunked renders.

Counterpart of ``visiondepth3d_tpu/pipeline/resume.py``. The only
cross-frame state of the stereo stage is the trackers, so a checkpoint is
(frame index, trackers) in an ``<output>.resume.npz`` sidecar: the arrays
``frame_index``, ``n_leaves`` and ``leaf_i``, one per ``StereoTrackers``
field in declaration order (the JAX package's pytree leaf order). Either
package resumes a render the other one started.
"""

from __future__ import annotations

import dataclasses
import os
import re
from pathlib import Path

import numpy as np
import torch

from ..state.trackers import StereoTrackers


def checkpoint_path(output_path) -> Path:
    return Path(str(output_path) + ".resume.npz")


def save_checkpoint(output_path, frame_index: int, trackers: StereoTrackers) -> None:
    """trackers: fields of CPU tensors or numpy arrays."""
    leaves = [np.asarray(getattr(trackers, f.name)) for f in dataclasses.fields(trackers)]
    np.savez(checkpoint_path(output_path), frame_index=np.int64(frame_index),
             n_leaves=np.int64(len(leaves)),
             **{f"leaf_{i}": leaf for i, leaf in enumerate(leaves)})


def load_checkpoint(output_path, template: StereoTrackers):
    """(frame_index, trackers) with each field on the template field's
    device and in its dtype, or None when there is no checkpoint."""
    p = checkpoint_path(output_path)
    if not p.exists():
        return None
    with np.load(p) as data:
        fields = dataclasses.fields(template)
        n = int(data["n_leaves"])
        if n != len(fields):
            raise ValueError(f"{p}: {n} tracker leaves, want {len(fields)}")
        kw = {}
        for i, f in enumerate(fields):
            like = getattr(template, f.name)
            leaf = torch.from_numpy(np.array(data[f"leaf_{i}"]))
            if tuple(leaf.shape) != tuple(like.shape):
                raise ValueError(f"{p}: {f.name} is {tuple(leaf.shape)}, the render's "
                                 f"{tuple(like.shape)}")
            kw[f.name] = leaf.to(device=like.device, dtype=like.dtype)
        return int(data["frame_index"]), StereoTrackers(**kw)


def clear_checkpoint(output_path) -> None:
    checkpoint_path(output_path).unlink(missing_ok=True)


def truncate_y4m_to(path, n_frames: int) -> None:
    """Cut a .y4m file back to exactly n_frames: the written file may be a
    chunk ahead of the last checkpoint (the flush lags the compute), so the
    appended continuation never duplicates frames."""
    p = Path(path)
    with p.open("rb") as f:
        header = f.readline()
    w = int(re.search(rb"W(\d+)", header).group(1))
    h = int(re.search(rb"H(\d+)", header).group(1))
    frame_bytes = 6 + w * h + 2 * (((w + 1) // 2) * ((h + 1) // 2))
    os.truncate(p, len(header) + n_frames * frame_bytes)
