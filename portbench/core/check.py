"""The comparison that decides ``correct`` for routes that render chunks.

The program's record of each compared chunk (the state it started from
and ended with, the depth it inferred, the output planes it delivered) is
held against the plain reference, and reduced to three numbers, each with
its limit:

- ``depth_gap``: the widest gap between the program's depth and the
  reference model's, over every pixel of every compared frame (depth in
  [0, 1]);
- ``state_gap``: the widest gap between the program's temporal depth
  filter (the trackers' ``prev_depth`` plane) after a compared chunk and
  the reference's, which ran the chunk on its own depth;
- ``frame_off_share``: over the compared frames, the largest share of a
  frame's output bytes (Y, U and V) that differ by more than
  ``TOLERANCE`` u8 steps from the reference's byte at the same place. Here
  the reference's stereo stage runs on the program's depth, from the same
  trackers: the stage decides on exact counts (quantile bisection, the
  subject histogram's peak, deadbands, floors), so a depth that differs by
  float32 rounding can tip a decision and move a whole frame by a fraction
  of a pixel; on the same depth both sides decide alike, and what is left
  is the rounding of the image plane.

A compared chunk whose frames never reached the writer, a number that is
not finite, or a number over its limit makes the run not correct.
"""

import math

import numpy as np
import torch

NUMBERS = ("depth_gap", "frame_off_share", "state_gap")
TOLERANCE = 1  # u8 steps
STATE_FIELDS = ("prev_depth",)


def frame_gaps(prog: tuple, ref: tuple) -> np.ndarray:
    """Mean |program - reference| of each frame over its Y, U, V bytes."""
    tot = None
    n = 0
    for p, r in zip(prog, ref):
        d = (torch.as_tensor(np.asarray(p)).to(torch.int32)
             - r.to("cpu", torch.int32)).abs().reshape(r.shape[0], -1)
        tot = d.sum(1).double() if tot is None else tot + d.sum(1).double()
        n += d.shape[1]
    return (tot / n).numpy()


def frame_shares(prog: tuple, ref: tuple, tolerance: int = TOLERANCE) -> np.ndarray:
    """The share of each frame's Y, U, V bytes (prog: host arrays, ref:
    tensors, [T, h, w] each) off by more than ``tolerance`` from the
    reference's."""
    tot = None
    n = 0
    for p, r in zip(prog, ref):
        d = (torch.as_tensor(np.asarray(p)).to(r.device, torch.int16)
             - r.to(torch.int16)).abs().reshape(r.shape[0], -1)
        s = (d > tolerance).sum(1).double().cpu()
        tot = s if tot is None else tot + s
        n += d.shape[1]
    return (tot / n).numpy()


def state_gaps(prog: dict, ref: dict) -> dict:
    """The widest gap of each tracker field (``STATE_FIELDS`` are compared)."""
    return {k: float((torch.as_tensor(prog[k]).to("cpu", torch.float64)
                      - v.to("cpu", torch.float64)).abs().max()) for k, v in ref.items()}


def worse(a: float, b: float) -> float:
    """The larger of two gaps; not a number when either is not."""
    return math.nan if math.isnan(a) or math.isnan(b) else max(a, b)


def combine(gaps: dict, limits: dict) -> tuple[bool, list[tuple[str, float, float]]]:
    """(correct, [(name, value, limit)]) of the worst gap of each number."""
    rows = [(k, float(gaps.get(k, math.nan)), float(limits[k])) for k in NUMBERS]
    ok = all(math.isfinite(v) and v <= lim for _, v, lim in rows)
    return ok, rows
