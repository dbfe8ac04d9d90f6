"""The hand kernels' share of their roofline: the least time the card could
take for their launches in the traced stretch (each launch's bound, the
larger of its bytes over 3.35 TB/s and its operations over its type's peak,
from the work at the cell's shapes in ``portbench/roofline/``) over the
time they took. Nothing when no hand kernel ran."""

import re

from portbench.core.peaks import bound_s
from portbench.core.spec import rooflines


def matches(kernel: str, name: str) -> bool:
    return re.search(r"(^|[^A-Za-z0-9_])" + re.escape(kernel) + r"($|[<(])", name) is not None


def read(layer: dict):
    view = layer["trace"]
    if view is None:
        return None
    ops = view.launched_in("launch")
    bound, took = 0.0, 0.0
    for model in rooflines(layer["pkg"]).values():
        mine = [o for o in ops if matches(model.KERNEL, o["name"])]
        per_frame = model.launches(layer)
        if not mine or not per_frame:
            continue
        frame_bound = sum(bound_s(f, b, t) for f, b, t in per_frame)
        bound += len(mine) * frame_bound / len(per_frame)
        took += sum(o["end"] - o["start"] for o in mine)
    return 100.0 * bound / took if took > 0 else None
