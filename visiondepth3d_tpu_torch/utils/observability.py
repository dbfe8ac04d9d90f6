"""Cooperative suspend / resume / cancel through a control file.

The port's copy of ``make_control_check`` from
``visiondepth3d_tpu/utils/observability.py`` (the rest of that module
belongs to the JAX runtime and is not carried).
"""

from __future__ import annotations

import time


def make_control_check(path, poll_s: float = 0.5):
    """A ``cancel_check`` callable for the render loops, polled between
    chunks: it reads ``path``; 'cancel' returns True (stop), 'pause' blocks
    (polling every ``poll_s``) until the content changes, anything else (or
    a missing file) returns False."""

    def _state() -> str:
        try:
            with open(path) as f:
                return f.read().strip().lower()
        except OSError:
            return ""

    def check() -> bool:
        while True:
            s = _state()
            if s == "cancel":
                return True
            if s != "pause":
                return False
            time.sleep(poll_s)

    return check
