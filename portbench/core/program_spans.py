"""The program's own spans in a traced stretch.

While a profiler traces, ``utils/observability.span`` in the program opens
a ``vd3d.<name>`` range around each stage; ``TraceView`` keeps only the
benchmark's ``portbench.`` spans. ``ProgramSpans`` indexes the program's
from the same trace events, and attributes each of the view's device
operations to a span by the host time of the call that launched it, as
``TraceView.launched_in`` does. ``events(prof)`` exports a ``traced``
stretch once (a file under the temporary directory, deleted), so a route
builds both from one export. A program without a span gives nothing: its
readers return None.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile

PREFIX = "vd3d."


def events(prof) -> list[dict]:
    """The Chrome trace events of a ``core.trace.traced`` stretch."""
    fd, path = tempfile.mkstemp(prefix="portbench_trace_", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            data = json.load(f)
    finally:
        os.unlink(path)
    return data["traceEvents"] if isinstance(data, dict) else data


class ProgramSpans:
    """``spans``: program span name (without the prefix) -> sorted (start,
    end) list, seconds on the profiler's clock; ``view``: the stretch's
    ``TraceView``, whose operations are attributed."""

    def __init__(self, trace_events: list[dict], view):
        spans: dict[str, list] = {}
        for e in trace_events:
            if e.get("cat") == "user_annotation" and e.get("name", "").startswith(PREFIX):
                start = e["ts"] * 1e-6
                spans.setdefault(e["name"][len(PREFIX):], []).append(
                    (start, start + e.get("dur", 0.0) * 1e-6))
        self.spans = {k: sorted(v) for k, v in spans.items()}
        self._starts = {k: [s for s, _ in v] for k, v in self.spans.items()}
        self.view = view

    def in_span(self, name: str, t: float | None) -> bool:
        """Whether host time t lies inside a program span called ``name``."""
        if t is None or name not in self.spans:
            return False
        i = bisect.bisect_right(self._starts[name], t) - 1
        return i >= 0 and self.spans[name][i][0] <= t <= self.spans[name][i][1]

    def launched_in(self, *names: str) -> list[dict]:
        """The device operations launched inside any span of ``names``
        (each operation once)."""
        return [o for o in self.view.ops if any(self.in_span(n, o["launch"]) for n in names)]


def device_ms_per_frame(layer: dict, *names: str):
    """Device milliseconds a traced frame of the operations launched inside
    the program spans ``names``; None without a trace or such an operation."""
    program, frames = layer.get("program"), layer.get("frames_traced")
    if program is None or not frames:
        return None
    ops = program.launched_in(*names)
    if not ops:
        return None
    return 1e3 * sum(o["end"] - o["start"] for o in ops) / frames
