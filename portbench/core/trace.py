"""The profiler's trace of a stretch of the run, reduced to what the
per-layer readers need.

``traced(spans, fn)`` runs ``fn`` under ``torch.profiler`` (host and CUDA
activity) inside a ``portbench.stretch`` span; ``view`` exports the Chrome
trace to a file under the temporary directory, reads it back and deletes
it, after the measured window. The
trace pairs each device operation (kernel, copy, set) with the runtime call
that launched it (their ``correlation``), whose host time places the
operation under the benchmark's spans. ``TraceView`` holds the result; it
is built from plain event dicts, so a test can build one from a synthetic
trace.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile

from .spans import PREFIX

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
STRETCH = "stretch"


class TraceView:
    """Device operations and benchmark spans of one traced stretch, times in
    seconds on the profiler's clock.

    ``ops``: dicts with ``name``, ``start``, ``end`` and ``launch`` (the host
    time of the launching call, None when it was not traced).
    ``spans``: span name (without the prefix) -> sorted (start, end) list.
    ``window``: the stretch's (start, end).
    """

    def __init__(self, events: list[dict]):
        launch_ts = {}
        self.host_calls: dict[str, float] = {}  # runtime call -> seconds, for the notes
        for e in events:
            if e.get("cat") in LAUNCH_CATS:
                self.host_calls[e["name"]] = self.host_calls.get(e["name"], 0.0) + \
                    e.get("dur", 0.0) * 1e-6
                if "correlation" in (e.get("args") or {}):
                    launch_ts[e["args"]["correlation"]] = e["ts"] * 1e-6
        self.ops = []
        spans: dict[str, list] = {}
        for e in events:
            cat = e.get("cat")
            if cat in DEVICE_CATS:
                start = e["ts"] * 1e-6
                corr = (e.get("args") or {}).get("correlation")
                self.ops.append({"name": e["name"], "start": start,
                                 "end": start + e.get("dur", 0.0) * 1e-6,
                                 "launch": launch_ts.get(corr)})
            elif cat == "user_annotation" and e.get("name", "").startswith(PREFIX):
                start = e["ts"] * 1e-6
                spans.setdefault(e["name"][len(PREFIX):], []).append(
                    (start, start + e.get("dur", 0.0) * 1e-6))
        self.spans = {k: sorted(v) for k, v in spans.items()}
        if STRETCH not in self.spans:
            raise ValueError("the trace holds no portbench.stretch span")
        self.window = self.spans[STRETCH][0]
        self._starts = {k: [s for s, _ in v] for k, v in self.spans.items()}

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def _intervals(self):
        w0, w1 = self.window
        ivs = sorted((max(o["start"], w0), min(o["end"], w1)) for o in self.ops)
        return [(s, e) for s, e in ivs if e > s]

    def busy_intervals(self) -> list[tuple[float, float]]:
        """The union of the device operations' intervals inside the window."""
        out: list[list[float]] = []
        for s, e in self._intervals():
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals())

    def idle_gaps(self) -> list[tuple[float, float]]:
        """(start, length) of each stretch of the window with no device
        operation running."""
        w0, w1 = self.window
        gaps, t = [], w0
        for s, e in self.busy_intervals():
            if s > t:
                gaps.append((t, s - t))
            t = max(t, e)
        if w1 > t:
            gaps.append((t, w1 - t))
        return gaps

    def in_span(self, name: str, t: float | None) -> bool:
        """Whether host time t lies inside a span called ``name``."""
        if t is None or name not in self.spans:
            return False
        i = bisect.bisect_right(self._starts[name], t) - 1
        return i >= 0 and self.spans[name][i][0] <= t <= self.spans[name][i][1]

    def launched_in(self, name: str) -> list[dict]:
        """The device operations launched from inside ``name`` spans."""
        return [o for o in self.ops if self.in_span(name, o["launch"])]

    def span_at(self, t: float) -> str:
        """The innermost benchmark span (the shortest that holds host time
        t); ``loop`` outside every span but the stretch."""
        best, best_len = "loop", float("inf")
        for name, ivs in self.spans.items():
            if name == STRETCH:
                continue
            i = bisect.bisect_right(self._starts[name], t) - 1
            if i >= 0 and ivs[i][0] <= t <= ivs[i][1] and ivs[i][1] - ivs[i][0] < best_len:
                best, best_len = name, ivs[i][1] - ivs[i][0]
        return best

    def top_ops(self, n: int = 10) -> list[list]:
        by_name: dict[str, float] = {}
        for o in self.ops:
            if self.in_span(STRETCH, o["start"]):
                by_name[o["name"]] = by_name.get(o["name"], 0.0) + (o["end"] - o["start"])
        return [[k[:160], v] for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:n]]

    def top_gaps(self, n: int = 10) -> list[list]:
        gaps = sorted(self.idle_gaps(), key=lambda g: -g[1])[:n]
        return [[self.span_at(s), length] for s, length in gaps]


def traced(spans, fn, cuda: bool = True):
    """Run fn() under the profiler inside a ``stretch`` span and return the
    profiler; ``view`` reads it (after the measured window). The stretch
    starts and ends with the card idle. Without ``cuda`` (the CPU
    rehearsal) only the host is traced."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    sync = torch.cuda.synchronize if cuda else (lambda: None)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    sync()
    spans.tracing = True
    try:
        with profile(activities=activities) as prof:
            with spans.span(STRETCH):
                fn()
                sync()
    finally:
        spans.tracing = False
    return prof


def view(prof) -> TraceView:
    """The trace of a ``traced`` stretch, through a Chrome trace file under
    the temporary directory (deleted)."""
    fd, path = tempfile.mkstemp(prefix="portbench_trace_", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            data = json.load(f)
    finally:
        os.unlink(path)
    events = data["traceEvents"] if isinstance(data, dict) else data
    return TraceView(events)
