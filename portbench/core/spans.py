"""Host spans the benchmark records around its calls into the program.

``span(name)`` times the call on the host clock and files it under the
current chunk; while a profiler traces, it also opens a
``record_function("portbench.<name>")`` range, so the trace holds the span
on the profiler's clock and device operations can be attributed to it by
the host time of their launch."""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

PREFIX = "portbench."


class Spans:
    def __init__(self):
        self.records: dict[str, list[tuple[float, float, int]]] = defaultdict(list)
        self.chunk = -1  # the chunk the host is in (set by the route's loop)
        self.tracing = False

    @contextlib.contextmanager
    def span(self, name: str):
        rf = None
        if self.tracing:
            from torch.profiler import record_function

            rf = record_function(PREFIX + name)
            rf.__enter__()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            t1 = time.perf_counter()
            if rf is not None:
                rf.__exit__(None, None, None)
            self.records[name].append((t0, t1, self.chunk))

    def total_s(self, name: str, chunks) -> float:
        """Seconds spent in ``name`` spans of the given chunks."""
        chunks = set(chunks)
        return sum(t1 - t0 for t0, t1, c in self.records.get(name, ()) if c in chunks)
