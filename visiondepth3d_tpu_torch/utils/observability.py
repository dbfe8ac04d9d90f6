"""Progress, FPS and ETA reporting, crash logging, stage timing, profiling
hooks, the render loop's spans and cooperative suspend / resume / cancel.

The port of ``visiondepth3d_tpu/utils/observability.py``: a rolling
10-sample FPS + ETA meter, excepthooks appending to ``vd3d_crash.log``,
wall-clock stage timers (device work is asynchronous: a timer given
``sync`` waits for the card with ``torch.cuda.synchronize`` before it
stops), a ``torch.profiler`` trace context, and the suspend / cancel handle
and control file the render loops poll between chunks.

The port adds a span recorder. The render loop and the model loader open
``span(name)`` around each stage and ``count(name, n)`` what a chunk holds.
While no ``torch.profiler`` traces the calling thread, a span is one shared
no-op context and a count does nothing. While one does, a span opens
``record_function("vd3d.<name>")``, so the trace holds it on the clock of
the device operations launched inside it, and keeps its name, host start
and end (``time.perf_counter``), parent and chunk, and counts are kept per
chunk, for ``records()``. A profiler traces only the thread that started
it, and one runs at a time, so one stack of open spans serves.
"""

from __future__ import annotations

import contextlib
import os
import sys
import tempfile
import threading
import time
import traceback
from collections import defaultdict, deque
from pathlib import Path
from typing import NamedTuple

CRASH_LOG = Path("vd3d_crash.log")
SPAN_PREFIX = "vd3d."  # the spans' ranges in a profiler trace


class FpsMeter:
    """Rolling-window FPS + ETA (10 samples, as the reference keeps)."""

    def __init__(self, total: int | None = None, window: int = 10):
        self.total = total
        self.samples: deque[float] = deque(maxlen=window)
        self.done = 0
        self.started = time.time()
        self._prev = self.started

    def tick(self, n: int = 1) -> None:
        now = time.time()
        dt = now - self._prev
        if dt > 0:
            self.samples.append(n / dt)
        self._prev = now
        self.done += n

    @property
    def fps(self) -> float:
        return sum(self.samples) / len(self.samples) if self.samples else 0.0

    @property
    def eta_seconds(self) -> float | None:
        if not self.total or self.fps <= 0:
            return None
        return max(self.total - self.done, 0) / self.fps

    def status(self) -> str:
        elapsed = time.strftime("%H:%M:%S", time.gmtime(time.time() - self.started))
        pct = f"{100.0 * self.done / self.total:.2f}%" if self.total else f"{self.done}"
        eta = self.eta_seconds
        eta_s = time.strftime("%H:%M:%S", time.gmtime(eta)) if eta is not None else "--"
        return f"{pct} | FPS: {self.fps:.2f} | Elapsed: {elapsed} | ETA: {eta_s}"


def install_crash_logging(path: Path | str = CRASH_LOG) -> None:
    """sys and threading excepthooks that append full tracebacks to a log."""
    path = Path(path)

    def _log(exc_type, exc, tb):
        with path.open("a") as f:
            f.write(f"\n=== {time.strftime('%Y-%m-%d %H:%M:%S')} ===\n")
            traceback.print_exception(exc_type, exc, tb, file=f)
        traceback.print_exception(exc_type, exc, tb)

    sys.excepthook = _log

    def _thread_hook(args):
        _log(args.exc_type, args.exc_value, args.exc_traceback)

    threading.excepthook = _thread_hook


def _synchronize(sync) -> None:
    """Wait for the cards that hold the tensors of ``sync`` (a tensor, or a
    list, tuple or dict of them); a CPU tensor has nothing to wait for."""
    import torch

    if isinstance(sync, dict):
        sync = list(sync.values())
    tensors = sync if isinstance(sync, (list, tuple)) else [sync]
    for dev in {t.device for t in tensors if isinstance(t, torch.Tensor) and t.is_cuda}:
        torch.cuda.synchronize(dev)


@contextlib.contextmanager
def stage_timer(name: str, sink: dict | None = None, sync=None):
    """Wall-clock stage timer; pass ``sync`` (the stage's output tensors) to
    wait for the card's work on them before the clock stops."""
    t0 = time.perf_counter()
    yield
    if sync is not None:
        _synchronize(sync)
    dt = time.perf_counter() - t0
    if sink is not None:
        sink.setdefault(name, []).append(dt)
    else:
        print(f"[stage] {name}: {dt * 1000:.1f} ms")


@contextlib.contextmanager
def profiler_trace(log_dir: str | None = None):
    """A ``torch.profiler`` trace of the host and, where there is a card, the
    device, written to ``log_dir`` for TensorBoard when the context ends
    (default: ``vd3d_trace`` in the temporary directory)."""
    import torch

    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "vd3d_trace")
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)):
        yield log_dir


class SpanRecord(NamedTuple):
    name: str
    start: float  # time.perf_counter seconds
    end: float
    parent: str | None  # the enclosing span's name
    chunk: int | None  # the chunk the span belongs to, None outside every chunk


class Records(NamedTuple):
    spans: list[SpanRecord]  # in the order they ended
    counts: dict[tuple[str, int | None], int]  # (name, chunk) -> total


_SPANS: list[SpanRecord] = []
_COUNTS: dict[tuple[str, int | None], int] = defaultdict(int)
_OPEN: list[_Span] = []  # the traced thread's open spans, innermost last
_OFF = contextlib.nullcontext()


def _tracing() -> bool:
    """Whether a ``torch.profiler`` traces the calling thread."""
    import torch

    return torch._C._autograd._profiler_enabled()


class _Span:
    __slots__ = ("name", "chunk", "parent", "start", "range")

    def __init__(self, name: str, chunk: int | None):
        import torch

        self.name, self.chunk = name, chunk
        self.range = torch.profiler.record_function(SPAN_PREFIX + name)

    def __enter__(self):
        outer = _OPEN[-1] if _OPEN else None
        self.parent = outer.name if outer else None
        if self.chunk is None and outer is not None:
            self.chunk = outer.chunk
        _OPEN.append(self)
        self.range.__enter__()
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter()
        self.range.__exit__(*exc)
        _OPEN.pop()
        _SPANS.append(SpanRecord(self.name, self.start, end, self.parent, self.chunk))
        return False


def span(name: str, chunk: int | None = None):
    """A span around a stage of the program. With ``chunk``, the span and
    every span opened inside it belong to that chunk; without, a span
    belongs to the chunk of the span it is opened in. While no profiler
    traces the thread this is one shared context that does nothing."""
    if not _tracing():
        return _OFF
    return _Span(name, chunk)


def count(name: str, n: int) -> None:
    """Add ``n`` to the counter ``name`` of the current chunk (kept only
    while a profiler traces the thread)."""
    if _tracing():
        _COUNTS[name, _OPEN[-1].chunk if _OPEN else None] += n


def records() -> Records:
    """A copy of the spans and counts kept so far."""
    return Records(list(_SPANS), dict(_COUNTS))


def reset_records() -> None:
    """Forget every kept span and count."""
    _SPANS.clear()
    _COUNTS.clear()


class RenderControl:
    """Cooperative suspend / resume / cancel handle, polled between chunks
    (the reference's threading.Event pair, render_3d.py:33-34)."""

    def __init__(self):
        self._suspend = threading.Event()
        self._cancel = threading.Event()

    def suspend(self):
        self._suspend.set()

    def resume(self):
        self._suspend.clear()

    def cancel(self):
        self._cancel.set()

    @property
    def cancelled(self) -> bool:
        return self._cancel.is_set()

    def checkpoint(self, poll_s: float = 0.2) -> bool:
        """Block while suspended; return True if cancelled."""
        while self._suspend.is_set() and not self._cancel.is_set():
            time.sleep(poll_s)
        return self._cancel.is_set()


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
