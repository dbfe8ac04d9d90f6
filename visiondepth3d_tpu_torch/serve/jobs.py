"""Job manager of the web control surface (``vd3d-torch serve``).

The port's copy of ``visiondepth3d_tpu/serve/jobs.py``. The reference runs
every long operation on a daemon thread spawned from its Tk main loop, with
module-level suspend/cancel Events (VisionDepth3D.py:65-69, 1661-1662;
core/render_depth.py:37-39). Here one worker thread drains a FIFO of jobs,
each job carries its own pause and cancel events, and the HTTP layer
(``app.py``) reads job snapshots.

Jobs run one at a time through ONE worker: the reference is a one-GPU,
one-render-thread app, and two renders on one card would only compete for
its memory. The worker thread does the CUDA work, so whatever a runner
calls must be safe off the main thread (the kernel library builds under a
lock; every tensor names its device).

A runner writes its output under a staging name (``Job.stage``) and the
manager moves it to the final name only when the job ends ``done``. So a
job that fails, is cancelled, or dies with the process leaves a
``.partial`` file, never a half-written output under the name of a
finished one. ``shutdown`` cancels every job and waits for the worker; it
also runs at interpreter exit.
"""

from __future__ import annotations

import atexit
import dataclasses
import itertools
import os
import threading
import time
import traceback
import weakref
from typing import Any, Callable

_PARTIAL = ".partial"


def staging_path(path) -> str:
    """The name a job writes ``path`` under until it is done:
    ``clip_SBS.y4m`` -> ``clip_SBS.partial.y4m`` (the extension stays last,
    so writers that choose a format by it choose the same one), a directory
    ``scenes`` -> ``scenes.partial``."""
    root, ext = os.path.splitext(str(path))
    return root + _PARTIAL + ext


def publish(staged: str, final: str) -> str:
    """Move a finished job's staged output to its final name; returns it.
    A staged directory's entries move into the final directory. Without
    ffmpeg the video writers fall back to ``.y4m`` under the same stem; that
    file moves to the final stem with ``.y4m``."""
    if os.path.isdir(staged):
        os.makedirs(final, exist_ok=True)
        for name in os.listdir(staged):
            os.replace(os.path.join(staged, name), os.path.join(final, name))
        os.rmdir(staged)
        return final
    if not os.path.exists(staged):
        y4m = os.path.splitext(staged)[0] + ".y4m"
        if os.path.exists(y4m):
            staged, final = y4m, os.path.splitext(final)[0] + ".y4m"
    os.replace(staged, final)
    return final


@dataclasses.dataclass
class Job:
    id: int
    kind: str
    params: dict
    status: str = "queued"  # queued|running|paused|done|error|cancelled
    progress: dict = dataclasses.field(default_factory=dict)
    output: str | None = None
    error: str | None = None
    created: float = dataclasses.field(default_factory=time.time)
    started: float | None = None
    finished: float | None = None
    # control events (pause set = suspended; the reference's suspend_flag)
    pause_ev: threading.Event = dataclasses.field(
        default_factory=threading.Event, repr=False)
    cancel_ev: threading.Event = dataclasses.field(
        default_factory=threading.Event, repr=False)
    # (staged, final) output names, from stage()
    staged: tuple[str, str] | None = dataclasses.field(default=None, repr=False)

    def stage(self, output) -> str:
        """The name to write ``output`` under while the job runs; the
        manager publishes it as ``output`` when the job is done."""
        staged = staging_path(output)
        self.staged = (staged, str(output))
        return staged

    def cancel_check(self, poll_s: float = 0.2) -> Callable[[], bool]:
        """A pipelines-compatible ``cancel_check``: returns True to stop,
        blocks while paused (suspension IS the callback not returning, the
        contract of ``utils.observability.make_control_check``)."""

        def check() -> bool:
            while True:
                if self.cancel_ev.is_set():
                    return True
                if not self.pause_ev.is_set():
                    return False
                if self.status == "running":
                    self.status = "paused"
                time.sleep(poll_s)

        return check

    def snapshot(self) -> dict:
        return {
            "id": self.id, "kind": self.kind, "status": self.status,
            "params": dict(self.params),
            "progress": dict(self.progress), "output": self.output,
            "error": self.error, "created": self.created,
            "started": self.started, "finished": self.finished,
        }


class JobManager:
    """FIFO of long operations, one worker thread (see module docstring).

    ``runners`` maps job.kind -> callable(job) -> output path (or None).
    A runner reports progress by mutating ``job.progress``, honors
    ``job.cancel_check()`` and writes under ``job.stage(output)``; raising
    marks the job failed.
    """

    def __init__(self, runners: dict[str, Callable[[Job], Any]]):
        self._runners = runners
        self._jobs: list[Job] = []
        self._ids = itertools.count(1)
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._stop = False
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name="vd3d-jobs")
        self._worker.start()
        # a manager still running at interpreter exit cancels its jobs first
        ref = weakref.ref(self)

        def at_exit():
            manager = ref()
            if manager is not None:
                manager.shutdown()

        self._atexit = at_exit
        atexit.register(at_exit)

    # -- API used by the HTTP layer ------------------------------------
    def submit(self, kind: str, params: dict) -> Job:
        if kind not in self._runners:
            raise ValueError(f"unknown job kind: {kind!r}")
        job = Job(next(self._ids), kind, params)
        with self._lock:
            if self._stop:
                raise RuntimeError("the job manager is shut down")
            self._jobs.append(job)
        self._wake.set()
        return job

    def get(self, job_id: int) -> Job | None:
        with self._lock:
            for j in self._jobs:
                if j.id == job_id:
                    return j
        return None

    def control(self, job_id: int, action: str) -> bool:
        job = self.get(job_id)
        if job is None:
            return False
        if action == "pause":
            job.pause_ev.set()
        elif action == "resume":
            job.pause_ev.clear()
            if job.status == "paused":
                job.status = "running"
        elif action == "cancel":
            job.cancel_ev.set()
            job.pause_ev.clear()  # unblock a paused job so it can exit
            with self._lock:  # the worker takes queued jobs under the lock
                if job.status == "queued":
                    job.status = "cancelled"
                    job.finished = time.time()
        else:
            raise ValueError(f"unknown action: {action!r}")
        return True

    def snapshot(self) -> list[dict]:
        with self._lock:
            return [j.snapshot() for j in self._jobs]

    def shutdown(self, timeout: float | None = 60.0) -> bool:
        """Take no more jobs, cancel the queued and the running one, and wait
        up to ``timeout`` s for the worker; returns whether it stopped. A
        cancelled job keeps its staged output (``.partial``)."""
        with self._lock:
            self._stop = True
            jobs = list(self._jobs)
        for j in jobs:
            if j.status in ("queued", "running", "paused"):
                self.control(j.id, "cancel")
        self._wake.set()
        atexit.unregister(self._atexit)
        if threading.current_thread() is not self._worker:
            self._worker.join(timeout)
        return not self._worker.is_alive()

    # -- worker ---------------------------------------------------------
    def _take_queued(self) -> Job | None:
        with self._lock:
            for j in self._jobs:
                if j.status == "queued":
                    j.status = "running"
                    j.started = time.time()
                    return j
        return None

    def _run(self) -> None:
        while not self._stop:
            job = self._take_queued()
            if job is None:
                self._wake.wait(timeout=0.2)
                self._wake.clear()
                continue
            try:
                out = self._runners[job.kind](job)
                if job.cancel_ev.is_set():
                    job.status = "cancelled"
                    if job.staged is not None and os.path.exists(job.staged[0]):
                        job.output = job.staged[0]  # what was done before the cancel
                else:
                    if job.staged is not None:
                        out = publish(*job.staged)
                    if out is not None:
                        job.output = str(out)
                    job.status = "done"
            except Exception as e:  # surfaced in the UI, like the
                job.status = "error"  # reference's crash log excepthook
                job.error = f"{type(e).__name__}: {e}"
                job.progress["traceback"] = traceback.format_exc(limit=8)
            finally:
                job.finished = time.time()
