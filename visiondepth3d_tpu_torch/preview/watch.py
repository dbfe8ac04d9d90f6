"""Interactive live preview: a debounced file-watch loop.

Counterpart of ``visiondepth3d_tpu/preview/watch.py``. The reference's
preview window (preview_gui.py:41-669) binds Tk sliders to StereoParams
fields and re-renders one frame through the real engine with a 150 ms
debounce (preview_gui.py:154-158). Here a *session file* is the control
surface:

- ``vd3d-torch preview --watch session.json`` writes a template holding
  every StereoParams field + ``mode`` + ``frame`` (the tool seeds it with
  the current values; the user edits any field in an editor, and each save
  is a "slider drag");
- the loop polls the file's mtime, debounces rapid saves, re-reads the
  params, re-seeks the clip if ``frame`` changed, and re-renders the
  preview PNG set through the real ``stereo_frame_step``;
- ``"quit": true`` (or Ctrl-C) ends the session.

The session file is the preset format of ``config/presets.py``, so either
package reads a session the other wrote.
"""

from __future__ import annotations

import json
import time
from pathlib import Path

import numpy as np

from ..config.presets import params_from_dict, params_to_dict
from ..device import DEFAULT_DEVICE
from ..stereo import StereoParams
from .diagnostics import PREVIEW_MODES, save_preview_set


def _load_frame_pair(input_path, depth_path, frame_idx: int):
    """Decode frame ``frame_idx`` of the clip + its depth frame."""
    from ..io.depth_io import open_depth_reader
    from ..io.video import open_video

    with open_video(input_path) as rd:
        frame = None
        for _ in range(frame_idx + 1):
            frame = rd.read()
        if frame is None:
            raise ValueError(f"clip has fewer than {frame_idx + 1} frames")
    dd = open_depth_reader(depth_path)
    try:
        depth = None
        for _ in range(frame_idx + 1):
            depth = dd.read()
        if depth is None:
            raise ValueError(f"depth has fewer than {frame_idx + 1} frames")
    finally:
        dd.close()
    return frame.astype(np.float32) / 255.0, depth


def write_session_template(path, params: StereoParams | None = None,
                           mode: str = "sbs", frame: int = 0) -> None:
    """Seed the control file with the full parameter surface."""
    d = params_to_dict(params or StereoParams())
    d.update({"mode": mode, "frame": frame, "quit": False})
    Path(path).write_text(json.dumps(d, indent=2, sort_keys=True))


def _read_session(path) -> tuple[StereoParams, str, int, bool] | None:
    try:
        d = json.loads(Path(path).read_text())
    except (json.JSONDecodeError, OSError):
        return None  # mid-save / editor swap file: treat as "no change yet"
    mode = d.pop("mode", "sbs")
    frame = int(d.pop("frame", 0))
    quit_ = bool(d.pop("quit", False))
    if mode not in PREVIEW_MODES:
        mode = "sbs"
    params, _ = params_from_dict(d)
    return params, mode, frame, quit_


def watch_preview(input_path, depth_path, session_path, out_dir, poll_s: float = 0.1,
                  debounce_s: float = 0.15, max_renders: int | None = None,
                  status_cb=None, device=DEFAULT_DEVICE) -> int:
    """Run the debounced watch loop; returns the number of renders.

    ``max_renders`` bounds the loop for tests and scripts; interactive use
    runs until ``quit`` or KeyboardInterrupt. ``device`` goes to every
    render (the CUDA card unless "cpu" is passed).
    """
    session_path = Path(session_path)
    if not session_path.exists():
        write_session_template(session_path)
    n_renders = 0
    last_mtime = -1.0
    cached = (None, None, -1)  # frame01, depth01, frame_idx

    def render_once() -> bool:
        nonlocal n_renders, cached
        sess = _read_session(session_path)
        if sess is None:
            return False
        params, mode, frame_idx, quit_ = sess
        if quit_:
            return True
        if cached[2] != frame_idx:
            f01, d01 = _load_frame_pair(input_path, depth_path, frame_idx)
            cached = (f01, d01, frame_idx)
        t0 = time.perf_counter()
        save_preview_set(cached[0], cached[1], out_dir, params, mode, device)
        n_renders += 1
        dt = time.perf_counter() - t0
        msg = (f"render #{n_renders}: frame {frame_idx} mode {mode} "
               f"({dt * 1000:.0f} ms)")
        (status_cb or print)(msg)
        return False

    try:
        while True:
            mtime = session_path.stat().st_mtime if session_path.exists() else -1
            if mtime != last_mtime:
                # debounce: wait for the file to go quiet (rapid consecutive
                # saves = one render), preview_gui.py:154-158
                while True:
                    time.sleep(debounce_s)
                    m2 = session_path.stat().st_mtime
                    if m2 == mtime:
                        break
                    mtime = m2
                last_mtime = mtime
                if render_once():
                    break
            if max_renders is not None and n_renders >= max_renders:
                break
            time.sleep(poll_s)
    except KeyboardInterrupt:
        pass
    return n_renders
