"""Batch rendering queues.

The port's copy of ``visiondepth3d_tpu/pipeline/batch.py``: the reference's
3D-tab batch pairs video and depth listboxes and renders them in turn
(VisionDepth3D.py:2439-2470). A work queue with per-item progress,
cooperative cancel and continue-on-error.
"""

from __future__ import annotations

import dataclasses
import time
from pathlib import Path
from typing import Callable

from ..stereo import StereoParams
from .stereo_pipeline import RenderConfig, render_stereo_video


@dataclasses.dataclass
class BatchItem:
    input_path: str
    depth_path: str
    output_path: str
    status: str = "pending"  # pending | running | done | error | cancelled
    error: str | None = None
    frames: int = 0
    seconds: float = 0.0


def pair_videos_with_depth(video_dir, depth_dir, out_dir,
                           depth_suffix: str = "_depth") -> list[BatchItem]:
    """Pair <name>.<ext> with <name><suffix>.* like the batch tab's paired
    listboxes; unmatched videos are skipped."""
    video_dir, depth_dir, out_dir = Path(video_dir), Path(depth_dir), Path(out_dir)
    items = []
    depth_by_stem = {p.stem: p for p in depth_dir.iterdir() if p.is_file()}
    exts = (".y4m", ".mp4", ".mkv", ".avi", ".mov", ".webm")
    video_stems = {p.stem for p in video_dir.iterdir()
                   if p.is_file() and p.suffix.lower() in exts}
    for v in sorted(video_dir.iterdir()):
        if not v.is_file() or v.suffix.lower() not in exts:
            continue
        if (v.stem.endswith(depth_suffix)
                and v.stem[: -len(depth_suffix)] in video_stems):
            continue  # another video's depth sidecar sharing the dir
        d = depth_by_stem.get(v.stem + depth_suffix) or depth_by_stem.get(v.stem)
        if d is None or d.resolve() == v.resolve():
            continue
        items.append(BatchItem(str(v), str(d), str(out_dir / (v.stem + "_3D.y4m"))))
    return items


def run_batch(
    items: list[BatchItem],
    params: StereoParams | None = None,
    cfg: RenderConfig | None = None,
    progress_cb: Callable | None = None,
    cancel_check: Callable[[], bool] | None = None,
) -> list[BatchItem]:
    """Render every item sequentially; errors mark the item and continue."""
    for item in items:
        if cancel_check and cancel_check():
            item.status = "cancelled"
            continue
        item.status = "running"
        t0 = time.time()
        try:
            Path(item.output_path).parent.mkdir(parents=True, exist_ok=True)
            prog = render_stereo_video(
                item.input_path, item.depth_path, item.output_path,
                params, cfg, cancel_check=cancel_check,
            )
            item.frames = prog.frames_done
            item.status = "done"
        except Exception as e:  # continue-on-error like the reference queue
            item.status = "error"
            item.error = f"{type(e).__name__}: {e}"
        item.seconds = time.time() - t0
        if progress_cb:
            progress_cb(item)
    return items
