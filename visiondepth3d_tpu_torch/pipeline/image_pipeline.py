"""Single-image and folder depth pipelines, and the frames-folder tools.

The port of ``visiondepth3d_tpu/pipeline/image_pipeline.py``. Reference
analogs: ``process_image`` (render_depth.py:1353-1476: one image, with a
matplotlib colormap or a 16-bit export) and ``process_images_in_folder``
(:1229-1339: a batched folder loop with natural sort and FPS/ETA), plus
folder-of-videos batching (:1573-1634). The predictor runs on its device
(the card unless it was built for the CPU).

Images are read and written through Pillow, as the JAX package reads and
writes them, and a colormap needs matplotlib; each is imported where it is
used, and a missing one raises an ImportError that names the package.
"""

from __future__ import annotations

import re
from pathlib import Path

import numpy as np
import torch

from ..utils.observability import FpsMeter

IMAGE_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".webp")


def _pil():
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError("the image tools need Pillow, which is not installed") from e
    return Image


def natural_sort_key(name: str):
    """Natural sort (render_depth.py:1566-1571): frame_10 after frame_9."""
    return [int(t) if t.isdigit() else t.lower() for t in re.split(r"(\d+)", str(name))]


def _load_rgb_u8(path) -> np.ndarray:
    """An image file -> [H, W, 3] uint8 RGB."""
    return np.asarray(_pil().open(path).convert("RGB"))


def load_image01(path) -> np.ndarray:
    return _load_rgb_u8(path).astype(np.float32) / 255.0


def _save(path, arr: np.ndarray) -> None:
    """[H, W] uint8 (``L``), [H, W] uint16 (``I;16``) or [H, W, 3] uint8."""
    Image = _pil()
    if arr.dtype == np.uint16:
        Image.frombytes("I;16", arr.shape[::-1], arr.astype("<u2").tobytes()).save(path)
    else:
        Image.fromarray(arr).save(path)


def save_depth_image(depth01: np.ndarray, path, colormap: str | None = None,
                     bits: int = 8, invert: bool = False) -> None:
    """Save a [H, W] depth map: grayscale 8/16-bit or a matplotlib colormap."""
    d = 1.0 - depth01 if invert else depth01
    if colormap and colormap.lower() not in ("", "none", "gray", "grey"):
        try:
            import matplotlib
        except ImportError as e:
            raise ImportError("a depth colormap needs matplotlib, which is not installed "
                              "(gray 8/16-bit output does not)") from e
        rgba = matplotlib.colormaps[colormap](np.clip(d, 0, 1))
        _save(path, (rgba[..., :3] * 255).astype(np.uint8))
    elif bits == 16:
        _save(path, np.clip(d * 65535.0 + 0.5, 0, 65535).astype(np.uint16))
    else:
        _save(path, np.clip(d * 255.0 + 0.5, 0, 255).astype(np.uint8))


def _predict(predictor, batch: np.ndarray, out_hw) -> np.ndarray:
    return predictor.predict_01(torch.from_numpy(batch), out_hw=out_hw).float().cpu().numpy()


def process_image(input_path, output_path, predictor, colormap=None,
                  bits: int = 8, invert: bool = False) -> None:
    img = load_image01(input_path)
    d = _predict(predictor, img[None], img.shape[:2])[0]
    save_depth_image(d, output_path, colormap, bits, invert)


def process_images_in_folder(
    folder, out_folder, predictor, batch_size: int = 8, colormap=None,
    bits: int = 8, invert: bool = False, progress_cb=None,
    cancel_check=None,
) -> int:
    """Depth of every image in ``folder`` (natural order) as
    ``<stem>_depth.png`` in ``out_folder``; each batch is zero-padded to its
    largest image, as the JAX package pads it. Returns the image count."""
    folder, out_folder = Path(folder), Path(out_folder)
    out_folder.mkdir(parents=True, exist_ok=True)
    files = sorted(
        (p for p in folder.iterdir() if p.suffix.lower() in IMAGE_EXTS),
        key=lambda p: natural_sort_key(p.name),
    )
    meter = FpsMeter(total=len(files))
    done = 0
    for i in range(0, len(files), batch_size):
        if cancel_check and cancel_check():
            break
        chunk = files[i : i + batch_size]
        imgs = [load_image01(p) for p in chunk]
        h = max(im.shape[0] for im in imgs)
        w = max(im.shape[1] for im in imgs)
        batch = np.zeros((len(imgs), h, w, 3), np.float32)
        for j, im in enumerate(imgs):
            batch[j, : im.shape[0], : im.shape[1]] = im
        depths = _predict(predictor, batch, (h, w))
        for p, im, d in zip(chunk, imgs, depths):
            save_depth_image(
                d[: im.shape[0], : im.shape[1]],
                out_folder / (p.stem + "_depth.png"),
                colormap, bits, invert,
            )
        done += len(chunk)
        meter.tick(len(chunk))
        if progress_cb:
            progress_cb(meter)
    return done


def process_videos_in_folder(folder, out_folder, depth_cfg=None,
                             progress_cb=None, predictor=None) -> list:
    """Natural-sorted batch depth over every video in a folder
    (render_depth.py:1573-1634 analog)."""
    from .depth_pipeline import DepthConfig, render_depth_video_file

    folder, out_folder = Path(folder), Path(out_folder)
    out_folder.mkdir(parents=True, exist_ok=True)
    vids = sorted(
        (p for p in folder.iterdir() if p.suffix.lower() in (".y4m", ".mp4",
                                                             ".mkv", ".avi",
                                                             ".mov", ".webm")),
        key=lambda p: natural_sort_key(p.name),
    )
    cfg = depth_cfg or DepthConfig()
    results = []
    for v in vids:
        out = out_folder / (v.stem + "_depth.y4m")
        n = render_depth_video_file(v, out, cfg, progress_cb,
                                    predictor=predictor)
        results.append((v, out, n))
    return results


def extract_frames(video_path, out_dir, fmt: str = "png", step: int = 1,
                   progress_cb=None) -> int:
    """Video -> ``frame_%05d.<fmt>`` folder (the FrameTools extract step,
    merged_pipeline.py:109-173). ``step`` keeps every Nth frame."""
    from ..io.video import open_video

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    n = 0
    with open_video(video_path) as rd:
        for i, f in enumerate(rd):
            if i % step:
                continue
            _save(out_dir / f"frame_{n:05d}.{fmt}", f)
            n += 1
            if progress_cb:
                progress_cb(n)
    return n


def assemble_frames(folder, output_path, fps: float = 24.0,
                    progress_cb=None) -> int:
    """Natural-sorted frames folder -> video (the merged-pipeline writer
    leg, merged_pipeline.py:287-387, minus the enhance stages)."""
    from ..io.video import open_writer

    folder = Path(folder)
    frames = sorted(
        (p for p in folder.iterdir() if p.suffix.lower() in IMAGE_EXTS),
        key=lambda p: natural_sort_key(p.name),
    )
    if not frames:
        raise ValueError(f"no image frames in {folder}")
    first = _load_rgb_u8(frames[0])
    h, w = first.shape[:2]
    wr = open_writer(output_path, w, h, fps)
    n = 0
    try:
        for p in frames:
            arr = _load_rgb_u8(p)
            if arr.shape[:2] != (h, w):
                raise ValueError(
                    f"{p.name}: size {arr.shape[1]}x{arr.shape[0]} != "
                    f"{w}x{h} of the first frame"
                )
            wr.write(arr)
            n += 1
            if progress_cb:
                progress_cb(n)
    finally:
        wr.close()
    return n
