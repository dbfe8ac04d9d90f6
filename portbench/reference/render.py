"""One chunk of the fused 2D -> 3D render, plainly: YUV420 planes in,
the depth the model gives and the packed Full-SBS YUV420 planes out.

The chunk: the planes decoded to RGB, centre-cropped to the target aspect,
depth from Depth Anything on the cropped frames (resized to the eye), the
frames resized to the eye, the stereo step frame by frame with the
trackers carried, each eye letterboxed to the per-eye size, the eyes side
by side, rounded to u8 (half to even) and converted to YUV420.
"""

from __future__ import annotations

import dataclasses

import torch

from . import convert, depth_anything, resize, stereo
from .precision import Mat


@dataclasses.dataclass(frozen=True)
class Geometry:
    crop_x: int
    crop_y: int
    crop_w: int
    crop_h: int
    eye_w: int
    eye_h: int
    warp_w: int
    warp_h: int
    per_eye_w: int
    per_eye_h: int
    out_w: int
    out_h: int


def full_sbs_geometry(src_w: int, src_h: int, output_height: int = 1080,
                      preserve_aspect: bool = False, ratio: float = 16 / 9) -> Geometry:
    """The Full-SBS sizes of a render (the upstream render loop's rules):
    a centre crop to the 16:9 target when the source is off by more than
    1 %; with the source's aspect kept, the eye and the warp at the source
    size and the output two sources wide; without, the warp at
    ``output_height`` rows, the eye 1920 wide and the output 3840 x 1080."""
    crop_x, crop_y, crop_w, crop_h = 0, 0, src_w, src_h
    if abs(src_w / src_h - ratio) > 0.01:
        if src_w / src_h > ratio:
            crop_w = int(src_h * ratio)
            crop_x = (src_w - crop_w) // 2
        else:
            crop_h = int(src_w / ratio)
            crop_y = (src_h - crop_h) // 2
    if preserve_aspect:
        warp_w, warp_h = src_w, src_h
        per_eye_w, per_eye_h = src_w, src_h
        out_w, out_h = 2 * src_w, src_h
        eye_w, eye_h = per_eye_w, per_eye_h
    else:
        warp_h = output_height
        warp_w = int(warp_h * ratio)
        warp_w += warp_w % 2
        per_eye_w, per_eye_h = 1920, 1080
        out_w, out_h = 3840, 1080
        eye_w = per_eye_w
        eye_h = int(per_eye_w / ratio)
        eye_h += eye_h % 2
    return Geometry(crop_x, crop_y, crop_w, crop_h, eye_w, eye_h, warp_w, warp_h,
                    per_eye_w, per_eye_h, out_w, out_h)


def source(geom: Geometry, y: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """[T, H, W] / [T, H/2, W/2] uint8 planes -> the cropped frames, RGB in
    [0, 1], [T, crop_h, crop_w, 3]."""
    frames = convert.yuv420_to_rgb_u8(y, u, v).to(torch.float32) / 255.0
    return frames[:, geom.crop_y: geom.crop_y + geom.crop_h,
                  geom.crop_x: geom.crop_x + geom.crop_w]


def depth_of(mm: Mat, sd: dict, mcfg: dict, size: int, geom: Geometry,
             frames: torch.Tensor) -> torch.Tensor:
    """The model's depth of the cropped frames at the eye size, [T, eye_h, eye_w]."""
    return depth_anything.predict_01(mm, sd, mcfg, frames, size, (geom.eye_h, geom.eye_w))


def carry(trackers: dict, depth: torch.Tensor) -> dict:
    """The temporal depth filter over a chunk's depth: the trackers'
    ``initialized`` and ``prev_depth`` after it (all the stage's other
    trackers need the whole step)."""
    t = {"initialized": trackers["initialized"], "prev_depth": trackers["prev_depth"]}
    for d in depth:
        t = {"initialized": torch.ones_like(t["initialized"]), "prev_depth": stereo.smoothed(t, d)}
    return t


def chunk(mm: Mat, p: stereo.Params, sd: dict, mcfg: dict, size: int, geom: Geometry,
          trackers: dict, y: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
          depth: torch.Tensor | None = None):
    """[T, H, W] / [T, H/2, W/2] uint8 planes -> (trackers, depth01 [T, eye_h,
    eye_w], (Y, U, V) of the packed output). With ``depth`` given, the
    stereo stage runs on it and the model does not run."""
    frames = source(geom, y, u, v)
    if depth is None:
        depth = depth_of(mm, sd, mcfg, size, geom, frames)
    frames = resize.bilinear(mm, frames, (geom.eye_h, geom.eye_w), hwc=True)
    packed = []
    for i in range(frames.shape[0]):
        trackers, left, right = stereo.frame_step(p, mm, trackers, frames[i], depth[i],
                                                  (geom.warp_h, geom.warp_w))
        left = resize.letterbox(mm, left, geom.per_eye_w, geom.per_eye_h)
        right = resize.letterbox(mm, right, geom.per_eye_w, geom.per_eye_h)
        packed.append(torch.cat([left, right], dim=1))
    out = convert.u8_round(torch.stack(packed))
    return trackers, depth, convert.rgb_u8_to_yuv420(out)
