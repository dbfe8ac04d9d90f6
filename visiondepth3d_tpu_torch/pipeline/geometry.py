"""Output geometry resolution (render_sbs_3d:1074-1138 + 1250-1263 parity).

A copy of ``visiondepth3d_tpu/pipeline/geometry.py``, whose package
imports jax.

Given the source size, the selected aspect ratio, the output format and the
preserve-original-aspect flag, compute every static size the render needs:
center-crop, per-eye target, warp-stage size, and final packed output size.
All of this is host-side Python — the sizes become static shapes in the
jitted render graph.
"""

from __future__ import annotations

import dataclasses

# The GUI's aspect table (VisionDepth3D.py:1460-1475 superset of
# render_3d.py:39-47).
ASPECT_RATIOS = {
    "Default (16:9)": 16 / 9,
    "16:9": 16 / 9,
    "4:3": 4 / 3,
    "1:1": 1.0,
    "2.35:1 (CinemaScope)": 2.35,
    "2.39:1 (Anamorphic)": 2.39,
    "2.76:1 (Ultra Panavision)": 2.76,
    "1.85:1 (Flat)": 1.85,
    "2.00:1 (Univisium)": 2.0,
    "21:9 (UltraWide)": 21 / 9,
    "32:9 (SuperWide)": 32 / 9,
    "1.37:1 (Academy)": 1.37,
    "1.66:1 (European Widescreen)": 1.66,
    "5:4": 5 / 4,
}


def parse_timecode(s) -> float | None:
    """'HH:MM:SS', 'MM:SS' or 'SS' (each part may carry '.ms') -> seconds.

    Spec: the reference's parse_timecode (render_3d.py:77-97) — blank or
    unparseable input returns None (numbers pass through).
    """
    if s is None:
        return None
    if isinstance(s, (int, float)):
        return float(s)
    s = str(s).strip()
    if not s:
        return None
    parts = s.split(":")
    try:
        if len(parts) == 3:
            return (float(parts[0]) * 3600 + float(parts[1]) * 60
                    + float(parts[2]))
        if len(parts) == 2:
            return float(parts[0]) * 60 + float(parts[1])
        return float(s)
    except ValueError:
        return None


def resolve_clip_window(start_s, end_s) -> tuple[float | None, float | None]:
    """Reference clip-window semantics (handle_generate_3d,
    VisionDepth3D.py:1589-1594): accepts seconds or timecode strings;
    ``end <= start`` means END IS A DURATION (Start=00:52:26, End=00:00:30
    renders 30 seconds); a still-degenerate window gets a 1 ms guard."""
    start = parse_timecode(start_s)
    end = parse_timecode(end_s)
    if start is not None and end is not None:
        if end <= start:
            end = start + end
        if end <= start:
            end = start + 0.001
    return start, end


@dataclasses.dataclass(frozen=True)
class RenderGeometry:
    src_w: int
    src_h: int
    crop_x: int  # center crop to target aspect (render_3d.py:1236-1248)
    crop_y: int
    crop_w: int
    crop_h: int
    eye_w: int  # per-frame resize target before the warp (:1250-1263)
    eye_h: int
    warp_w: int  # pixel_shift-internal resize (:595-596, fed resized_w/h)
    warp_h: int
    per_eye_w: int  # packing geometry (:1086-1138)
    per_eye_h: int
    out_w: int
    out_h: int


def resolve_geometry(
    src_w: int,
    src_h: int,
    output_format: str = "Full-SBS",
    output_height: int = 1080,
    aspect: str = "Default (16:9)",
    preserve_original_aspect: bool = False,
    crop_black_top: int = 0,
    crop_black_bottom: int = 0,
) -> RenderGeometry:
    target_ratio = ASPECT_RATIOS.get(aspect, 16 / 9)

    # black-bar crop first (render loop applies it before the aspect crop)
    h = src_h - crop_black_top - crop_black_bottom
    w = src_w
    crop_y0, crop_h = crop_black_top, h

    # center-crop to the target aspect when off by > 1%
    current_ratio = w / h
    crop_x0, crop_w = 0, w
    if abs(current_ratio - target_ratio) > 0.01:
        if current_ratio > target_ratio:
            new_w = int(h * target_ratio)
            crop_x0, crop_w = (w - new_w) // 2, new_w
        else:
            new_h = int(w / target_ratio)
            crop_y0, crop_h = crop_y0 + (h - new_h) // 2, new_h

    if preserve_original_aspect:
        resized_w, resized_h = src_w, src_h
        if output_format == "Full-SBS":
            per_eye_w, per_eye_h = resized_w, resized_h
            out_w, out_h = per_eye_w * 2, per_eye_h
        elif output_format == "Half-SBS":
            per_eye_w, per_eye_h = resized_w // 2, resized_h
            out_w, out_h = resized_w, resized_h
        elif output_format == "VR":
            per_eye_w, per_eye_h = 1440, 1600
            out_w, out_h = 2880, 1600
        else:
            per_eye_w, per_eye_h = resized_w, resized_h
            out_w, out_h = resized_w * 2, resized_h
        eye_w, eye_h = per_eye_w, per_eye_h
    else:
        resized_h = output_height
        resized_w = int(resized_h * target_ratio)
        if resized_w % 2 != 0:
            resized_w += 1
        if output_format == "Full-SBS":
            per_eye_w, per_eye_h = 1920, 1080
            out_w, out_h = 3840, 1080
        elif output_format == "Half-SBS":
            per_eye_w, per_eye_h = resized_w // 2, resized_h
            out_w, out_h = resized_w, resized_h
        elif output_format == "VR":
            per_eye_w, per_eye_h = 1440, 1600
            out_w, out_h = 2880, 1600
        else:
            per_eye_w, per_eye_h = resized_w, resized_h
            out_w, out_h = resized_w * 2, resized_h
        eye_w = per_eye_w
        eye_h = int(per_eye_w / target_ratio)
        if eye_h % 2 != 0:
            eye_h += 1

    # packed widths for the single-image formats
    if output_format in ("Red-Cyan Anaglyph", "Passive Interlaced"):
        out_w, out_h = per_eye_w, per_eye_h

    return RenderGeometry(
        src_w=src_w,
        src_h=src_h,
        crop_x=crop_x0,
        crop_y=crop_y0,
        crop_w=crop_w,
        crop_h=crop_h,
        eye_w=eye_w,
        eye_h=eye_h,
        warp_w=resized_w,
        warp_h=resized_h,
        per_eye_w=per_eye_w,
        per_eye_h=per_eye_h,
        out_w=out_w,
        out_h=out_h,
    )
