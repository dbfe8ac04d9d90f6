"""Image resampling as separable matrix products.

Counterpart of ``visiondepth3d_tpu/ops/resize.py``: the same (out, in)
weight matrices, built once in numpy (f64 construction, f32 storage) and
applied with ``torch.einsum``. ``F.interpolate`` is not used: its border
handling and bicubic taps differ from these matrices, and the port is held
to the JAX package's numerics.

- ``bilinear``, ``align_corners=False``: src = (dst + 0.5) * s - 0.5,
  clamped to [0, in - 1].
- ``bilinear``, ``align_corners=True``: src = dst * (in - 1) / (out - 1).
- ``area``: box integration of [dst * s, (dst + 1) * s) when shrinking,
  bilinear when growing.
- ``bicubic``: a = -0.75, edge-replicated taps (position-embedding regrid).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=256)
def _linear_matrix(in_size: int, out_size: int, align_corners: bool) -> np.ndarray:
    """(out_size, in_size) bilinear interpolation weights."""
    m = np.zeros((out_size, in_size), dtype=np.float32)
    if in_size == 1:
        m[:, 0] = 1.0
        return m
    if out_size == 1 and align_corners:
        m[0, 0] = 1.0
        return m
    dst = np.arange(out_size, dtype=np.float64)
    if align_corners:
        src = dst * (in_size - 1) / max(out_size - 1, 1)
    else:
        src = (dst + 0.5) * (in_size / out_size) - 0.5
        src = np.clip(src, 0.0, in_size - 1)
    x0 = np.clip(np.floor(src).astype(np.int64), 0, in_size - 1)
    x1 = np.clip(x0 + 1, 0, in_size - 1)
    w = src - x0
    rows = dst.astype(np.int64)
    m[rows, x0] += (1.0 - w).astype(np.float32)
    np.add.at(m, (rows, x1), w.astype(np.float32))  # x1 == x0 at the border
    return m


@functools.lru_cache(maxsize=256)
def _area_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(out_size, in_size) box-integration weights (cv2.INTER_AREA shrink)."""
    if out_size >= in_size:
        return _linear_matrix(in_size, out_size, False)
    m = np.zeros((out_size, in_size), dtype=np.float64)
    scale = in_size / out_size
    for o in range(out_size):
        a, b = o * scale, (o + 1) * scale
        for i in range(int(np.floor(a)), min(int(np.ceil(b)), in_size)):
            overlap = min(b, i + 1) - max(a, i)
            if overlap > 0:
                m[o, i] = overlap
    return (m / scale).astype(np.float32)


def _cubic_weight(x: np.ndarray, a: float = -0.75) -> np.ndarray:
    ax = np.abs(x)
    return np.where(
        ax <= 1,
        (a + 2) * ax**3 - (a + 3) * ax**2 + 1,
        np.where(ax < 2, a * ax**3 - 5 * a * ax**2 + 8 * a * ax - 4 * a, 0.0),
    )


@functools.lru_cache(maxsize=64)
def _cubic_matrix(in_size: int, out_size: int, align_corners: bool) -> np.ndarray:
    """(out, in) bicubic weights, torch bicubic parity (a = -0.75)."""
    m = np.zeros((out_size, in_size), dtype=np.float64)
    dst = np.arange(out_size, dtype=np.float64)
    if align_corners:
        src = dst * (in_size - 1) / max(out_size - 1, 1)
    else:
        src = (dst + 0.5) * (in_size / out_size) - 0.5
    x0 = np.floor(src).astype(np.int64)
    t = src - x0
    for tap in (-1, 0, 1, 2):
        idx = np.clip(x0 + tap, 0, in_size - 1)
        np.add.at(m, (dst.astype(np.int64), idx), _cubic_weight(tap - t))
    return m.astype(np.float32)


@functools.lru_cache(maxsize=64)
def _matrix(kind: str, in_size: int, out_size: int, align_corners: bool,
            dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """The weight matrix as a tensor on ``device``, built once per shape; a
    normal tensor even when first asked for under inference mode, so a
    training step may use it after an inference call made it."""
    if kind == "linear":
        m = _linear_matrix(in_size, out_size, align_corners)
    elif kind == "cubic":
        m = _cubic_matrix(in_size, out_size, align_corners)
    else:
        m = _area_matrix(in_size, out_size)
    with torch.inference_mode(False):
        return torch.from_numpy(m).to(device=device, dtype=dtype)


def _is_channel_last(img: torch.Tensor, channel_last: bool | None) -> bool:
    if channel_last is not None:
        return channel_last
    # a trailing axis of <= 4 is a color channel ([H, W, 3]); anything else
    # is spatial-last ([H, W], [T, H, W])
    return img.ndim >= 3 and img.shape[-1] <= 4


def _spatial_shape(img: torch.Tensor, hwc: bool) -> tuple[int, int]:
    return (img.shape[-3], img.shape[-2]) if hwc else (img.shape[-2], img.shape[-1])


def _apply(img: torch.Tensor, kind: str, out_hw, align_corners: bool,
           hwc: bool) -> torch.Tensor:
    h, w = _spatial_shape(img, hwc)
    oh, ow = out_hw
    rh = _matrix(kind, h, oh, align_corners, img.dtype, img.device)
    rw = _matrix(kind, w, ow, align_corners, img.dtype, img.device)
    if hwc:
        out = torch.einsum("oh,...hwc->...owc", rh, img)
        return torch.einsum("pw,...owc->...opc", rw, out)
    out = torch.einsum("oh,...hw->...ow", rh, img)
    return torch.einsum("pw,...ow->...op", rw, out)


def resize_bilinear(img: torch.Tensor, out_hw, align_corners: bool = False,
                    channel_last: bool | None = None) -> torch.Tensor:
    """Bilinear resize to out_hw. ``channel_last``: True for [..., H, W, C],
    False for [..., H, W] (NCHW batches included); None auto-detects."""
    hwc = _is_channel_last(img, channel_last)
    if _spatial_shape(img, hwc) == tuple(out_hw):
        return img
    return _apply(img, "linear", out_hw, align_corners, hwc)


def source_rows(in_size: int, out_size: int, rows: tuple[int, int],
                align_corners: bool = False) -> tuple[int, int]:
    """[a, b): the source rows that output rows ``rows`` = [r0, r1) of a
    bilinear resize from ``in_size`` to ``out_size`` rows read (the support
    of those rows of its weight matrix)."""
    r0, r1 = rows
    if in_size == out_size:
        return r0, r1
    used = np.nonzero(_linear_matrix(in_size, out_size, align_corners)[r0:r1].any(axis=0))[0]
    return int(used[0]), int(used[-1]) + 1


def resize_bilinear_rows(src: torch.Tensor, in_size: int, out_hw, rows: tuple[int, int],
                         src0: int, align_corners: bool = False,
                         channel_last: bool | None = None) -> torch.Tensor:
    """Output rows ``rows`` = [r0, r1) of ``resize_bilinear(frame, out_hw)``
    for a frame ``in_size`` rows high, from ``src``: its rows [src0, src0 +
    src rows), which must cover ``source_rows`` of those rows. Each output
    row is the same weighted sum of the same source rows as in the whole
    frame's resize (the band of the row matrix, the whole column matrix)."""
    hwc = _is_channel_last(src, channel_last)
    _, w = _spatial_shape(src, hwc)
    r0, r1 = rows
    oh, ow = out_hw
    a, b = source_rows(in_size, oh, rows, align_corners)
    if a < src0 or b > src0 + _spatial_shape(src, hwc)[0]:
        raise ValueError(f"rows [{r0}, {r1}) read source rows [{a}, {b}); got [{src0}, "
                         f"{src0 + _spatial_shape(src, hwc)[0]})")
    h_axis = src.ndim - 3 if hwc else src.ndim - 2
    src = src.narrow(h_axis, a - src0, b - a)
    # einsum squeezes an axis of one and then takes another GEMM than the
    # whole frame's, which can round otherwise: a one-row band is computed
    # as that row twice
    twice = r1 - r0 == 1 and oh > 1
    if in_size != oh:
        rh = _matrix("linear", in_size, oh, align_corners, src.dtype, src.device)[r0:r1, a:b]
        rh = rh.expand(2, -1) if twice else rh
        src = torch.einsum("oh,...hwc->...owc" if hwc else "oh,...hw->...ow", rh, src)
    elif twice:
        src = torch.cat([src, src], dim=h_axis)
    if w != ow:
        rw = _matrix("linear", w, ow, align_corners, src.dtype, src.device)
        src = torch.einsum("pw,...owc->...opc" if hwc else "pw,...ow->...op", rw, src)
    return src.narrow(h_axis, 0, 1) if twice else src


def resize_bicubic(img: torch.Tensor, out_hw, align_corners: bool = False,
                   channel_last: bool | None = None) -> torch.Tensor:
    """Bicubic resize (ViT position-embedding regrid)."""
    hwc = _is_channel_last(img, channel_last)
    if _spatial_shape(img, hwc) == tuple(out_hw):
        return img
    return _apply(img, "cubic", out_hw, align_corners, hwc)


# Above this many weight-matrix elements the JAX package's resize_area
# switches from the area matrix to integer-factor box pooling or a 2-tap
# bilinear gather (``_MATRIX_LIMIT`` in visiondepth3d_tpu/ops/resize.py);
# the port makes the same switch at the same sizes, so both give the same
# pixels.
_MATRIX_LIMIT = 1 << 18


def _gather_axis_linear(img: torch.Tensor, out_size: int, axis: int,
                        align_corners: bool) -> torch.Tensor:
    """Bilinear resample along one axis with runtime indices, positions in
    float32 as the JAX package computes them."""
    in_size = img.shape[axis]
    if in_size == 1:
        reps = [1] * img.ndim
        reps[axis] = out_size
        return img.repeat(reps)
    dst = torch.arange(out_size, dtype=torch.float32, device=img.device)
    if align_corners:
        src = dst * ((in_size - 1) / max(out_size - 1, 1))
    else:
        src = torch.clamp((dst + 0.5) * (in_size / out_size) - 0.5, 0.0, in_size - 1)
    x0 = torch.clamp(torch.floor(src).to(torch.int64), 0, in_size - 1)
    x1 = torch.clamp(x0 + 1, 0, in_size - 1)
    w = (src - x0.to(torch.float32)).to(img.dtype)
    shape = [1] * img.ndim
    shape[axis] = out_size
    w = w.reshape(shape)
    g0 = torch.index_select(img, axis, x0)
    g1 = torch.index_select(img, axis, x1)
    return g0 * (1.0 - w) + g1 * w


def resize_area(img: torch.Tensor, out_hw,
                channel_last: bool | None = None) -> torch.Tensor:
    """cv2.INTER_AREA-style resize (box average when shrinking).

    As in the JAX package: above ``_MATRIX_LIMIT`` weights, an exact
    integer-factor box mean where both factors are integers, else a 2-tap
    bilinear gather; below it, the area matrices."""
    hwc = _is_channel_last(img, channel_last)
    h, w = _spatial_shape(img, hwc)
    oh, ow = out_hw
    if (h, w) == (oh, ow):
        return img
    if h * oh > _MATRIX_LIMIT or w * ow > _MATRIX_LIMIT:
        h_axis = img.ndim - 3 if hwc else img.ndim - 2
        if h % oh == 0 and w % ow == 0:
            shape = (*img.shape[:h_axis], oh, h // oh, ow, w // ow, *img.shape[h_axis + 2:])
            return img.reshape(shape).mean(dim=(h_axis + 1, h_axis + 3))
        out = _gather_axis_linear(img, oh, h_axis, False)
        return _gather_axis_linear(out, ow, h_axis + 1, False)
    return _apply(img, "area", out_hw, False, hwc)


def pad_to_aspect(img: torch.Tensor, target_w: int, target_h: int) -> torch.Tensor:
    """Letterbox an [H, W, C] image into (target_h, target_w): aspect-
    preserving area resize to fit, then centered zero padding."""
    h, w = img.shape[0], img.shape[1]
    current_aspect = w / h
    if current_aspect > target_w / target_h:
        new_w, new_h = target_w, int(target_w / current_aspect)
    else:
        new_h, new_w = target_h, int(current_aspect * target_h)
    resized = resize_area(img, (new_h, new_w))
    x_off = (target_w - new_w) // 2
    y_off = (target_h - new_h) // 2
    pad = (x_off, target_w - new_w - x_off, y_off, target_h - new_h - y_off)
    if img.ndim == 3:
        pad = (0, 0) + pad
    if not any(pad):
        return resized
    return F.pad(resized, pad)
