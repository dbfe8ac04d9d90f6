"""Resampling as separable (out, in) weight matrices, and letterboxing.

A frozen copy of the plain resampling the program's render uses (the
render's published numerics: bilinear with and without aligned corners,
bicubic with a = -0.75 for the position-embedding regrid, area shrink), the
matrices built in float64 and stored as float32, applied with einsum.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from .precision import Mat

# above this many weights the area resize pools by integer factors or
# takes a two-tap bilinear gather, as the render does
MATRIX_LIMIT = 1 << 18


@functools.lru_cache(maxsize=64)
def linear_matrix(in_size: int, out_size: int, align_corners: bool) -> np.ndarray:
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
        src = np.clip((dst + 0.5) * (in_size / out_size) - 0.5, 0.0, in_size - 1)
    x0 = np.clip(np.floor(src).astype(np.int64), 0, in_size - 1)
    x1 = np.clip(x0 + 1, 0, in_size - 1)
    w = src - x0
    rows = dst.astype(np.int64)
    m[rows, x0] += (1.0 - w).astype(np.float32)
    np.add.at(m, (rows, x1), w.astype(np.float32))
    return m


def _cubic(x: np.ndarray, a: float = -0.75) -> np.ndarray:
    ax = np.abs(x)
    return np.where(ax <= 1, (a + 2) * ax**3 - (a + 3) * ax**2 + 1,
                    np.where(ax < 2, a * ax**3 - 5 * a * ax**2 + 8 * a * ax - 4 * a, 0.0))


@functools.lru_cache(maxsize=16)
def cubic_matrix(in_size: int, out_size: int) -> np.ndarray:
    m = np.zeros((out_size, in_size), dtype=np.float64)
    dst = np.arange(out_size, dtype=np.float64)
    src = (dst + 0.5) * (in_size / out_size) - 0.5
    x0 = np.floor(src).astype(np.int64)
    t = src - x0
    for tap in (-1, 0, 1, 2):
        idx = np.clip(x0 + tap, 0, in_size - 1)
        np.add.at(m, (dst.astype(np.int64), idx), _cubic(tap - t))
    return m.astype(np.float32)


@functools.lru_cache(maxsize=16)
def area_matrix(in_size: int, out_size: int) -> np.ndarray:
    if out_size >= in_size:
        return linear_matrix(in_size, out_size, False)
    m = np.zeros((out_size, in_size), dtype=np.float64)
    scale = in_size / out_size
    for o in range(out_size):
        a, b = o * scale, (o + 1) * scale
        for i in range(int(np.floor(a)), min(int(np.ceil(b)), in_size)):
            overlap = min(b, i + 1) - max(a, i)
            if overlap > 0:
                m[o, i] = overlap
    return (m / scale).astype(np.float32)


def _t(m: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(m).to(device=like.device, dtype=like.dtype)


def apply(mm: Mat, img: torch.Tensor, rh: np.ndarray, rw: np.ndarray, hwc: bool):
    """rh [oh, h] and rw [ow, w] applied to img ([..., H, W, C] when hwc,
    else [..., H, W]): rows first, then columns."""
    if hwc:
        out = mm.einsum("oh,...hwc->...owc", _t(rh, img), img)
        return mm.einsum("pw,...owc->...opc", _t(rw, img), out)
    out = mm.einsum("oh,...hw->...ow", _t(rh, img), img)
    return mm.einsum("pw,...ow->...op", _t(rw, img), out)


def bilinear(mm: Mat, img, out_hw, hwc: bool, align_corners: bool = False):
    h, w = (img.shape[-3], img.shape[-2]) if hwc else (img.shape[-2], img.shape[-1])
    if (h, w) == tuple(out_hw):
        return img
    oh, ow = out_hw
    return apply(mm, img, linear_matrix(h, oh, align_corners),
                 linear_matrix(w, ow, align_corners), hwc)


def bicubic(mm: Mat, img, out_hw, hwc: bool):
    h, w = (img.shape[-3], img.shape[-2]) if hwc else (img.shape[-2], img.shape[-1])
    if (h, w) == tuple(out_hw):
        return img
    return apply(mm, img, cubic_matrix(h, out_hw[0]), cubic_matrix(w, out_hw[1]), hwc)


def _gather_linear(img: torch.Tensor, out_size: int, axis: int) -> torch.Tensor:
    in_size = img.shape[axis]
    if in_size == 1:
        reps = [1] * img.ndim
        reps[axis] = out_size
        return img.repeat(reps)
    dst = torch.arange(out_size, dtype=torch.float32, device=img.device)
    src = torch.clamp((dst + 0.5) * (in_size / out_size) - 0.5, 0.0, in_size - 1)
    x0 = torch.clamp(torch.floor(src).to(torch.int64), 0, in_size - 1)
    x1 = torch.clamp(x0 + 1, 0, in_size - 1)
    shape = [1] * img.ndim
    shape[axis] = out_size
    w = (src - x0.to(torch.float32)).to(img.dtype).reshape(shape)
    return torch.index_select(img, axis, x0) * (1.0 - w) + torch.index_select(img, axis, x1) * w


def area_hwc(mm: Mat, img: torch.Tensor, out_hw) -> torch.Tensor:
    """Area resize of an [H, W, C] image (box mean when shrinking)."""
    h, w = img.shape[0], img.shape[1]
    oh, ow = out_hw
    if (h, w) == (oh, ow):
        return img
    if h * oh > MATRIX_LIMIT or w * ow > MATRIX_LIMIT:
        if h % oh == 0 and w % ow == 0:
            return img.reshape(oh, h // oh, ow, w // ow, img.shape[2]).mean(dim=(1, 3))
        return _gather_linear(_gather_linear(img, oh, 0), ow, 1)
    return apply(mm, img, area_matrix(h, oh), area_matrix(w, ow), True)


def letterbox(mm: Mat, img: torch.Tensor, target_w: int, target_h: int) -> torch.Tensor:
    """Fit an [H, W, C] image into (target_h, target_w): aspect-preserving
    area resize, then centered zero padding."""
    h, w = img.shape[0], img.shape[1]
    aspect = w / h
    if aspect > target_w / target_h:
        new_w, new_h = target_w, int(target_w / aspect)
    else:
        new_h, new_w = target_h, int(aspect * target_h)
    out = area_hwc(mm, img, (new_h, new_w))
    x_off, y_off = (target_w - new_w) // 2, (target_h - new_h) // 2
    pad = (0, 0, x_off, target_w - new_w - x_off, y_off, target_h - new_h - y_off)
    return F.pad(out, pad) if any(pad) else out
