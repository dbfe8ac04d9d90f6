"""Horizontal disparity warp — the DIBR resampling core.

Counterpart of ``visiondepth3d_tpu/ops/warp.py`` and the plain version
behind the warp kernel (``kernels/warp.py``). Per row:

    src_x = clamp(x + shift[y, x] * (W - 1) / 2, 0, W - 1)
    out[y, x] = lerp(img[y, floor(src_x)], img[y, floor(src_x) + 1])

The left eye adds the shift, the right eye subtracts it. Two forms with the
same semantics: a 2-tap gather, and a shifted accumulation over the static
tap bound ``max_shift_px`` (``2K + 2`` shift-and-FMA passes, no gather).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _sample_row_bilinear(img: torch.Tensor, src_x: torch.Tensor) -> torch.Tensor:
    """Linear sample along W with border clamp. img: [H, W] or [H, W, C];
    src_x: [H, W] float32 source columns."""
    w = img.shape[1]
    src_x = torch.clamp(src_x, 0.0, w - 1.0)
    x0 = torch.floor(src_x).to(torch.int64).clamp(0, w - 1)
    x1 = (x0 + 1).clamp(0, w - 1)
    frac = src_x - x0.to(src_x.dtype)
    if img.ndim == 3:
        c = img.shape[2]
        frac = frac[..., None]
        g0 = torch.gather(img, 1, x0[..., None].expand(-1, -1, c))
        g1 = torch.gather(img, 1, x1[..., None].expand(-1, -1, c))
    else:
        g0 = torch.gather(img, 1, x0)
        g1 = torch.gather(img, 1, x1)
    return g0 * (1.0 - frac) + g1 * frac


def _sample_row_shifted_acc(imgs: list[torch.Tensor], src_x: torch.Tensor,
                            max_shift_px: int) -> list[torch.Tensor]:
    """out[x] = sum_k hat(src_x - (x + k)) * img[x + k], k in [-K, K + 1]."""
    w = src_x.shape[1]
    k0 = max_shift_px
    x_idx = torch.arange(w, dtype=src_x.dtype, device=src_x.device)[None, :]
    src_x = torch.clamp(src_x, 0.0, w - 1.0)
    padded = []
    for im in imgs:
        pad = (k0, k0 + 1) if im.ndim == 2 else (0, 0, k0, k0 + 1)
        padded.append(F.pad(im, pad))
    outs = [torch.zeros_like(im) for im in imgs]
    for k in range(-k0, k0 + 2):
        wk = torch.clamp(1.0 - torch.abs(src_x - (x_idx + k)), 0.0, 1.0)
        for i, im in enumerate(padded):
            sl = im[:, k0 + k: k0 + k + w]
            outs[i] = outs[i] + sl * (wk[..., None] if im.ndim == 3 else wk)
    return outs


def disparity_warp(img: torch.Tensor, shift_norm: torch.Tensor) -> torch.Tensor:
    """Warp img ([H, W] or [H, W, C]) by a normalized shift map; a positive
    shift samples from the right."""
    w = img.shape[1]
    x_idx = torch.arange(w, dtype=shift_norm.dtype, device=shift_norm.device)[None, :]
    return _sample_row_bilinear(img, x_idx + shift_norm * (w - 1) / 2.0)


def stereo_warp(frame: torch.Tensor, shaped_depth: torch.Tensor,
                shift_norm: torch.Tensor, max_shift_px: int | None = None):
    """Warp frame [H, W, 3] and shaped depth [H, W] for both eyes.

    Returns (left, right, depth_left, depth_right). With ``max_shift_px``
    the shifted accumulation runs, otherwise the gather.
    """
    w = frame.shape[1]
    x_idx = torch.arange(w, dtype=shift_norm.dtype, device=shift_norm.device)[None, :]
    delta = shift_norm * (w - 1) / 2.0
    src_left = x_idx + delta
    src_right = x_idx - delta
    if max_shift_px is not None:
        left, depth_left = _sample_row_shifted_acc([frame, shaped_depth], src_left,
                                                   max_shift_px)
        right, depth_right = _sample_row_shifted_acc([frame, shaped_depth], src_right,
                                                     max_shift_px)
        return left, right, depth_left, depth_right
    return (_sample_row_bilinear(frame, src_left),
            _sample_row_bilinear(frame, src_right),
            _sample_row_bilinear(shaped_depth, src_left),
            _sample_row_bilinear(shaped_depth, src_right))
