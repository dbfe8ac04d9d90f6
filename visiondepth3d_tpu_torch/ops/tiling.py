"""Hann-blended spatial tiling for high-resolution model inference.

Counterpart of ``visiondepth3d_tpu/ops/tiling.py``: a static grid of
overlapping tiles, all tiles of all frames stacked into one model call,
and a Hann-weighted overlap-add of the raw tile outputs.
"""

from __future__ import annotations

import numpy as np
import torch


def hann2d(th: int, tw: int, eps: float = 1e-3) -> np.ndarray:
    """Separable 2-D Hann window, floored at eps."""
    wy = 0.5 - 0.5 * np.cos(2 * np.pi * (np.arange(th) + 0.5) / th)
    wx = 0.5 - 0.5 * np.cos(2 * np.pi * (np.arange(tw) + 0.5) / tw)
    return np.maximum(np.outer(wy, wx), eps).astype(np.float32)


def tile_grid(size: int, tile: int, overlap: int) -> list[int]:
    """Tile start offsets covering [0, size) with the given overlap."""
    if size <= tile:
        return [0]
    starts = list(range(0, size - tile, tile - overlap))
    starts.append(size - tile)
    return starts


def tiled_apply_batch(fn, imgs: torch.Tensor, tile_hw: tuple[int, int],
                      overlap: int) -> torch.Tensor:
    """[B, H, W, C] -> [B, H, W]: ``fn`` maps [B * N, th, tw, C] tiles to
    [B * N, th, tw] in one call; the outputs are Hann-blended per frame."""
    b, h, w = imgs.shape[:3]
    th, tw = tile_hw
    if th - overlap <= 0 or tw - overlap <= 0:
        raise ValueError(f"tile {tile_hw} must exceed the overlap {overlap}")
    starts = [(y, x) for y in tile_grid(h, th, overlap) for x in tile_grid(w, tw, overlap)]
    tiles = torch.stack([imgs[:, y:y + th, x:x + tw] for y, x in starts], dim=1)
    n = len(starts)
    out = fn(tiles.reshape((b * n, th, tw) + tuple(imgs.shape[3:])))
    if tuple(out.shape[-2:]) != (th, tw):
        raise ValueError(f"tile fn must return tile-sized depth, got {tuple(out.shape)}")
    out = out.reshape(b, n, th, tw)
    window = torch.from_numpy(hann2d(th, tw)).to(device=out.device, dtype=out.dtype)
    acc = torch.zeros((b, h, w), dtype=out.dtype, device=out.device)
    wacc = torch.zeros((h, w), dtype=out.dtype, device=out.device)
    for i, (y, x) in enumerate(starts):
        acc[:, y:y + th, x:x + tw] += out[:, i] * window
        wacc[y:y + th, x:x + tw] += window
    return acc / torch.clamp(wacc, min=1e-8)[None]
