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


def _extract(imgs: torch.Tensor, tile_hw: tuple[int, int], overlap: int):
    """[B, H, W, ...] -> ([B, N, th, tw, ...] tiles, their (y, x) starts)."""
    th, tw = tile_hw
    if th - overlap <= 0 or tw - overlap <= 0:
        raise ValueError(f"tile {tile_hw} must exceed the overlap {overlap}")
    starts = [(y, x) for y in tile_grid(imgs.shape[1], th, overlap)
              for x in tile_grid(imgs.shape[2], tw, overlap)]
    return torch.stack([imgs[:, y:y + th, x:x + tw] for y, x in starts], dim=1), starts


def _blend(tiles: torch.Tensor, starts, out_hw: tuple[int, int]) -> torch.Tensor:
    """Hann-weighted overlap-add of [B, N, th, tw(, C)] tiles -> [B, *out_hw(, C)]."""
    th, tw = tiles.shape[2], tiles.shape[3]
    window = torch.from_numpy(hann2d(th, tw)).to(device=tiles.device, dtype=tiles.dtype)
    chan = tiles.shape[4:]
    wnd = window.reshape((th, tw) + (1,) * len(chan))
    acc = torch.zeros((tiles.shape[0],) + tuple(out_hw) + tuple(chan), dtype=tiles.dtype,
                      device=tiles.device)
    wacc = torch.zeros(tuple(out_hw), dtype=tiles.dtype, device=tiles.device)
    for i, (y, x) in enumerate(starts):
        acc[:, y:y + th, x:x + tw] += tiles[:, i] * wnd
        wacc[y:y + th, x:x + tw] += window
    return acc / torch.clamp(wacc, min=1e-8).reshape(tuple(out_hw) + (1,) * len(chan))[None]


def extract_tiles(img: torch.Tensor, tile_hw: tuple[int, int], overlap: int):
    """[H, W, C] -> ([N, th, tw, C] tiles, their (y, x) starts)."""
    tiles, starts = _extract(img[None], tile_hw, overlap)
    return tiles[0], starts


def blend_tiles(tiles: torch.Tensor, starts, out_hw: tuple[int, int]) -> torch.Tensor:
    """Hann-weighted overlap-add of [N, th, tw(, C)] tiles back to out_hw."""
    return _blend(tiles[None], starts, out_hw)[0]


def tiled_apply(fn, img: torch.Tensor, tile_hw: tuple[int, int], overlap: int) -> torch.Tensor:
    """``fn`` over Hann-blended tiles of one [H, W, C] image, in one call:
    [N, th, tw, C] -> [N, th, tw] or [N, th, tw, C']."""
    return tiled_apply_batch(fn, img[None], tile_hw, overlap)[0]


def tiled_apply_batch(fn, imgs: torch.Tensor, tile_hw: tuple[int, int],
                      overlap: int) -> torch.Tensor:
    """[B, H, W, C] -> [B, H, W] (or [B, H, W, C']): ``fn`` maps
    [B * N, th, tw, C] tiles to [B * N, th, tw] (or [B * N, th, tw, C'])
    in one call; the outputs are Hann-blended per frame."""
    b, h, w = imgs.shape[:3]
    tiles, starts = _extract(imgs, tile_hw, overlap)
    n, th, tw = tiles.shape[1:4]  # a frame smaller than a tile is one tile
    out = fn(tiles.reshape((b * n, th, tw) + tuple(imgs.shape[3:])))
    if tuple(out.shape[1:3]) != (th, tw):
        raise ValueError(f"tile fn must return tile-sized output, got {tuple(out.shape)}")
    return _blend(out.reshape((b, n) + tuple(out.shape[1:])), starts, (h, w))
