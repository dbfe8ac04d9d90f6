"""Pixel conversions: BT.601 limited-range YUV420 <-> RGB in integer
arithmetic with arithmetic right shifts (the y4m library's formulas),
nearest chroma upsampling, the floor of the exact 2x2 chroma mean, and the
u8 round of the final encode (half to even)."""

from __future__ import annotations

import torch


def yuv420_to_rgb_u8(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Y [..., H, W], U and V [..., H/2, W/2] uint8 -> RGB [..., H, W, 3] uint8."""
    yi = y.to(torch.int32)
    h, w = yi.shape[-2], yi.shape[-1]
    ui = u.to(torch.int32).repeat_interleave(2, -1).repeat_interleave(2, -2)[..., :h, :w]
    vi = v.to(torch.int32).repeat_interleave(2, -1).repeat_interleave(2, -2)[..., :h, :w]
    c, d, e = (yi - 16) * 298, ui - 128, vi - 128
    r = (c + 409 * e + 128) >> 8
    g = (c - 100 * d - 208 * e + 128) >> 8
    b = (c + 516 * d + 128) >> 8
    return torch.stack([r, g, b], dim=-1).clamp(0, 255).to(torch.uint8)


def rgb_u8_to_yuv420(rgb: torch.Tensor):
    """RGB [..., H, W, 3] uint8 (H, W even) -> (Y, U, V) uint8."""
    x = rgb.to(torch.int32)
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    y = ((66 * r + 129 * g + 25 * b + 128 + (16 << 8)) >> 8).clamp(0, 255)
    h, w = x.shape[-3], x.shape[-2]
    lead = tuple(x.shape[:-3])

    def pool(c):
        return c.reshape(lead + (h // 2, 2, w // 2, 2)).sum(dim=(-1, -3)) >> 2

    rm, gm, bm = pool(r), pool(g), pool(b)
    u = ((-38 * rm - 74 * gm + 112 * bm + 128) >> 8) + 128
    v = ((112 * rm - 94 * gm - 18 * bm + 128) >> 8) + 128
    return y.to(torch.uint8), u.clamp(0, 255).to(torch.uint8), v.clamp(0, 255).to(torch.uint8)


def u8_round(x: torch.Tensor) -> torch.Tensor:
    return torch.round(x.float() * 255.0).clamp(0.0, 255.0).to(torch.uint8)
