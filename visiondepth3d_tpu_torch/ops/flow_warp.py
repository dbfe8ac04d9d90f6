"""Dense 2-D backward warping (optical-flow resampling).

Counterpart of ``visiondepth3d_tpu/ops/flow_warp.py``, the resampling
primitive behind RIFE: bilinear, border clamp, align_corners=True pixel
convention (src = dst + flow in pixels), written as the same 4-gather
formula with positions in the flow's type.
"""

from __future__ import annotations

import torch


def flow_warp(img: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """img [H, W, C]; flow [H, W, 2] (dx, dy) in pixels. Returns [H, W, C]:
    out[y, x] = img sampled at (x + dx, y + dy), border-clamped bilinear."""
    return flow_warp_batch(img[None], flow[None])[0]


def flow_warp_batch(imgs: torch.Tensor, flows: torch.Tensor) -> torch.Tensor:
    """imgs [B, H, W, C]; flows [B, H, W, 2] (dx, dy) in pixels.

    out[b, y, x] = imgs[b] sampled at (x + dx, y + dy), border-clamped
    bilinear. Returns [B, H, W, C]."""
    b, h, w, c = imgs.shape
    yy = torch.arange(h, dtype=flows.dtype, device=flows.device)[:, None]
    xx = torch.arange(w, dtype=flows.dtype, device=flows.device)[None, :]
    src_x = torch.clamp(xx + flows[..., 0], 0.0, w - 1.0)
    src_y = torch.clamp(yy + flows[..., 1], 0.0, h - 1.0)
    x0 = torch.clamp(torch.floor(src_x).to(torch.int64), 0, w - 1)
    y0 = torch.clamp(torch.floor(src_y).to(torch.int64), 0, h - 1)
    x1 = torch.clamp(x0 + 1, 0, w - 1)
    y1 = torch.clamp(y0 + 1, 0, h - 1)
    fx = (src_x - x0)[..., None]
    fy = (src_y - y0)[..., None]
    flat = imgs.reshape(b, h * w, c)

    def gather(yi, xi):
        idx = (yi * w + xi).reshape(b, h * w, 1).expand(b, h * w, c)
        return torch.gather(flat, 1, idx).reshape(b, h, w, c)

    top = gather(y0, x0) * (1 - fx) + gather(y0, x1) * fx
    bot = gather(y1, x0) * (1 - fx) + gather(y1, x1) * fx
    return top * (1 - fy) + bot * fy
