"""Frame/depth conversions and quantization points.

Counterpart of ``visiondepth3d_tpu/ops/convert.py``. The u8 contracts are
part of the numerical spec: ``float_to_u8_trunc`` truncates like the
reference's ``(x * 255).astype(uint8)``, ``quantize_u8`` reproduces that
round-trip in float, and the YUV420 conversions are integer math with
arithmetic right shifts, bit-exact with ``native/vd3d_media.cpp``.
"""

from __future__ import annotations

import torch

# cv2's BGR2GRAY weights (Rec.601 luma), on RGB
_GRAY_RGB = (0.299, 0.587, 0.114)


def u8_to_float(img_u8: torch.Tensor) -> torch.Tensor:
    """uint8 [..., C] -> float32 in [0, 1]."""
    return img_u8.to(torch.float32) / 255.0


def float_to_u8_trunc(img: torch.Tensor) -> torch.Tensor:
    """(x * 255) truncated toward zero to uint8, computed in float32."""
    return (img.float().clamp(0.0, 1.0) * 255.0).to(torch.uint8)


def float_to_u8_round(img: torch.Tensor) -> torch.Tensor:
    """Round-half-to-even u8 (the default for the final encode), computed
    in float32: bf16 cannot hold x * 255 to better than a whole step."""
    return torch.round(img.float() * 255.0).clamp(0.0, 255.0).to(torch.uint8)


def quantize_u8(img: torch.Tensor) -> torch.Tensor:
    """float(u8(trunc(x * 255))) / 255 without leaving float."""
    return torch.floor(img.clamp(0.0, 1.0) * 255.0) / 255.0


def rgb_to_gray(rgb: torch.Tensor) -> torch.Tensor:
    """[..., 3] RGB -> [...] gray with cv2/Rec.601 weights, in rgb's type."""
    return (_GRAY_RGB[0] * rgb[..., 0] + _GRAY_RGB[1] * rgb[..., 1]
            + _GRAY_RGB[2] * rgb[..., 2])


def depth_frame_to_01(depth_rgb_u8: torch.Tensor) -> torch.Tensor:
    """An RGB uint8 depth frame [..., H, W, 3] -> round(gray) / 255 in
    float32 [..., H, W] (the reference's BGR2GRAY of a depth frame).

    The divisor is a tensor on the frame's device: PyTorch's CUDA division
    by a Python number multiplies by its reciprocal, one ulp off the
    quotient the CPU (and JAX) computes."""
    gray = torch.round(rgb_to_gray(depth_rgb_u8.to(torch.float32)))
    return gray / gray.new_tensor(255.0)


def bgr_to_rgb(img: torch.Tensor) -> torch.Tensor:
    """Reverse the last (channel) axis."""
    return img.flip(-1)


def yuv420_to_rgb_u8(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """YUV420 uint8 planes [..., H, W] / [..., H/2, W/2] -> RGB uint8
    [..., H, W, 3] (BT.601 limited range, nearest chroma upsample)."""
    yi = y.to(torch.int32)
    h, w = yi.shape[-2], yi.shape[-1]
    ui = u.to(torch.int32).repeat_interleave(2, dim=-1).repeat_interleave(2, dim=-2)
    vi = v.to(torch.int32).repeat_interleave(2, dim=-1).repeat_interleave(2, dim=-2)
    ui = ui[..., :h, :w]
    vi = vi[..., :h, :w]
    c = (yi - 16) * 298
    d = ui - 128
    e = vi - 128
    r = (c + 409 * e + 128) >> 8
    g = (c - 100 * d - 208 * e + 128) >> 8
    b = (c + 516 * d + 128) >> 8
    return torch.stack([r, g, b], dim=-1).clamp(0, 255).to(torch.uint8)


def rgb_u8_to_yuv420(rgb_u8: torch.Tensor):
    """RGB uint8 [..., H, W, 3] -> (Y [..., H, W], U, V [..., H/2, W/2])
    uint8 (BT.601 limited range, floor of the exact 2x2 chroma mean).
    H and W must be even."""
    x = rgb_u8.to(torch.int32)
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    y = ((66 * r + 129 * g + 25 * b + 128 + (16 << 8)) >> 8).clamp(0, 255)
    h, w = x.shape[-3], x.shape[-2]
    lead = tuple(x.shape[:-3])

    def pool(c):
        return c.reshape(lead + (h // 2, 2, w // 2, 2)).sum(dim=(-1, -3)) >> 2

    rm, gm, bm = pool(r), pool(g), pool(b)
    u = ((-38 * rm - 74 * gm + 112 * bm + 128) >> 8) + 128
    v = ((112 * rm - 94 * gm - 18 * bm + 128) >> 8) + 128
    return (y.to(torch.uint8),
            u.clamp(0, 255).to(torch.uint8),
            v.clamp(0, 255).to(torch.uint8))
