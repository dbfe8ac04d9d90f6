"""Merged frame-tools pipeline: upscale + interpolate + encode.

Counterpart of ``visiondepth3d_tpu/enhance/pipeline.py`` on one device:
frames -> Real-ESRGAN upscale (optional pre-downscale, blend modes, resize
back to the source size) -> RIFE in-betweens -> writer at fps x multiplier.
Chunks overlap by one frame so RIFE keeps its pair context across chunk
boundaries; a short last chunk is padded by repeating its last frame, so
every chunk has the same shape.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np
import torch

from ..device import DEFAULT_DEVICE, resolve_device
from ..io import open_video, open_writer
from ..ops.resize import resize_area, resize_bilinear
from .esrgan import RRDBNet, apply_rrdbnet_staged, blend_images
from .rife import _DEFAULT_CS, IFNet


@dataclasses.dataclass
class EnhanceConfig:
    use_esrgan: bool = True
    esrgan_scale: int = 4
    esrgan_nf: int = 64
    esrgan_nb: int = 23
    esrgan_gc: int = 32
    esrgan_n_up: int = 2  # nearest-up2 conv stages in the tail
    esrgan_unshuffle: bool = True  # Real-ESRGAN input pixel-unshuffle style
    pre_downscale: float = 1.0  # 0.25..1.0 input shrink before upscale
    keep_original_size: bool = True  # the reference resizes back to source size
    blend_mode: str = "OFF"  # OFF/LOW/MEDIUM/HIGH
    use_rife: bool = True
    fps_multiplier: int = 2
    rife_scales: tuple = (4, 2, 1)
    codec: str = "libx264"
    chunk_size: int = 4
    # random weights produce garbage frames; only tests, shape checks and
    # benchmarks opt into them
    allow_random_weights: bool = False
    # "bfloat16": the RRDBNet/IFNet stacks run in bf16 (weights cast once);
    # the u8 output contract is unchanged
    dtype: str = "float32"


# Above this many trunk pixels per chunk the monolithic x4 tail's
# activations are too large for the device (sized for the JAX package's
# 15.75 GB TPU, kept for parity), and the tail runs tiled.
_STAGE_THRESHOLD_PX = 1 << 21

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _tile_len(size: int) -> int | None:
    """A divisor of ``size`` usable as a staged-tail tile edge (room for the
    2-px halo), nearest 480; None when size has no usable divisor."""
    cands = [d for d in range(16, size // 2 + 1) if size % d == 0 and d + 4 <= size]
    if not cands:
        return None
    return min(cands, key=lambda d: abs(d - 480))


def _apply_esrgan(cfg: EnhanceConfig, esrgan: RRDBNet, x: torch.Tensor) -> torch.Tensor:
    """Whole-frame apply for small chunks; the staged route (trunk whole, x4
    tail tiled, exact) above ``_STAGE_THRESHOLD_PX`` trunk pixels."""
    t, h, w = x.shape[0], x.shape[1], x.shape[2]
    unshuffle = (4 // cfg.esrgan_scale) if cfg.esrgan_unshuffle else 1
    th, tw = h // unshuffle, w // unshuffle
    tile_h, tile_w = _tile_len(th), _tile_len(tw)
    if (t * th * tw <= _STAGE_THRESHOLD_PX or tile_h is None or tile_w is None
            or cfg.esrgan_n_up != 2):
        return esrgan(x)
    return apply_rrdbnet_staged(esrgan, x, tail_tile_hw=(tile_h, tile_w))


def _rife_model(cfg: EnhanceConfig, rife_params):
    """(model, state dict): a (state dict, IFNetConfig) pair carries the
    checkpoint's own geometry; a bare state dict uses ``cfg.rife_scales``
    with the v4.x widths of the finest levels."""
    if isinstance(rife_params, tuple):
        rife_params, rife_cfg = rife_params
        return rife_cfg.build(), rife_params
    scales = tuple(cfg.rife_scales)
    return IFNet(cs=_DEFAULT_CS[-len(scales):], scales=scales), rife_params


def make_enhance_fn(cfg: EnhanceConfig, esrgan_params, rife_params, in_hw: tuple[int, int],
                    device=DEFAULT_DEVICE) -> Callable:
    """The chunk function on ``device``: [T, H, W, 3] u8 tensor ->
    [T', H', W', 3] u8 tensor, T' = (T - 1) * fps_multiplier + 1 with RIFE.

    ``esrgan_params`` / ``rife_params``: state dicts (or a (state dict,
    IFNetConfig) pair for RIFE); the weights go to the device once, in the
    run's type."""
    dev = resolve_device(device)
    cdt = _DTYPES[cfg.dtype]
    h, w = in_hw
    esrgan = rife = None
    if cfg.use_esrgan:
        esrgan = RRDBNet(cfg.esrgan_nf, cfg.esrgan_nb, cfg.esrgan_gc, scale=cfg.esrgan_scale,
                         n_up=cfg.esrgan_n_up, unshuffle=cfg.esrgan_unshuffle)
        esrgan.load_state_dict(esrgan_params)
        esrgan = esrgan.to(device=dev, dtype=cdt).eval()
    if cfg.use_rife and cfg.fps_multiplier > 1:
        rife, state = _rife_model(cfg, rife_params)
        rife.load_state_dict(state)
        rife = rife.to(device=dev, dtype=cdt).eval()

    @torch.inference_mode()
    def fn(frames_u8: torch.Tensor) -> torch.Tensor:
        x = frames_u8.to(cdt) / 255.0
        if esrgan is not None:
            if cfg.pre_downscale < 1.0:
                x_in = resize_area(x, (int(h * cfg.pre_downscale), int(w * cfg.pre_downscale)))
            else:
                x_in = x
            up = torch.clamp(_apply_esrgan(cfg, esrgan, x_in), 0.0, 1.0)
            if cfg.keep_original_size:
                up, base = resize_area(up, (h, w)), x
            else:
                base = resize_bilinear(x, tuple(up.shape[1:3]))
            x = torch.clamp(blend_images(base, up, cfg.blend_mode), 0.0, 1.0)
        if rife is not None:
            img0, img1 = x[:-1], x[1:]
            outs = [img0] + [rife(img0, img1, k / cfg.fps_multiplier)
                             for k in range(1, cfg.fps_multiplier)]
            # interleave: f0, mids(f0, f1)..., f1, ... then the last frame
            x = torch.cat([torch.stack(outs, dim=1).reshape(-1, *x.shape[1:]), x[-1:]])
        return torch.clamp(x.float() * 255.0 + 0.5, 0, 255).to(torch.uint8)

    return fn


def init_random_(module: torch.nn.Module, gen: torch.Generator) -> torch.nn.Module:
    """Seeded random weights in place: conv weights N(0, 1/fan_in) (fan_in =
    in channels x kernel area), biases zero, PReLU slopes 0.25 and residual
    betas 1 as constructed. Drawn on the CPU from ``gen``, so one seed gives
    the same weights on every device."""
    with torch.no_grad():
        for name, p in module.named_parameters():
            if name.endswith("weight") and p.ndim == 4:
                # conv weights are [out, in, k, k]; the transpose conv's [in, out, k, k]
                fan_in = (p.shape[0] if "lastconv" in name else p.shape[1]) * p[0, 0].numel()
                p.copy_(torch.randn(p.shape, generator=gen) * fan_in ** -0.5)
            elif name.endswith("bias"):
                p.zero_()
    return module


def init_enhance_params(cfg: EnhanceConfig, seed: int = 0):
    """Seeded random state dicts for both models (shape, speed and kernel
    checks; the output is not a useful image). RIFE gets the geometry
    ``run_merged_pipeline`` builds for a bare state dict."""
    gen = torch.Generator().manual_seed(seed)
    ep = rp = {}
    if cfg.use_esrgan:
        esrgan = RRDBNet(cfg.esrgan_nf, cfg.esrgan_nb, cfg.esrgan_gc, scale=cfg.esrgan_scale,
                         n_up=cfg.esrgan_n_up, unshuffle=cfg.esrgan_unshuffle)
        init_random_(esrgan, gen)
        ep = esrgan.state_dict()
    if cfg.use_rife:
        rife, _ = _rife_model(cfg, {})
        init_random_(rife, gen)
        rp = rife.state_dict()
    return ep, rp


def run_merged_pipeline(input_path, output_path, cfg: EnhanceConfig | None = None,
                        esrgan_params=None, rife_params=None,
                        progress_cb: Callable | None = None,
                        mesh_axes: dict[str, int] | None = None,
                        cancel_check: Callable | None = None,
                        device=DEFAULT_DEVICE) -> int:
    """Video -> enhanced video; returns the number of frames written.

    Overlapping chunks keep RIFE's pair context: each chunk shares its first
    frame with the previous chunk's last. ``cancel_check`` is polled between
    chunks. ``device``: the CUDA card unless "cpu" is passed; without a card
    the default raises. Missing weights are ``init_enhance_params(cfg)``'s
    seeded random ones when ``cfg.allow_random_weights``. ``mesh_axes``
    with dp > 1 is not ported (one device only).
    """
    cfg = cfg or EnhanceConfig()
    if mesh_axes and int(mesh_axes.get("dp", 1)) > 1:
        raise NotImplementedError("multi-device frame tools (mesh dp > 1) are not ported yet")
    missing = (cfg.use_esrgan and esrgan_params is None) or (
        cfg.use_rife and rife_params is None)
    if missing and not cfg.allow_random_weights:
        raise ValueError(
            "enhance models need converted checkpoints (convert_esrgan / convert_rife); "
            "pass allow_random_weights=True only for shape/compile testing — random "
            "weights produce garbage frames")
    dev = resolve_device(device)
    if missing:
        ep, rp = init_enhance_params(cfg)
        esrgan_params = ep if esrgan_params is None else esrgan_params
        rife_params = rp if rife_params is None else rife_params
    rd = open_video(input_path)
    wr = None
    try:
        fn = make_enhance_fn(cfg, esrgan_params, rife_params, (rd.height, rd.width), dev)
        mult = cfg.fps_multiplier if cfg.use_rife else 1
        # the writer's geometry is what fn emits: without the resize back,
        # int(dim * pre_downscale) * scale
        if cfg.use_esrgan and not cfg.keep_original_size:
            out_w = int(rd.width * cfg.pre_downscale) * cfg.esrgan_scale
            out_h = int(rd.height * cfg.pre_downscale) * cfg.esrgan_scale
        else:
            out_w, out_h = rd.width, rd.height
        wr = open_writer(output_path, out_w, out_h, rd.fps * mult, cfg.codec)
        n_out, t0 = 0, time.time()
        carry = None  # last source frame of the previous chunk (pair context)
        tail = None  # its enhanced version, written at EOF
        eof = False
        while not eof:
            if cancel_check and cancel_check():
                break
            batch = [] if carry is None else [carry]
            while len(batch) < cfg.chunk_size + 1:
                f = rd.read()
                if f is None:
                    eof = True
                    break
                batch.append(f)
            if len(batch) < 2:
                break
            n_in = len(batch)
            batch += [batch[-1]] * (cfg.chunk_size + 1 - n_in)
            out = fn(torch.from_numpy(np.stack(batch)).to(dev)).cpu().numpy()
            valid = (n_in - 1) * mult  # the chunk's last frame opens the next chunk
            for i in range(valid):
                wr.write(out[i])
            n_out += valid
            carry = batch[n_in - 1]
            tail = out[valid] if valid < len(out) else out[-1]
            if progress_cb:
                progress_cb(n_out, n_out / max(time.time() - t0, 1e-6))
        if tail is not None:
            wr.write(tail)
            n_out += 1
    finally:
        rd.close()
        if wr is not None:
            wr.close()
    return n_out
