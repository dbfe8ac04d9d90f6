"""Merged frame-tools pipeline: upscale + interpolate + encode.

Counterpart of ``visiondepth3d_tpu/enhance/pipeline.py`` on one device:
frames -> Real-ESRGAN upscale (optional pre-downscale, blend modes, resize
back to the source size) -> RIFE in-betweens -> writer at fps x multiplier.
Chunks overlap by one frame so RIFE keeps its pair context across chunk
boundaries; a short last chunk is padded by repeating its last frame, so
every chunk has the same shape.

``mesh_axes={"dp": N}`` splits each chunk's frames over N devices, as the
JAX package shards the chunk's frame axis: ESRGAN is per frame and RIFE
per pair of neighbours, so each device takes a contiguous run of the
chunk's pairs (its frames overlap the next run's by one frame) with its
own replica of both models, and the runs' outputs are joined in order.
Every device's run is launched before any is read back.
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


def _split_runs(t: int, parts: int, paired: bool) -> list[tuple[int, int]]:
    """[start, end) frame runs of a t-frame chunk for ``parts`` devices:
    contiguous and disjoint, or (``paired``: RIFE needs each frame's right
    neighbour) runs of whole pairs, each sharing its last frame with the
    next run's first. At most one run per frame (pair)."""
    units = t - 1 if paired else t
    parts = max(1, min(parts, units))
    cuts = [round(i * units / parts) for i in range(parts + 1)]
    return [(cuts[i], cuts[i + 1] + int(paired)) for i in range(parts)]


def make_mesh_enhance_fn(cfg: EnhanceConfig, esrgan_params, rife_params,
                         in_hw: tuple[int, int], devices) -> Callable:
    """The chunk function over a device list (a device may repeat): u8 host
    frames [T, H, W, 3] -> u8 host frames, as ``make_enhance_fn``'s on one
    device. Each run of ``_split_runs`` goes to its device's replica."""
    fns = {d: make_enhance_fn(cfg, esrgan_params, rife_params, in_hw, d)
           for d in dict.fromkeys(devices)}
    paired = cfg.use_rife and cfg.fps_multiplier > 1

    def fn(frames_u8: torch.Tensor) -> torch.Tensor:
        runs = _split_runs(frames_u8.shape[0], len(devices), paired)
        outs = [fns[d](frames_u8[a:b].to(d, non_blocking=True))
                for (a, b), d in zip(runs, devices)]
        # a run's last frame opens the next run: keep it once
        outs = [o[:-1] if paired and i < len(outs) - 1 else o for i, o in enumerate(outs)]
        return torch.cat([o.cpu() for o in outs])

    return fn


def run_merged_pipeline(input_path, output_path, cfg: EnhanceConfig | None = None,
                        esrgan_params=None, rife_params=None,
                        progress_cb: Callable | None = None,
                        mesh_axes: dict[str, int] | None = None,
                        cancel_check: Callable | None = None,
                        device=DEFAULT_DEVICE, devices=None) -> int:
    """Video -> enhanced video; returns the number of frames written.

    Overlapping chunks keep RIFE's pair context: each chunk shares its first
    frame with the previous chunk's last. ``cancel_check`` is polled between
    chunks. ``device``: the CUDA card unless "cpu" is passed; without a card
    the default raises. Missing weights are ``init_enhance_params(cfg)``'s
    seeded random ones when ``cfg.allow_random_weights``. ``mesh_axes={"dp":
    N}`` splits each chunk's frames over N devices: ``devices`` when given
    (a device may repeat), the CPU N times when ``device`` is the CPU, else
    the visible cards. Each device runs its share of the chunk's pairs in
    one call, so the output equals one device's at ``chunk_size / N`` bit
    for bit; at the whole ``chunk_size`` the library convs round by batch
    size (RIFE's transpose conv on the card) and the frames may differ.
    Pick chunk_size >= N for even use of the devices.
    """
    cfg = cfg or EnhanceConfig()
    axes = dict(mesh_axes or {})
    if any(int(v) > 1 for k, v in axes.items() if k != "dp"):
        raise ValueError(f"frame tools mesh {axes}: the frame tools support only the dp mesh "
                         f"axis (as in the JAX package: no sp or tp route)")
    dp = int(axes.get("dp", 1))
    missing = (cfg.use_esrgan and esrgan_params is None) or (
        cfg.use_rife and rife_params is None)
    if missing and not cfg.allow_random_weights:
        raise ValueError(
            "enhance models need converted checkpoints (convert_esrgan / convert_rife); "
            "pass allow_random_weights=True only for shape/compile testing — random "
            "weights produce garbage frames")
    dev = resolve_device(device)
    mesh_devs = None
    if dp > 1:
        from ..pipeline.mesh_render import mesh_devices

        mesh_devs = mesh_devices(dp, dev, devices)
        if dp > len(mesh_devs):
            raise ValueError(f"mesh dp={dp} needs {dp} devices, have {len(mesh_devs)}")
        mesh_devs = mesh_devs[:dp]
    if missing:
        ep, rp = init_enhance_params(cfg)
        esrgan_params = ep if esrgan_params is None else esrgan_params
        rife_params = rp if rife_params is None else rife_params
    rd = open_video(input_path)
    wr = None
    try:
        if mesh_devs is None:
            one = make_enhance_fn(cfg, esrgan_params, rife_params, (rd.height, rd.width), dev)

            def fn(frames_u8):
                return one(frames_u8.to(dev)).cpu()
        else:
            fn = make_mesh_enhance_fn(cfg, esrgan_params, rife_params, (rd.height, rd.width),
                                      mesh_devs)
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
            out = fn(torch.from_numpy(np.stack(batch))).numpy()
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
