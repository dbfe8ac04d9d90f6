"""The render's stereo stage, frame by frame, with its cross-frame trackers,
and the Full-SBS packing: a plain frozen copy of the render's semantics at
the parameters the benchmark's mixes use.

Per frame (the upstream VisionDepth3D render loop, as the program states
it): temporal depth smoothing (alpha 0.5); the 2 % / 98 % quantiles by a
12-step bisection on exact counts and their EMA (alpha 0.92); the shift
smoother (alpha 0.15) and the variance-driven parallax scale; the curvature
dome; the subject depth (60 % centre crop, 64-bin peak blended 70/30 with
the masked lower median); Pop-Control shaping; the layered shift map with
subject-locked zero parallax, floating window and edge-mask suppression;
the dual-eye two-tap warp of frame and depth; feathering (and healing when
on); the focal tracker; the colour grade; the floating-window side bars;
sharpening. Options the mixes do not use (depth of field, parity
quantization, exact quantiles) raise.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from . import resize
from .precision import Mat


@dataclasses.dataclass(frozen=True)
class Params:
    """The stereo parameters and their defaults (the render's CLI defaults)."""

    fg_shift: float = 8.0
    mg_shift: float = -3.0
    bg_shift: float = -6.0
    sharpness_factor: float = 1.0
    feather_strength: float = 10.0
    max_pixel_shift_percent: float = 0.02
    parallax_balance: float = 0.8
    zero_parallax_strength: float = 0.0
    convergence_strength: float = 0.0
    ipd_factor: float = 1.0
    depth_pop_gamma: float = 0.85
    depth_pop_mid: float = 0.50
    depth_stretch_lo: float = 0.05
    depth_stretch_hi: float = 0.95
    fg_pop_multiplier: float = 1.20
    bg_push_multiplier: float = 1.10
    subject_lock_strength: float = 1.00
    color_saturation: float = 1.0
    color_contrast: float = 1.0
    color_brightness: float = 0.0
    heal_strength: float = 0.5
    curvature_strength: float = 0.08
    blur_ksize: int = 9
    dof_strength: float = 0.0
    use_subject_tracking: bool = True
    enable_floating_window: bool = True
    enable_edge_masking: bool = True
    enable_feathering: bool = True
    enable_dynamic_convergence: bool = True
    enable_healing: bool = False
    enable_curvature: bool = True
    enable_dynamic_parallax: bool = True
    quantile_mode: str = "hist"
    image_dtype: str = "float32"
    parity_quantize: bool = False

    def __post_init__(self):
        if self.dof_strength > 0 or self.parity_quantize or self.quantile_mode != "hist" \
                or self.image_dtype != "float32":
            raise NotImplementedError("the reference covers the float32 render without depth "
                                      "of field, parity quantization or exact quantiles")


TRACKER_FIELDS = ("initialized", "prev_depth", "prev_norm_depth", "norm_lo", "norm_hi",
                  "norm_init", "conv_val", "conv_init", "fg", "mg", "bg", "shift_init",
                  "fw_offset", "fw_counter", "bar_width", "focal", "focal_init")


def init_trackers(h: int, w: int, device) -> dict:
    t = {k: torch.zeros((), device=device) for k in TRACKER_FIELDS}
    for k in ("initialized", "norm_init", "conv_init", "shift_init", "focal_init"):
        t[k] = torch.zeros((), dtype=torch.bool, device=device)
    t["fw_counter"] = torch.zeros((), dtype=torch.int32, device=device)
    t["prev_depth"] = torch.zeros((h, w), device=device)
    t["prev_norm_depth"] = torch.zeros((h, w), device=device)
    return t


# ---------------------------------------------------------------- statistics

def bisect_quantiles(x: torch.Tensor, qs, mask=None, iters: int = 12) -> torch.Tensor:
    """Quantiles of values in [0, 1]: 12 halvings of [0, 1], each keeping the
    half where count(x <= mid) / count reaches q (exact 0/1 sums)."""
    q = torch.as_tensor(qs, dtype=torch.float32, device=x.device).reshape(-1)
    flat = x.reshape(-1)
    m = None if mask is None else mask.reshape(-1).to(torch.float32)
    count = float(flat.numel()) if m is None else torch.clamp(m.sum(), min=1.0)
    lo, hi = torch.zeros_like(q), torch.ones_like(q)
    for _ in range(iters):
        mid = (lo + hi) * 0.5
        sums = []
        for i in range(q.numel()):
            le = (flat <= mid[i]).to(torch.float32)
            sums.append((le if m is None else le * m).sum())
        right = torch.stack(sums) / count < q
        lo, hi = torch.where(right, mid, lo), torch.where(right, hi, mid)
    return (lo + hi) * 0.5


def subject_depth(depth: torch.Tensor) -> torch.Tensor:
    h, w = depth.shape
    crop = depth[h // 5: h * 4 // 5, w // 5: w * 4 // 5]
    valid = (crop > 0.05) & (crop < 0.95)
    idx = torch.floor(crop.reshape(-1) * 64).to(torch.int64).clamp(0, 63)
    hist = torch.zeros(64, device=depth.device).index_add_(
        0, idx, valid.reshape(-1).to(torch.float32))
    count = valid.to(torch.float32).sum()
    n = torch.clamp(count, min=1.0)
    median = bisect_quantiles(crop, (torch.floor((n - 1.0) / 2.0) + 1.0) / n, valid)[0]
    peak = (torch.argmax(hist).to(torch.float32) + 0.5) / 64
    smoothed = torch.clamp(0.7 * peak + 0.3 * median, 0.0, 1.0)
    return torch.where(count < 20, 0.5, smoothed)


def parallax_scale(depth: torch.Tensor, lo: float = 0.90, hi: float = 1.15) -> torch.Tensor:
    h, w = depth.shape
    crop = depth[h // 4: h * 3 // 4, w // 4: w * 3 // 4]
    n = crop.numel()
    mean = crop.sum(dim=-1).sum() / n
    var = ((crop - mean) ** 2).sum(dim=-1).sum() / max(n - 1, 1)
    return lo + torch.clamp(var / (mean + 1e-5), 0.0, 1.0) * (hi - lo)


def motion(prev: torch.Tensor, cur: torch.Tensor) -> torch.Tensor:
    diff = torch.abs(cur - prev)
    return torch.clamp(diff.sum(dim=-1).sum() / diff.numel() * 4.0, 0.0, 1.0)


# ---------------------------------------------------------------- filters

def box_blur(x: torch.Tensor, k: int) -> torch.Tensor:
    """k x k mean of the last two axes, zeros outside counted."""
    if k <= 1:
        return x
    pad = k // 2
    h, w = x.shape[-2], x.shape[-1]
    xp = F.pad(x, (0, 0, pad, k - 1 - pad))
    acc = xp[..., 0:h, :]
    for o in range(1, k):
        acc = acc + xp[..., o:o + h, :]
    xp = F.pad(acc, (pad, k - 1 - pad))
    acc = xp[..., 0:w]
    for o in range(1, k):
        acc = acc + xp[..., o:o + w]
    return acc / float(k * k)


def grad(d: torch.Tensor):
    dx = F.pad(d[:, 1:] - d[:, :-1], (1, 0))
    dy = F.pad(d[1:, :] - d[:-1, :], (0, 0, 1, 0))
    return dx, dy


def sharpen(x: torch.Tensor, factor: float) -> torch.Tensor:
    s = 1.0 + factor
    wc, wx = ((5.0 + factor) / s, -1.0 / s) if s != 0.0 else (5.0 + factor, -1.0)
    up = torch.cat([x[1:2], x[:-1]], dim=0)
    down = torch.cat([x[1:], x[-2:-1]], dim=0)
    left = torch.cat([x[:, 1:2], x[:, :-1]], dim=1)
    right = torch.cat([x[:, 1:], x[:, -2:-1]], dim=1)
    return (wc * x + wx * (up + down + left + right)).clamp(0.0, 1.0)


def grade(p: Params, rgb: torch.Tensor) -> torch.Tensor:
    luma = (0.2126 * rgb[..., 0] + 0.7152 * rgb[..., 1] + 0.0722 * rgb[..., 2])[..., None]
    sat = luma + (rgb - luma) * p.color_saturation
    return torch.clamp(0.5 + (sat - 0.5) * p.color_contrast + p.color_brightness, 0.0, 1.0)


def side_mask(img, bar, sign):
    w = img.shape[1]
    cols = torch.arange(w, dtype=torch.float32, device=img.device)[None, :, None]
    keep = torch.where(sign < 0, cols >= bar, torch.where(sign > 0, cols < (w - bar), True))
    return img * keep.to(img.dtype)


# ---------------------------------------------------------------- the warp

def sample_row(img: torch.Tensor, src_x: torch.Tensor) -> torch.Tensor:
    """Linear sample along the row (border clamped) at float columns src_x."""
    w = img.shape[1]
    src_x = torch.clamp(src_x, 0.0, w - 1.0)
    x0 = torch.floor(src_x).to(torch.int64).clamp(0, w - 1)
    x1 = (x0 + 1).clamp(0, w - 1)
    frac = src_x - x0.to(src_x.dtype)
    if img.ndim == 3:
        frac = frac[..., None]
        g0 = torch.gather(img, 1, x0[..., None].expand(-1, -1, img.shape[2]))
        g1 = torch.gather(img, 1, x1[..., None].expand(-1, -1, img.shape[2]))
    else:
        g0, g1 = torch.gather(img, 1, x0), torch.gather(img, 1, x1)
    return g0 * (1.0 - frac) + g1 * frac


def feather(p: Params, eye, orig, warped_depth):
    dx, dy = grad(warped_depth)
    edge = torch.clamp(torch.sqrt(dx * dx + dy * dy) * p.feather_strength, 0.0, 1.0)
    blend = box_blur(edge, p.blur_ksize)[..., None]
    return torch.clamp(eye * (1.0 - blend) + orig * blend, 0.0, 1.0)


def heal(p: Params, eye, orig, threshold: float = 0.05):
    dx, dy = grad(eye.mean(dim=-1))
    missing = torch.clamp(box_blur((torch.sqrt(dx * dx + dy * dy) > threshold).float(), 5),
                          0.0, 1.0)[..., None]
    healed = (1.0 - p.heal_strength * missing) * eye + p.heal_strength * missing * orig
    soft = box_blur(healed.permute(2, 0, 1), 3).permute(1, 2, 0)
    return torch.clamp((1.0 - 0.3 * missing) * healed + 0.3 * missing * soft, 0.0, 1.0)


# ---------------------------------------------------------------- one frame

def smoothed(t: dict, depth01: torch.Tensor) -> torch.Tensor:
    """The temporal depth filter (alpha 0.5) of one frame."""
    return 0.5 * torch.where(t["initialized"], t["prev_depth"], depth01) + 0.5 * depth01


def frame_step(p: Params, mm: Mat, t: dict, frame: torch.Tensor, depth01: torch.Tensor,
               warp_hw) -> tuple[dict, torch.Tensor, torch.Tensor]:
    """One frame [H, W, 3] with its depth [H, W] in [0, 1] -> (trackers,
    left, right), the eyes [H', W', 3] at the warp size."""
    t_in, t = t, dict(t)
    one = torch.ones((), dtype=torch.bool, device=frame.device)

    # temporal smoothing and the percentile EMA
    depth_s = smoothed(t, depth01)
    t["prev_depth"] = depth_s
    d = torch.clamp(depth_s, 0.0, 1.0)
    q = bisect_quantiles(d, (0.02, 0.98))
    degen = (q[1] - q[0]) < 1e-5
    a = 0.92
    lo = torch.where(t["norm_init"], a * t["norm_lo"] + (1 - a) * q[0], q[0])
    hi = torch.where(t["norm_init"], a * t["norm_hi"] + (1 - a) * q[1], q[1])
    lo, hi = torch.where(degen, t["norm_lo"], lo), torch.where(degen, t["norm_hi"], hi)
    t["norm_init"] = torch.where(degen, t["norm_init"], one)
    t["norm_lo"], t["norm_hi"] = lo, hi
    depth_n = torch.where(degen, d, torch.clamp((d - lo) / (hi - lo + 1e-6), 0.0, 1.0))

    # shift smoother, parallax scale
    shifts = []
    for k, v in (("fg", p.fg_shift), ("mg", p.mg_shift), ("bg", p.bg_shift)):
        new = torch.full((), v, device=frame.device)
        t[k] = torch.where(t["shift_init"], 0.15 * new + (1 - 0.15) * t[k], new)
        shifts.append(t[k])
    t["shift_init"] = one
    dyn = parallax_scale(depth_n) if p.enable_dynamic_parallax else 1.0
    ipd = 1.0 if p.ipd_factor == 0.0 else p.ipd_factor
    fg, mg, bg = (s * dyn * ipd for s in shifts)

    # the DIBR core at the warp size
    wf, wd = frame, depth_n
    if tuple(warp_hw) != tuple(frame.shape[:2]):
        wf = resize.bilinear(mm, frame, warp_hw, hwc=True)
        wd = resize.bilinear(mm, depth_n, warp_hw, hwc=False)
    if p.enable_curvature:
        h, w = wd.shape
        yy = torch.linspace(-1.0, 1.0, h, device=wd.device)[:, None]
        xx = torch.linspace(-1.0, 1.0, w, device=wd.device)[None, :]
        wd = wd + (1.0 - (xx * xx + yy * yy)) * p.curvature_strength
    wd = torch.clamp(wd, 0.0, 1.0)
    subj_raw = subject_depth(wd)
    qs = bisect_quantiles(wd, (p.depth_stretch_lo, p.depth_stretch_hi))
    sdeg = (qs[1] - qs[0]) < 1e-5
    stretched = torch.where(sdeg, wd, torch.clamp((wd - qs[0]) / (qs[1] - qs[0] + 1e-6), 0, 1))
    subj_c = torch.clamp(subj_raw, 0.0, 1.0)
    subj_s = torch.where(sdeg, subj_c, torch.clamp((subj_c - qs[0]) / (qs[1] - qs[0] + 1e-6),
                                                   0.0, 1.0))
    x = (stretched - subj_s + p.depth_pop_mid) - p.depth_pop_mid
    shaped = torch.clamp(torch.sign(x) * torch.abs(x) ** p.depth_pop_gamma + p.depth_pop_mid,
                         0.0, 1.0)
    subj = subject_depth(shaped)

    width = shaped.shape[-1]
    half = width / 2.0
    zero_parallax = None
    if p.use_subject_tracking:
        adj = subj * p.parallax_balance
        zero_parallax = ((-adj * fg * p.fg_pop_multiplier) + (-adj * mg)
                         + (adj * bg * p.bg_push_multiplier)) / half
        zero_parallax = zero_parallax * p.subject_lock_strength - p.zero_parallax_strength
        if p.enable_floating_window:
            zero_parallax = torch.clamp(zero_parallax * torch.clamp(1.0 - subj * 2.0, 0.5, 1.0),
                                        -0.35, 0.35)
            prev = t["fw_offset"]
            small = torch.abs(zero_parallax - prev) < 0.0015
            upd = 0.97 * prev + (1 - 0.97) * zero_parallax
            counter = t["fw_counter"] + 1
            now = counter >= 100
            upd = torch.where(now, torch.clamp(upd, -1.0, 1.0), upd)
            counter = torch.where(now, torch.zeros_like(counter), counter)
            t["fw_offset"] = zero_parallax = torch.where(small, prev, upd)
            t["fw_counter"] = torch.where(small, t["fw_counter"], counter)
    conv_bias = (subj * p.convergence_strength if p.enable_dynamic_convergence
                 else p.convergence_strength)
    fgw = torch.clamp((1.0 - shaped) ** 1.5, 0.0, 1.0)
    mgw = torch.clamp(1.0 - torch.abs(shaped - p.depth_pop_mid) * 3.0, 0.0, 1.0)
    bgw = torch.clamp(shaped, 0.0, 1.0)
    shift = (fgw * fg * p.fg_pop_multiplier + mgw * mg + bgw * bg * p.bg_push_multiplier)
    shift = shift * p.parallax_balance / half
    if zero_parallax is not None:
        shift = shift - zero_parallax
    bound = (width * p.max_pixel_shift_percent) / half
    shift = torch.clamp(shift, -bound, bound) - conv_bias / half
    if p.enable_edge_masking:
        strength = min(max(p.feather_strength / 10.0, 0.05), 0.3)
        dx, dy = grad(shaped)
        dx, dy = torch.abs(dx), torch.abs(dy)
        edge = 1.0 / (1.0 + torch.exp(-((torch.sqrt(dx * dx + dy * dy) - 0.02)
                                        * p.feather_strength * 5.0)))
        shift = (1.0 - strength) * shift + strength * (shift * box_blur(1.0 - edge, 5))

    cols = torch.arange(width, dtype=torch.float32, device=shift.device)[None, :]
    delta = shift * (width - 1) / 2.0
    left, right = sample_row(wf, cols + delta), sample_row(wf, cols - delta)
    dleft, dright = sample_row(shaped, cols + delta), sample_row(shaped, cols - delta)
    if p.enable_feathering:
        left, right = feather(p, left, wf, dleft), feather(p, right, wf, dright)
    if p.enable_healing:
        left, right = heal(p, left, wf), heal(p, right, wf)

    # focal tracker on the normalized depth, then the grade
    cand = subject_depth(depth_n)
    mot = torch.where(t["initialized"], motion(t_in["prev_norm_depth"], depth_n), 0.0)
    alpha = 0.10 + 0.20 * torch.clamp(mot, 0.0, 1.0)
    focal = t["focal"]
    c = torch.where(torch.abs(cand - focal) < 0.03, focal, cand)
    step = torch.clamp((1.0 - alpha) * focal + alpha * c - focal, -0.02, 0.02)
    t["focal"] = torch.where(t["focal_init"], torch.clamp(focal + step, 0.0, 1.0), cand)
    t["focal_init"] = one
    left, right = grade(p, left), grade(p, right)

    # convergence EMA and the floating window's side bars
    ew = left.shape[1]
    raw = (-cand * fg - cand * mg + cand * bg) / (ew / 2.0 + 1e-6)
    stable = torch.where(t["conv_init"], 0.97 * t["conv_val"] + (1 - 0.97) * raw, raw)
    t["conv_val"], t["conv_init"] = stable, one
    if p.enable_floating_window and p.use_subject_tracking:
        eased = torch.floor(0.85 * t["bar_width"] + (1 - 0.85) * torch.floor(
            torch.abs(stable) * ew * 0.75))
        t["bar_width"] = eased
        bar = torch.clamp(eased, 0.0, 80.0)
        sign = torch.where(stable > 0.005, 1.0, torch.where(stable < -0.005, -1.0, 0.0))
        left, right = side_mask(left, bar, sign), side_mask(right, bar, sign)

    left, right = sharpen(left, p.sharpness_factor), sharpen(right, p.sharpness_factor)
    t["prev_norm_depth"] = depth_n
    t["initialized"] = one
    return t, left, right


def shift_bound(p: Params, width: int) -> int:
    return int(math.ceil(p.max_pixel_shift_percent * width)) + 2
