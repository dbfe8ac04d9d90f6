"""FLOPs per frame of Apple Depth Pro (the patch encoder over every window
of every scale, the image encoder, the FOV encoder, the neck, the fusion
stage, the depth head and the FOV head), counted from the configuration's
widths: 2 FLOPs per multiply-add of every product the architecture defines
(patch embeddings, the blocks' projections and MLPs, the attention's two
products, every convolution; a 2x2 stride-2 transposed convolution one tap
an output). Resampling, normalization and elementwise work are left out, as
they are in a model's FLOP count (``dpt_dinov2.py``'s convention)."""

from __future__ import annotations


def vit_flops(v: dict, side: int) -> float:
    """One DINOv2 over one ``side``-pixel square image (``side`` // patch
    tokens a row, plus the class token)."""
    p, c = v["patch"], v["hidden"]
    g = side // p
    n = g * g + 1
    per_block = 2.0 * n * c * c * 4 + 2.0 * 2 * n * c * c * v["mlp_ratio"] + 2.0 * 2 * n * n * c
    return 2.0 * g * g * 3 * p * p * c + v["layers"] * per_block


def window_count(size: int, ratio: float, window: int, overlap: float) -> int:
    side = int(size * ratio)
    if side == window:
        return 1
    stride = int(window * (1 - overlap))
    return ((side - window) // stride + 1) ** 2


def flops_per_frame(cfg: dict, size: int, fast_head: bool = False) -> float:
    """cfg: ``reference.depth_pro.model_cfg`` of the config; size: the square
    inference size (the image encoder's size times a power of two)."""
    im, f = cfg["image_model"], cfg["fusion"]
    n_win = sum(window_count(size, r, cfg["window"], o)
                for r, o in zip(cfg["ratios"], cfg["overlaps"]))
    total = n_win * vit_flops(cfg["patch_model"], cfg["window"])
    total += vit_flops(im, im["image_size"])

    def conv(side, cin, cout, k=1):  # a k x k convolution with ``side``^2 outputs
        return 2.0 * side * side * k * k * cin * cout

    base = im["image_size"] // im["patch"]  # the lowest scale's grid
    hid, dims, inter = cfg["patch_model"]["hidden"], cfg["dims"], cfg["inter"]
    n_scaled = len(cfg["ratios"])
    total += conv(2 * base, im["hidden"], dims[0])  # image block: one transposed conv
    sides = []
    for i, d in enumerate(dims):
        s = base * 2 ** i
        total += conv(s, hid, d) + conv(2 * s, d, d)
        sides.append(2 * s)
    top = base * 2 ** (n_scaled - 1)
    for i, d in enumerate(inter):
        mid = f if i == 0 else d
        total += conv(top, hid, mid)
        cin, s = mid, top
        for _ in range(2 + i):
            s *= 2
            total += conv(s, cin, d)
            cin = d
        sides.append(s)
    total += conv(2 * base, 2 * dims[0], dims[0])  # the image fused with the lowest scale
    chans = [*dims, *inter]  # the first is the image fused with the lowest scale
    for i, (s, d) in enumerate(zip(sides, chans)):
        if not (i == len(chans) - 1 and d == f):
            total += conv(s, d, f, 3)
    for i, s in enumerate(sides):
        last = i == len(sides) - 1
        total += (2 if i == 0 else 4) * conv(s, f, f, 3)
        out = s if last else 2 * s
        if not last:
            total += conv(out, f, f)  # the transposed conv, one tap an output
        total += conv(out, f, f)  # the 1x1 projection
    s = sides[-1]
    total += conv(s, f, f // 2, 3) + conv(2 * s, f // 2, f // 2)
    total += conv(2 * s, f // 2, 32, 3) + conv(2 * s, 32, 1)
    if cfg["use_fov"]:
        fv = cfg["fov_model"]
        total += vit_flops(fv, fv["image_size"])
        g = fv["image_size"] // fv["patch"]
        total += 2.0 * (g * g + 1) * fv["hidden"] * (f // 2)  # the neck's Linear
        total += conv(base, f, f // 2, 3)  # stride 2 from the projected global features
        s, c = base, f // 2
        for i in range(cfg["fov_layers"]):
            s = (s - 1) // 2 + 1
            total += conv(s, c, -(-f // 2 ** (i + 2)), 3)
            c = -(-f // 2 ** (i + 2))
        k = int((base - 1) / 2 ** cfg["fov_layers"] + 1)
        total += conv(s - k + 1, c, 1, k)
    return total
