"""FLOPs per frame of the Depth Anything family (DINOv2 ViT, DPT neck and
relative head), counted from the configuration's widths: 2 FLOPs per
multiply-add of every product the architecture defines (patch embedding,
the blocks' projections and MLPs, the attention's two products, the neck's
and head's convolutions). Resampling, normalization and elementwise work
are left out, as they are in a model's FLOP count."""

from __future__ import annotations


def flops_per_frame(cfg: dict, size: int, fast_head: bool = False) -> float:
    """cfg: ``reference.depth_anything.model_cfg`` of the config; size: the
    square inference size (snapped to the patch)."""
    p, c = cfg["patch"], cfg["hidden"]
    g = size // p
    n = g * g + 1
    total = 2.0 * g * g * 3 * p * p * c
    per_block = 2.0 * n * c * c * 4 + 2.0 * 2 * n * c * c * cfg["mlp_ratio"] + 2.0 * 2 * n * n * c
    total += cfg["layers"] * per_block
    f = cfg["fusion"]
    sides = []
    for ch, fac in zip(cfg["neck"], cfg["factors"]):
        total += 2.0 * g * g * c * ch  # 1x1 projection
        if fac > 1:
            side = int(fac) * g
            total += 2.0 * side * side * ch * ch  # stride = kernel: one tap a output
        elif fac < 1:
            side = (g - 1) // int(1 / fac) + 1
            total += 2.0 * side * side * 9 * ch * ch
        else:
            side = g
        total += 2.0 * side * side * 9 * ch * f  # the neck's 3x3 convolution
        sides.append(side)
    conv3 = 2.0 * 9 * f * f  # a 3x3 F -> F convolution, per pixel
    rev = sides[::-1]
    for idx, side in enumerate(rev):
        convs = 2 if idx == 0 else 4
        total += convs * conv3 * side * side
        out = rev[idx + 1] if idx + 1 < len(rev) else 2 * side
        total += 2.0 * out * out * f * f  # the 1x1 projection after the upsample
    fused = 2 * rev[-1]
    total += 2.0 * fused * fused * 9 * f * (f // 2)  # head conv1
    head = fused if fast_head else g * p
    total += 2.0 * head * head * (9 * (f // 2) * cfg["head_hidden"] + cfg["head_hidden"])
    return total
