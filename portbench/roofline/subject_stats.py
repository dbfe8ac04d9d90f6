"""K4, the subject statistics of the 60 % centre crop (``kernels/csrc/stats.cu``),
three times a frame: the curved and the shaped depth at the warp size, the
normalized depth at the eye size. As ``chip_smoke.py`` counts it: one read
of the crop (float32) and 66 values written; 42 operations a pixel (valid
band 3, 64-bin index 3, 12 bisection steps of 3)."""

KERNEL = "subject_stats_kernel"


def _crop(h: int, w: int) -> int:
    return (h * 4 // 5 - h // 5) * (w * 4 // 5 - w // 5)


def launches(layer: dict) -> list[tuple[float, float, str]]:
    g = layer["geometry"]
    out = []
    for h, w in ((g["warp_h"], g["warp_w"]), (g["warp_h"], g["warp_w"]),
                 (g["eye_h"], g["eye_w"])):
        n = _crop(h, w)
        out.append((42.0 * n, 4.0 * n + 4 * 66, "float32"))
    return out
