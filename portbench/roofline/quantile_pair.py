"""K3, the 2 %/98 % and stretch quantile pairs (``kernels/csrc/stats.cu``),
twice a frame: on the smoothed depth at the eye size and on the curved
depth at the warp size. As ``chip_smoke.py`` counts it: one read of the map
(float32) and the two results; 12 bisection steps of a compare and a count
a pixel."""

KERNEL = "quantile_pair_kernel"


def launches(layer: dict) -> list[tuple[float, float, str]]:
    g = layer["geometry"]
    return [(24.0 * h * w, 4.0 * h * w + 8, "float32")
            for h, w in ((g["eye_h"], g["eye_w"]), (g["warp_h"], g["warp_w"]))]
