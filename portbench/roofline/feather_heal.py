"""K2, feather and heal (``kernels/csrc/postfx.cu``), once a frame at the
warp size. Bytes as ``chip_smoke.py`` counts them: read both eyes and the
frame (3 values each) and both warped depths, write both eyes (17 values a
pixel). Operations per eye: feathering 6 (depth gradient) + 2 (mask) +
k^2 + 1 (the k x k box) + 9 (lerp), healing 5 + 6 + 1 + 26 + 12 + 30 + 9
(gray, gradient, threshold, 5 x 5 box, blend, 3 x 3 soften, blend);
``chip_smoke.py``'s 376 is both at k = 9."""

KERNEL = "feather_heal_kernel"


def launches(layer: dict) -> list[tuple[float, float, str]]:
    st = layer["stereo"]
    if not (st["enable_feathering"] or st["enable_healing"]):
        return []
    h, w = layer["geometry"]["warp_h"], layer["geometry"]["warp_w"]
    k = st["blur_ksize"]
    per_eye = ((6 + 2 + k * k + 1 + 9) if st["enable_feathering"] else 0) + \
        ((5 + 6 + 1 + 26 + 12 + 30 + 9) if st["enable_healing"] else 0)
    return [(2.0 * per_eye * h * w, 17.0 * h * w * layer["image_bytes"], "float32")]
