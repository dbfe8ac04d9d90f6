"""K1, the dual-eye warp (``kernels/csrc/warp.cu``), once a frame at the
warp size. As ``chip_smoke.py`` counts it: read the frame (3 values), the
depth (image type) and the shift (float32), write two eyes and two depths
(2 x 4 values); 38 operations a pixel."""

KERNEL = "stereo_warp_kernel"


def launches(layer: dict) -> list[tuple[float, float, str]]:
    """(operations, bytes, type) of each launch in one frame."""
    h, w = layer["geometry"]["warp_h"], layer["geometry"]["warp_w"]
    s = layer["image_bytes"]
    return [(38.0 * h * w, h * w * (12.0 * s + 4), "float32")]
