"""Depth Pro's encoders: device milliseconds a frame of the operations
launched inside the program's spans ``depth.patch_encoder`` (the ViT-L over
every window of every scale), ``depth.image_encoder`` (the ViT-L on the
whole image) and ``depth.fov`` (the FOV encoder and its small head), in the
traced stretch."""

from portbench.core.program_spans import device_ms_per_frame


def read(layer: dict):
    return device_ms_per_frame(layer, "depth.patch_encoder", "depth.image_encoder", "depth.fov")
