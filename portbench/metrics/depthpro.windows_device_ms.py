"""Depth Pro's windows: device milliseconds a frame of the operations
launched inside the program's spans ``depth.windows`` (the rescales of the
image and its split into overlapping windows) and ``depth.merge`` (the
windows' features merged back, seams trimmed), in the traced stretch."""

from portbench.core.program_spans import device_ms_per_frame


def read(layer: dict):
    return device_ms_per_frame(layer, "depth.windows", "depth.merge")
