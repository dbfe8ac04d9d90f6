"""Depth Pro's decoder: device milliseconds a frame of the operations
launched inside the program's span ``depth.fusion`` (the neck's projections
and transposed convolutions, the fusion stage up to 768^2 and the head at
1536^2), in the traced stretch."""

from portbench.core.program_spans import device_ms_per_frame


def read(layer: dict):
    return device_ms_per_frame(layer, "depth.fusion")
