"""Media I/O: host milliseconds a frame in the program's y4m plane reader
(``io/y4m.py``), from the benchmark's ``read`` spans over the window's
chunks outside the traced stretch (where the profiler does not slow the
host)."""


def read(layer: dict):
    frames = layer["untraced_frames"]
    if not frames:
        return None
    return 1e3 * layer["spans"].total_s("read", layer["untraced_chunks"]) / frames
