"""The render loop: host milliseconds a frame to enqueue a chunk (the chunk
function's call, ``pipeline/stereo_pipeline.py``), from the benchmark's
``dispatch`` spans over the window's chunks outside the traced stretch."""


def read(layer: dict):
    frames = layer["untraced_frames"]
    if not frames:
        return None
    return 1e3 * layer["spans"].total_s("dispatch", layer["untraced_chunks"]) / frames
