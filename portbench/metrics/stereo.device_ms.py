"""The stereo step and packing: device milliseconds a frame of every other
operation of the chunk launches in the traced stretch (decode,
crop/resize, the stereo step, packing, u8, RGB -> YUV, the readback)."""


def read(layer: dict):
    view, frames = layer["trace"], layer["frames_traced"]
    if view is None or not frames:
        return None
    ops = [o for o in view.launched_in("launch") if not view.in_span("depth", o["launch"])]
    if not ops:
        return None
    return 1e3 * sum(o["end"] - o["start"] for o in ops) / frames
