"""The depth model: device milliseconds a frame of the operations launched
inside the predictor's ``predict_01`` (span ``depth``) in the traced
stretch."""


def read(layer: dict):
    view, frames = layer["trace"], layer["frames_traced"]
    if view is None or not frames or "depth" not in view.spans:
        return None
    ops = view.launched_in("depth")
    if not ops:
        return None
    return 1e3 * sum(o["end"] - o["start"] for o in ops) / frames
