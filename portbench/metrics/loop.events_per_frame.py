"""The render loop: device operations (kernels, copies, sets) launched a
frame, counted in the trace from inside the traced stretch's chunk
launches (a count: it repeats exactly on the same program)."""


def read(layer: dict):
    view, frames = layer["trace"], layer["frames_traced"]
    if view is None or not frames:
        return None
    n = len(view.launched_in("launch"))
    return n / frames if n else None
