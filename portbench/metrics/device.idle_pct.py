"""The device: the share of the traced stretch in which no operation ran
on the card (the union of the device operations' intervals, from the same
trace)."""


def read(layer: dict):
    view = layer["trace"]
    if view is None or view.window_s <= 0:
        return None
    return 100.0 * (1.0 - view.busy_s() / view.window_s)
