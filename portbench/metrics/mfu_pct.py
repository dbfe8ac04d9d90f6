"""The whole step's share of the card's peak: the model's FLOPs a frame
(``portbench/flops/<family>.py``, from the configuration's widths) times
the frames the traced stretch rendered, over the stretch's wall time, over
the peak of the configuration's type (float32 on the CUDA cores: 67
TFLOP/s; TF32 where the configuration allows it)."""

from portbench.core.peaks import PEAK_FLOPS
from portbench.core.spec import flops_model


def read(layer: dict):
    view, frames = layer["trace"], layer["frames_traced"]
    if view is None or not frames or view.window_s <= 0:
        return None
    per_frame = flops_model(layer["family"], layer["pkg"]).flops_per_frame(
        layer["model"], layer["inference_size"], layer.get("fast_head", False))
    peak = PEAK_FLOPS["tf32" if layer.get("tf32") else layer["dtype"]]
    return 100.0 * per_frame * frames / view.window_s / peak
