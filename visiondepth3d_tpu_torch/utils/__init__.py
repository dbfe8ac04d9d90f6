from .observability import (FpsMeter, RenderControl, install_crash_logging, make_control_check,
                            profiler_trace, stage_timer)
from .scene_detect import content_score, detect_scenes, scenes_to_spans

__all__ = ["FpsMeter", "RenderControl", "install_crash_logging", "make_control_check",
           "profiler_trace", "stage_timer", "content_score", "detect_scenes", "scenes_to_spans"]
