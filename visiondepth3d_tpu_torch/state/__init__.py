from .trackers import (StereoTrackers, bar_easer_update, convergence_ema_update,
                       floating_window_update, focal_tracker_update, init_trackers,
                       percentile_ema_normalize, shift_smoother_update, temporal_depth_smooth)

__all__ = ["StereoTrackers", "bar_easer_update", "convergence_ema_update",
           "floating_window_update", "focal_tracker_update", "init_trackers",
           "percentile_ema_normalize", "shift_smoother_update", "temporal_depth_smooth"]
