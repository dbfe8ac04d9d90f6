from .trackers import StereoTrackers, init_trackers

__all__ = ["StereoTrackers", "init_trackers"]
