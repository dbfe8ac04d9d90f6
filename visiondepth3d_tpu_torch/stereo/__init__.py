from .params import StereoParams

__all__ = ["StereoParams"]
