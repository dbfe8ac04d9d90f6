"""Web control surface (`vd3d-torch serve`): the reference's tabbed Tk app
(VisionDepth3D.py) as a stdlib HTTP page and a job queue."""

from .app import make_server, run_in_thread, serve
from .jobs import Job, JobManager

__all__ = ["make_server", "run_in_thread", "serve", "Job", "JobManager"]
