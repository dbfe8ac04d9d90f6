"""Live preview: single-frame diagnostic renders, the session-file watch
loop and its web page (the reference's preview window)."""

from .diagnostics import PREVIEW_MODES, render_preview, save_preview_set
from .server import serve_preview
from .watch import watch_preview, write_session_template

__all__ = ["PREVIEW_MODES", "render_preview", "save_preview_set", "serve_preview",
           "watch_preview", "write_session_template"]
