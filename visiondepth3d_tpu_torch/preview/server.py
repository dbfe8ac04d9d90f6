"""Graphical live-preview surface: a small stdlib HTTP viewer.

Counterpart of ``visiondepth3d_tpu/preview/server.py``. The reference
renders its preview to a Tk window with two-way slider binding
(core/preview_gui.py:41-669); here the graphical surface is a local web
page:

- GET  /            one-page UI: the preview PNG (auto-refreshing), the
                    input/depth thumbnails, and a form over every
                    StereoParams field + mode/frame;
- GET  /state       current session JSON + render counter;
- POST /update      merge a JSON body into the session file: the debounced
                    watch loop (watch.py) picks the change up and
                    re-renders through the real stereo_frame_step, like a
                    Tk slider drag;
- GET  /img/<name>  the PNG set from the output dir (no-cache).

No dependencies beyond the stdlib; any browser pointed at
``http://localhost:<port>`` works. The server has no authentication: it
binds 127.0.0.1.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

from ..device import DEFAULT_DEVICE, resolve_device

_PAGE = """<!DOCTYPE html>
<html><head><title>vd3d preview</title><style>
body {{ font-family: system-ui, sans-serif; margin: 0; display: flex;
       background: #191c20; color: #d8dce2; }}
#side {{ width: 330px; padding: 12px; overflow-y: auto; height: 100vh;
        box-sizing: border-box; background: #22262c; }}
#main {{ flex: 1; padding: 12px; }}
img.preview {{ max-width: 100%; border: 1px solid #333; }}
img.thumb {{ max-width: 49%; border: 1px solid #333; }}
label {{ display: flex; justify-content: space-between; margin: 3px 0;
        font-size: 12px; align-items: center; }}
input, select {{ width: 130px; background: #14161a; color: #d8dce2;
                border: 1px solid #444; border-radius: 3px; padding: 2px 4px; }}
h3 {{ margin: 8px 0 4px; font-size: 13px; color: #8fb7ff; }}
#status {{ font-size: 11px; color: #7a8; white-space: pre; }}
</style></head><body>
<div id="side">
  <h3>session</h3>
  <label>mode <select id="mode">{mode_options}</select></label>
  <label>frame <input id="frame" type="number" min="0" step="1"></label>
  <h3>params</h3>
  <div id="params"></div>
  <p id="status"></p>
</div>
<div id="main">
  <img class="preview" id="preview" src="/img/preview.png">
  <div><img class="thumb" id="input" src="/img/preview_input.png">
       <img class="thumb" id="depth" src="/img/preview_depth.png"></div>
</div>
<script>
let state = null, timer = null;
async function load() {{
  const r = await fetch('/state'); const s = await r.json();
  state = s.session;
  document.getElementById('mode').value = state.mode;
  document.getElementById('frame').value = state.frame;
  const box = document.getElementById('params'); box.innerHTML = '';
  for (const k of Object.keys(state).sort()) {{
    if (['mode','frame','quit'].includes(k)) continue;
    const v = state[k];
    const lab = document.createElement('label');
    lab.textContent = k + ' ';
    const inp = document.createElement('input');
    if (typeof v === 'boolean') {{ inp.type = 'checkbox'; inp.checked = v; }}
    else {{ inp.value = v; }}
    inp.id = 'p_' + k;
    inp.addEventListener('change', () => push(k, inp));
    lab.appendChild(inp); box.appendChild(lab);
  }}
  document.getElementById('mode').onchange =
    e => push('mode', e.target);
  document.getElementById('frame').onchange =
    e => push('frame', e.target);
}}
async function push(k, inp) {{
  let v;
  if (inp.type === 'checkbox') v = inp.checked;
  else if (inp.value === '' ) return;
  else v = isNaN(Number(inp.value)) ? inp.value : Number(inp.value);
  await fetch('/update', {{method: 'POST',
    body: JSON.stringify({{[k]: v}})}});
}}
async function poll() {{
  const r = await fetch('/state'); const s = await r.json();
  document.getElementById('status').textContent =
    'renders: ' + s.renders + '\\n' + (s.last || '');
  const bust = '?t=' + s.renders;
  const mode = s.session.mode;
  document.getElementById('preview').src = '/img/preview_' + mode +
    '.png' + bust;
  document.getElementById('input').src = '/img/preview_input.png' + bust;
  document.getElementById('depth').src = '/img/preview_depth.png' + bust;
}}
load(); setInterval(poll, 700);
</script></body></html>
"""


class PreviewState:
    def __init__(self, session_path, out_dir):
        self.session_path = Path(session_path)
        self.out_dir = Path(out_dir)
        self.renders = 0
        self.last = ""
        self.lock = threading.Lock()

    def on_render(self, msg):
        with self.lock:
            self.renders += 1
            self.last = msg


def _make_handler(state: PreviewState):
    from .diagnostics import PREVIEW_MODES

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, code, body: bytes, ctype="text/html"):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Cache-Control", "no-store")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/" or self.path.startswith("/index"):
                opts = "".join(f'<option value="{m}">{m}</option>'
                               for m in PREVIEW_MODES)
                self._send(200, _PAGE.format(mode_options=opts).encode())
                return
            if self.path.startswith("/state"):
                try:
                    sess = json.loads(state.session_path.read_text())
                except (OSError, json.JSONDecodeError):
                    sess = {}
                with state.lock:
                    doc = {"session": sess, "renders": state.renders,
                           "last": state.last}
                self._send(200, json.dumps(doc).encode(),
                           "application/json")
                return
            if self.path.startswith("/img/"):
                name = Path(self.path.split("?")[0]).name
                # default preview alias -> current mode file if present
                cand = sorted(state.out_dir.glob("preview_*.png"))
                p = state.out_dir / name
                if name == "preview.png" and not p.exists() and cand:
                    p = cand[0]
                if p.suffix == ".png" and p.exists():
                    self._send(200, p.read_bytes(), "image/png")
                else:
                    self._send(404, b"not rendered yet")
                return
            self._send(404, b"?")

        def do_POST(self):
            if self.path != "/update":
                self._send(404, b"?")
                return
            ln = int(self.headers.get("Content-Length", 0))
            try:
                patch = json.loads(self.rfile.read(ln) or b"{}")
                sess = json.loads(state.session_path.read_text())
                sess.update(patch)
                state.session_path.write_text(
                    json.dumps(sess, indent=2, sort_keys=True))
                self._send(200, b'{"ok": true}', "application/json")
            except Exception as e:  # bad patch: report, don't crash
                self._send(400, json.dumps(
                    {"error": str(e)}).encode(), "application/json")

    return Handler



def serve_preview(input_path, depth_path, out_dir, port: int = 8093, session_path=None,
                  max_renders=None, server_started=None, device=DEFAULT_DEVICE) -> int:
    """Run the HTTP preview UI and the watch loop. The loop runs on the
    calling thread (and renders there), the HTTP server on a daemon thread.
    Blocks until the session file's ``quit`` flips (or ``max_renders``, for
    tests); returns the number of renders. ``device``: the CUDA card unless
    "cpu" is passed; without a card the default raises before the server
    binds."""
    from .watch import watch_preview, write_session_template

    dev = resolve_device(device)
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    session_path = Path(session_path or out / "session.json")
    if not session_path.exists():
        write_session_template(session_path)
    state = PreviewState(session_path, out)

    httpd = ThreadingHTTPServer(("127.0.0.1", port), _make_handler(state))
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    try:
        if server_started is not None:
            server_started(httpd.server_address[1])
        return watch_preview(input_path, depth_path, session_path, out,
                             max_renders=max_renders, status_cb=state.on_render,
                             device=dev)
    finally:
        httpd.shutdown()
        httpd.server_close()
