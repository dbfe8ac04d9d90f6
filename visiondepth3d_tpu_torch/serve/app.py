"""`vd3d-torch serve`: the whole graphical control surface, as a local web
app.

Counterpart of ``visiondepth3d_tpu/serve/app.py``. The reference's main
window is a three-tab Tk app (Depth / 3D / Frame Tools,
VisionDepth3D.py:668-2659) plus an audio Toplevel (core/audio.py:177-324)
and a live preview window. Here it is one stdlib HTTP page with the same
tabs: forms generated from the same dataclasses as the CLI's flags, a job
queue with live progress and ETA, and suspend/resume/cancel buttons wired to
the pipelines' cooperative ``cancel_check`` contract (the reference's
suspend_flag/cancel_flag Events, render_3d.py:1195-1220).

The server owns one device: ``make_server(device=...)`` resolves it before
the server binds (the CUDA card unless "cpu" is passed; without a card the
default raises) and every job runs on it, on the job manager's worker
thread. No dependencies beyond the stdlib; point a browser at
``http://localhost:<port>``. The server has no authentication: it binds
127.0.0.1 unless told otherwise. Start it with ``vd3d-torch serve [--port
N] [--device cuda]``.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ..config.i18n import available_languages, catalog, current_language, t
from ..device import DEFAULT_DEVICE, resolve_device
from .jobs import Job, JobManager

# ---------------------------------------------------------------------------
# schema: dataclass -> form/coercion spec (the CLI generates its flags from
# the same dataclasses, cli/main.py:_add_param_flags)
# ---------------------------------------------------------------------------

# ``device`` is the server's, never a form's
_SKIP_FIELDS = {"warp_hw", "max_shift_px_bound", "rife_scales", "device"}


def _field_spec(f) -> dict | None:
    default = f.default
    if isinstance(default, dataclasses._MISSING_TYPE):
        factory = getattr(f, "default_factory", None)
        if isinstance(factory, dataclasses._MISSING_TYPE) or factory is None:
            return None
        default = factory()
    if isinstance(default, bool):
        kind = "bool"
    elif isinstance(default, int):
        kind = "int"
    elif isinstance(default, float):
        kind = "float"
    elif isinstance(default, str):
        kind = "str"
    elif default is None:
        kind = "str?"  # optional, coerced contextually
    else:
        return None
    return {"name": f.name, "kind": kind, "default": default}


def schema_of(cls) -> list[dict]:
    out = []
    for f in dataclasses.fields(cls):
        if f.name in _SKIP_FIELDS:
            continue
        spec = _field_spec(f)
        if spec is not None:
            out.append(spec)
    return out


def _truthy(v) -> bool:
    return v if isinstance(v, bool) else str(v).lower() in ("1", "true", "yes", "on")


def coerce_params(cls, params: dict) -> dict:
    """Filter ``params`` to ``cls`` fields and coerce string form values to
    the field's default type (bools accept '1'/'true'/'yes'/'on'). A start
    or end that is not seconds or HH:MM:SS(.ms) raises, as the CLI's does."""
    from ..depth.registry import parse_inference_size
    from ..pipeline.geometry import parse_timecode

    out = {}
    specs = {s["name"]: s for s in schema_of(cls)}
    for k, v in params.items():
        s = specs.get(k)
        if s is None or v is None or v == "":
            continue
        kind = s["kind"]
        if kind == "bool":
            out[k] = _truthy(v)
        elif k == "inference_size":
            # square int, "WxH" rectangle, or a named preset: the CLI's
            # spec language
            out[k] = parse_inference_size(v)
        elif k in ("start_s", "end_s"):
            out[k] = parse_timecode(v)
            if out[k] is None:
                raise ValueError(f"{k} {v!r}: not seconds or HH:MM:SS(.ms)")
        elif kind == "int":
            out[k] = int(v)
        elif kind == "float":
            out[k] = float(v)
        else:
            out[k] = str(v)
    return out


def _default_output(inp: str, suffix: str) -> str:
    return inp.rsplit(".", 1)[0] + suffix


# ---------------------------------------------------------------------------
# job runners (one per tab); each takes the job and the server's device
# ---------------------------------------------------------------------------


def _run_render(job: Job, device) -> str:
    from ..config.presets import load_builtin, load_preset
    from ..pipeline.geometry import resolve_clip_window
    from ..pipeline.stereo_pipeline import RenderConfig, RenderProgress, render_stereo_video
    from ..stereo import StereoParams

    p = job.params
    params = StereoParams()
    if p.get("preset"):
        try:
            params, cfg = load_builtin(p["preset"])
        except KeyError:
            params, cfg = load_preset(p["preset"])
    else:
        cfg = RenderConfig()
    overrides = coerce_params(StereoParams, p)
    if overrides:
        params = params.replace(**overrides)
    cfg = dataclasses.replace(cfg, **coerce_params(RenderConfig, p), device=str(device))
    if cfg.start_s is not None or cfg.end_s is not None:
        start_s, end_s = resolve_clip_window(cfg.start_s, cfg.end_s)
        cfg = dataclasses.replace(cfg, start_s=start_s, end_s=end_s)

    inp = p["input"]
    depth = p.get("depth") or None
    tag = cfg.output_format.replace(" ", "").replace(":", "")
    output = p.get("output") or _default_output(inp, f"_{tag}.y4m")

    predictor = None
    if depth is None:
        # the predictor the CLI builds for the same flags (cli/main.py
        # cmd_render), so a served render equals `vd3d-torch render`'s
        from ..depth.registry import load_predictor, parse_inference_size

        model = p.get("model") or "depth-anything-v2-small"
        own_weights = model.startswith(("onnx:", "local:"))  # the weights are in the file
        if not p.get("checkpoint") and not _truthy(p.get("allow_random", False)) \
                and not own_weights:
            raise ValueError(t("error.fused_needs_checkpoint"))
        kw = {}
        if p.get("inference_size"):
            kw["inference_size"] = parse_inference_size(p["inference_size"])
        predictor = load_predictor(model, p.get("checkpoint") or None, device=device, **kw)
        if not hasattr(predictor, "predict_01"):
            raise ValueError(t("error.fused_needs_feedforward", model=model))

    def progress(pr: RenderProgress):
        job.progress.update(frames=pr.frames_done, total=pr.total_frames,
                            fps=round(pr.fps, 2), eta_s=pr.eta_seconds())

    render_stereo_video(inp, depth, job.stage(output), params, cfg, progress_cb=progress,
                        predictor=predictor, cancel_check=job.cancel_check())
    return output


def _run_depth(job: Job, device) -> str:
    from ..pipeline.depth_pipeline import DepthConfig, render_depth_video_file

    p = job.params
    cfg = DepthConfig(**coerce_params(DepthConfig, p), device=str(device))
    inp = p["input"]
    ext = ".vd16" if cfg.bits == 16 else ".y4m"
    output = p.get("output") or _default_output(inp, "_depth" + ext)

    def progress(n, fps):
        job.progress.update(frames=n, fps=round(fps, 2))

    render_depth_video_file(inp, job.stage(output), cfg, progress_cb=progress,
                            cancel_check=job.cancel_check())
    return output


def _run_tools(job: Job, device) -> str:
    from ..enhance import (EnhanceConfig, load_esrgan_weights, load_rife_weights,
                           run_merged_pipeline)

    p = job.params
    cfg = EnhanceConfig(**coerce_params(EnhanceConfig, p))
    inp = p["input"]
    output = p.get("output") or _default_output(inp, "_enhanced.y4m")

    esrgan_params = rife_params = None
    if p.get("esrgan_weights"):
        # scale=None: the geometry comes from the checkpoint. The form posts
        # every field with the schema default pre-filled ("4"), so an
        # explicit scale cannot be told from the untouched default, and "4"
        # would refuse a valid x2 checkpoint. Ambiguous KAIR .pth files
        # (unused upconv2) need the CLI's --esrgan-scale.
        esrgan_params, ecfg = load_esrgan_weights(p["esrgan_weights"])
        cfg = dataclasses.replace(
            cfg, esrgan_nf=ecfg.nf, esrgan_nb=ecfg.nb, esrgan_gc=ecfg.gc,
            esrgan_scale=ecfg.scale, esrgan_n_up=ecfg.n_up, esrgan_unshuffle=ecfg.unshuffle)
    if p.get("rife_weights"):
        rife_params = load_rife_weights(p["rife_weights"])

    def progress(n, fps):
        job.progress.update(frames=n, fps=round(fps, 2))

    run_merged_pipeline(inp, job.stage(output), cfg, esrgan_params=esrgan_params,
                        rife_params=rife_params, progress_cb=progress,
                        cancel_check=job.cancel_check(), device=device)
    return output


def _run_audio(job: Job, device) -> str:
    from ..io.audio import attach_audio, rip_audio

    p = job.params
    codec = p.get("codec") or "copy"

    def progress(pct):
        job.progress.update(percent=round(pct, 1))

    if p.get("mode") == "attach":
        out = p.get("output") or _default_output(p["input"], "_audio.mp4")
        attach_audio(p["input"], p["audio"], job.stage(out),
                     offset_s=float(p.get("offset", 0.0)), reencode=codec != "copy",
                     progress_cb=progress)
    else:
        out = p.get("output") or _default_output(p["input"], "_audio.m4a")
        rip_audio(p["input"], job.stage(out), codec=codec, bitrate=p.get("bitrate") or None,
                  progress_cb=progress)
    return out


def _run_scenes(job: Job, device) -> str:
    from ..io import ffmpeg as ff
    from ..io.video import open_video, open_writer
    from ..utils.scene_detect import detect_scenes

    p = job.params
    inp = p["input"]
    threshold = float(p.get("threshold", 27.0))
    with open_video(inp) as rd:
        fps = rd.fps
        cuts = detect_scenes(iter(rd), threshold=threshold)
    job.progress["scenes"] = len(cuts)
    if not _truthy(p.get("split", False)):
        job.progress["cuts"] = cuts[:500]
        return ""
    out_dir = p.get("output") or os.path.splitext(inp)[0] + "_scenes"
    staged = job.stage(out_dir)
    os.makedirs(staged, exist_ok=True)
    base = os.path.splitext(os.path.basename(inp))[0]
    starts = list(cuts) or [0]
    if starts[0] != 0:
        starts.insert(0, 0)
    check = job.cancel_check()
    codec = p.get("codec") or "libx264"
    ext = ".y4m" if (codec == "y4m" or not ff.have_ffmpeg()) else ".mp4"
    n = 0
    with open_video(inp) as rd:
        wr, idx = None, 0
        try:
            while True:
                frame = rd.read()
                if frame is None:
                    break
                if n < len(starts) and idx == starts[n]:
                    if wr is not None:
                        wr.close()
                        wr = None
                    if check():
                        return out_dir
                    path = os.path.join(staged, f"{base}-Scene-{n + 1:03d}{ext}")
                    wr = open_writer(path, rd.width, rd.height, fps, codec=codec)
                    n += 1
                wr.write(frame)
                idx += 1
        finally:
            if wr is not None:
                wr.close()
    job.progress["clips"] = n
    return out_dir


RUNNERS = {
    "render": _run_render,
    "depth": _run_depth,
    "tools": _run_tools,
    "audio": _run_audio,
    "scenes": _run_scenes,
}


def build_meta(lang: str | None = None) -> dict:
    """Everything the page needs to render its forms: per-tab field specs,
    the model catalog, preset names, the output formats and the message
    catalog for ``lang`` (the Tk GUI's refresh_ui_labels analog,
    VisionDepth3D.py:2762-2902: every label, tooltip and status resolves
    through the same packs as the CLI's)."""
    from ..config.presets import BUILTIN_PRESETS
    from ..depth.registry import CATALOG
    from ..enhance import EnhanceConfig
    from ..io.audio import AUDIO_CODECS
    from ..ops.formats import FORMATS
    from ..pipeline.depth_pipeline import DepthConfig
    from ..pipeline.stereo_pipeline import RenderConfig
    from ..stereo import StereoParams

    return {
        "render": {
            "config": schema_of(RenderConfig),
            "params": schema_of(StereoParams),
            "formats": list(FORMATS),
            "presets": sorted(BUILTIN_PRESETS),
        },
        "depth": {
            "config": schema_of(DepthConfig),
            "models": [{"name": n, "family": e.family} for n, e in CATALOG.items()],
        },
        "tools": {"config": schema_of(EnhanceConfig)},
        "audio": {"codecs": sorted(AUDIO_CODECS)},
        "scenes": {"config": [
            {"name": "threshold", "kind": "float", "default": 27.0},
            {"name": "split", "kind": "bool", "default": False},
            {"name": "codec", "kind": "str", "default": "libx264"},
        ]},
        "i18n": catalog(lang or current_language(), prefixes=("ui.", "field.", "tooltip.")),
        "lang": lang or current_language(),
        "languages": available_languages(),
    }


# ---------------------------------------------------------------------------
# HTTP layer
# ---------------------------------------------------------------------------

_PAGE = """<!DOCTYPE html>
<html><head><title>VisionDepth3D</title><style>
body { font-family: system-ui, sans-serif; margin: 0; background: #191c20;
       color: #d8dce2; }
#tabs { display: flex; background: #22262c; border-bottom: 1px solid #333; }
#tabs button { background: none; color: #9aa3ad; border: 0; padding: 10px
  16px; font-size: 14px; cursor: pointer; }
#tabs button.active { color: #8fb7ff; border-bottom: 2px solid #8fb7ff; }
.tab { display: none; padding: 16px; max-width: 760px; }
.tab.active { display: block; }
label { display: flex; justify-content: space-between; margin: 3px 0;
        font-size: 12px; align-items: center; max-width: 380px; }
input, select { width: 170px; background: #14161a; color: #d8dce2;
  border: 1px solid #444; border-radius: 3px; padding: 3px 5px; }
input[type=checkbox] { width: auto; }
button.go { margin-top: 10px; background: #2b5fad; color: #fff; border: 0;
  border-radius: 4px; padding: 7px 18px; cursor: pointer; }
h3 { margin: 14px 0 4px; font-size: 13px; color: #8fb7ff; }
details { margin: 6px 0; } summary { font-size: 13px; color: #8fb7ff;
  cursor: pointer; }
table { border-collapse: collapse; width: 100%; font-size: 12px; }
td, th { border-bottom: 1px solid #333; padding: 5px 8px; text-align:
  left; }
.jbtn { background: #333; color: #ccc; border: 0; border-radius: 3px;
  padding: 2px 8px; margin-right: 3px; cursor: pointer; font-size: 11px; }
.st-running { color: #7ec97e; } .st-error { color: #e06c75; }
.st-paused { color: #e5c07b; } .st-done { color: #8fb7ff; }
</style></head><body>
<div id="tabs"></div>
<div id="content"></div>
<script>
const TABS = ["render", "depth", "tools", "audio", "scenes", "jobs"];
let META = null;

function T(key) {  // catalog lookup, key itself as last-resort fallback
  return (META && META.i18n && META.i18n[key]) || key;
}

function el(tag, attrs, ...kids) {
  const e = document.createElement(tag);
  for (const [k, v] of Object.entries(attrs || {}))
    if (k.startsWith("on")) e.addEventListener(k.slice(2), v);
    else e.setAttribute(k, v);
  for (const k of kids) e.append(k);
  return e;
}

function fieldRow(tab, spec) {
  const id = tab + "__" + spec.name;
  let input;
  if (spec.kind === "bool")
    input = el("input", {type: "checkbox", id});
  else
    input = el("input", {id, value: spec.default === null ? "" :
                         String(spec.default)});
  if (spec.kind === "bool" && spec.default) input.checked = true;
  const attrs = {};
  const tip = META.i18n["tooltip." + spec.name];
  if (tip) attrs.title = tip;
  return el("label", attrs, T("field." + spec.name) + " ", input);
}

function collect(tab, specs, extraIds) {
  const out = {};
  for (const s of specs) {
    const n = document.getElementById(tab + "__" + s.name);
    if (!n) continue;
    out[s.name] = s.kind === "bool" ? n.checked : n.value;
  }
  for (const x of extraIds || []) {
    const n = document.getElementById(tab + "__" + x);
    if (n) out[x] = n.type === "checkbox" ? n.checked : n.value;
  }
  return out;
}

async function submit(kind, params) {
  const r = await fetch("/api/jobs", {method: "POST",
    headers: {"Content-Type": "application/json"},
    body: JSON.stringify({kind, params})});
  if (r.ok) showTab("jobs"); else alert(await r.text());
}

function pathRows(tab, names) {
  return names.map(n => el("label", {}, T("field." + n) + " ",
    el("input", {id: tab + "__" + n})));
}

function buildForms() {
  const c = document.getElementById("content");
  c.innerHTML = "";
  // render tab
  const rt = el("div", {class: "tab", id: "tab-render"});
  rt.append(el("h3", {}, T("ui.h.render")), ...pathRows("render",
    ["input", "depth", "output", "checkpoint"]));
  const presetSel = el("select", {id: "render__preset"});
  presetSel.append(el("option", {value: ""}, T("ui.none")));
  for (const p of META.render.presets)
    presetSel.append(el("option", {value: p}, p));
  rt.append(el("label", {}, T("field.preset") + " ", presetSel));
  rt.append(el("h3", {}, T("ui.section.config")));
  for (const s of META.render.config) rt.append(fieldRow("render", s));
  const det = el("details", {}, el("summary", {}, T("ui.section.params")));
  for (const s of META.render.params) det.append(fieldRow("render", s));
  rt.append(det);
  rt.append(el("button", {class: "go", onclick: () => submit("render",
    Object.assign(collect("render", META.render.config, ["input", "depth",
      "output", "checkpoint", "preset"]),
      collect("render", META.render.params)))}, T("ui.btn.render")));
  c.append(rt);
  // depth tab
  const dt = el("div", {class: "tab", id: "tab-depth"});
  dt.append(el("h3", {}, T("ui.h.depth")),
    ...pathRows("depth", ["input", "output"]));
  const msel = el("select", {id: "depth__model"});
  for (const m of META.depth.models)
    msel.append(el("option", {value: m.name}, m.name + " (" + m.family +
      ")"));
  dt.append(el("label", {}, T("field.model") + " ", msel));
  for (const s of META.depth.config)
    if (s.name !== "model") dt.append(fieldRow("depth", s));
  dt.append(el("button", {class: "go", onclick: () => submit("depth",
    collect("depth", META.depth.config, ["input", "output", "model"]))},
    T("ui.btn.depth")));
  c.append(dt);
  // tools tab
  const tt = el("div", {class: "tab", id: "tab-tools"});
  tt.append(el("h3", {}, T("ui.h.tools")),
    ...pathRows("tools", ["input", "output", "esrgan_weights",
                          "rife_weights"]));
  for (const s of META.tools.config) tt.append(fieldRow("tools", s));
  tt.append(el("button", {class: "go", onclick: () => submit("tools",
    collect("tools", META.tools.config, ["input", "output",
      "esrgan_weights", "rife_weights"]))}, T("ui.btn.tools")));
  c.append(tt);
  // audio tab
  const at = el("div", {class: "tab", id: "tab-audio"});
  at.append(el("h3", {}, T("ui.h.audio")),
    ...pathRows("audio", ["input", "audio", "output"]));
  const modeSel = el("select", {id: "audio__mode"},
    el("option", {value: "rip"}, "rip"),
    el("option", {value: "attach"}, "attach"));
  at.append(el("label", {}, T("field.mode") + " ", modeSel));
  const csel = el("select", {id: "audio__codec"});
  csel.append(el("option", {value: "copy"}, "copy"));
  for (const cd of META.audio.codecs)
    csel.append(el("option", {value: cd}, cd));
  at.append(el("label", {}, T("field.codec") + " ", csel));
  at.append(el("label", {}, T("field.bitrate") + " ",
    el("input", {id: "audio__bitrate"})));
  at.append(el("label", {}, T("field.offset") + " ",
    el("input", {id: "audio__offset", value: "0"})));
  at.append(el("button", {class: "go", onclick: () => submit("audio",
    collect("audio", [], ["input", "audio", "output", "mode", "codec",
      "bitrate", "offset"]))}, T("ui.btn.audio")));
  c.append(at);
  // scenes tab
  const st = el("div", {class: "tab", id: "tab-scenes"});
  st.append(el("h3", {}, T("ui.h.scenes")),
    ...pathRows("scenes", ["input", "output"]));
  for (const s of META.scenes.config) st.append(fieldRow("scenes", s));
  st.append(el("button", {class: "go", onclick: () => submit("scenes",
    collect("scenes", META.scenes.config, ["input", "output"]))},
    T("ui.btn.scenes")));
  c.append(st);
  // jobs tab
  c.append(el("div", {class: "tab", id: "tab-jobs"},
    el("table", {id: "jobtable"})));
}

function showTab(name) {
  for (const t of TABS) {
    document.getElementById("tab-" + t).classList.toggle("active",
      t === name);
    document.getElementById("tabbtn-" + t).classList.toggle("active",
      t === name);
  }
}

async function refreshJobs() {
  const r = await fetch("/api/jobs");
  const jobs = await r.json();
  const tbl = document.getElementById("jobtable");
  if (!tbl) return;
  tbl.innerHTML = "";
  tbl.append(el("tr", {}, ...["id", "kind", "status", "progress", "output",
    "control"].map(h => el("th", {}, T("ui.col." + h)))));
  for (const j of jobs.reverse()) {
    const prog = j.progress.frames !== undefined ?
      (j.progress.frames + " " + T("ui.frames") + " @ " +
       (j.progress.fps || 0) + " fps" +
       (j.progress.eta_s ? " " + T("ui.eta") + " " +
        Math.round(j.progress.eta_s) + "s" : "")) :
      JSON.stringify(j.progress);
    const ctl = el("td", {});
    for (const a of ["pause", "resume", "cancel"])
      ctl.append(el("button", {class: "jbtn", onclick: () =>
        fetch("/api/jobs/" + j.id + "/control", {method: "POST",
          headers: {"Content-Type": "application/json"},
          body: JSON.stringify({action: a})})}, T("ui.job." + a)));
    tbl.append(el("tr", {},
      el("td", {}, String(j.id)), el("td", {}, j.kind),
      el("td", {class: "st-" + j.status}, T("ui.status." + j.status)),
      el("td", {}, prog),
      el("td", {}, j.error || j.output || ""), ctl));
  }
}

function buildChrome() {
  const tabs = document.getElementById("tabs");
  tabs.innerHTML = "";
  for (const t of TABS)
    tabs.append(el("button", {id: "tabbtn-" + t,
      onclick: () => showTab(t)}, T("ui.tab." + t)));
  const lsel = el("select", {id: "langsel", title: T("ui.lang"),
    onchange: () => setLang(lsel.value)});
  for (const l of META.languages)
    lsel.append(el("option", {value: l}, l));
  lsel.value = META.lang;
  lsel.style.cssText = "width:auto;margin:6px 8px 6px auto;";
  tabs.append(lsel);
}

async function setLang(lang) {
  localStorage.setItem("vd3d_lang", lang);
  META = await (await fetch("/api/meta?lang=" + lang)).json();
  buildChrome();
  buildForms();
  showTab("render");
}

async function init() {
  const lang = localStorage.getItem("vd3d_lang");
  META = await (await fetch("/api/meta" +
    (lang ? "?lang=" + lang : ""))).json();
  buildChrome();
  buildForms();
  showTab("render");
  setInterval(refreshJobs, 1000);
  refreshJobs();
}
init();
</script></body></html>
"""


class _Handler(BaseHTTPRequestHandler):
    manager: JobManager = None  # set by make_server
    meta: dict = None
    _meta_cache: dict = None  # per-language meta, built on demand

    def log_message(self, *a):  # quiet
        pass

    def _json(self, obj, code=200):
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.send_header("Cache-Control", "no-store")
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        if self.path in ("/", "/index.html"):
            body = _PAGE.encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/html; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        elif self.path.split("?")[0] == "/api/meta":
            from urllib.parse import parse_qs, urlsplit

            q = parse_qs(urlsplit(self.path).query)
            lang = (q.get("lang") or [None])[0]
            if lang and lang != self.meta["lang"]:
                if lang not in self.meta["languages"]:
                    return self._json({"error": f"unknown lang {lang!r}"},
                                      400)
                meta = self._meta_cache.get(lang)
                if meta is None:
                    meta = self._meta_cache[lang] = build_meta(lang)
                return self._json(meta)
            self._json(self.meta)
        elif self.path == "/api/jobs":
            self._json(self.manager.snapshot())
        else:
            self._json({"error": "not found"}, 404)

    def do_POST(self):
        n = int(self.headers.get("Content-Length", 0))
        try:
            body = json.loads(self.rfile.read(n) or b"{}")
        except json.JSONDecodeError:
            return self._json({"error": "bad json"}, 400)
        if self.path == "/api/jobs":
            kind = body.get("kind")
            params = body.get("params") or {}
            if kind not in RUNNERS:
                return self._json(
                    {"error": t("error.unknown_kind", kind=repr(kind))}, 400)
            if not params.get("input"):
                return self._json({"error": t("error.input_required")}, 400)
            job = self.manager.submit(kind, params)
            return self._json(job.snapshot(), 201)
        if self.path.startswith("/api/jobs/") and self.path.endswith(
                "/control"):
            try:
                job_id = int(self.path.split("/")[3])
            except (IndexError, ValueError):
                return self._json({"error": "bad job id"}, 400)
            action = body.get("action", "")
            try:
                ok = self.manager.control(job_id, action)
            except ValueError as e:
                return self._json({"error": str(e)}, 400)
            if not ok:
                return self._json({"error": "no such job"}, 404)
            return self._json({"ok": True})
        self._json({"error": "not found"}, 404)




def make_server(port: int = 0, host: str = "127.0.0.1", device=DEFAULT_DEVICE):
    """Build (but don't run) the server; returns (httpd, manager). Port 0
    binds an ephemeral port (tests). ``device`` is resolved first: without
    a card the default raises before anything binds or starts."""
    dev = resolve_device(device)
    manager = JobManager({kind: functools.partial(fn, device=dev)
                          for kind, fn in RUNNERS.items()})
    handler = type("Handler", (_Handler,),
                   {"manager": manager, "meta": build_meta(), "_meta_cache": {}})
    try:
        httpd = ThreadingHTTPServer((host, port), handler)
    except OSError:
        manager.shutdown()
        raise
    return httpd, manager


def serve(port: int = 8765, host: str = "127.0.0.1", device=DEFAULT_DEVICE) -> None:
    httpd, manager = make_server(port, host, device)
    print(f"vd3d-torch serve: http://{host}:{httpd.server_address[1]} on {device} "
          "(tabs: render / depth / tools / audio / scenes / jobs)")
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        manager.shutdown()
        httpd.server_close()


def run_in_thread(port: int = 0, host: str = "127.0.0.1", device=DEFAULT_DEVICE):
    """Start the server on a daemon thread (tests, embedding). Returns
    (httpd, manager, port)."""
    httpd, manager = make_server(port, host, device)
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    return httpd, manager, httpd.server_address[1]
