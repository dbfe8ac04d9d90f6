"""vd3d-torch command line: the subcommands of ``vd3d`` but ``bench``.

    vd3d-torch render --input clip.y4m --model depth-anything-v2-small \\
        --checkpoint model.safetensors --format Full-SBS --device cuda
    vd3d-torch render --input clip.y4m --allow-random --dof_strength 2
    vd3d-torch render --input clip.y4m --allow-random --mesh dp=2 --mesh-snap-scenes
    vd3d-torch render --input clip.y4m --depth clip_depth.y4m \\
        --format "Red-Cyan Anaglyph" --preset best3d --control ctl.txt --resume
    vd3d-torch render --batch-videos in/ --batch-depths depth/ --batch-out out/
    vd3d-torch depth --input clip.y4m --checkpoint model.safetensors \\
        --dtype bfloat16 --batch-size 8 [--tiled] [--bits 16]
    vd3d-torch tools --input clip.y4m --esrgan --esrgan-weights x4.onnx \\
        --rife --rife-weights rife.onnx --dtype bfloat16
    vd3d-torch render --input clip.y4m --model dpt-large --inference-size 384 \\
        --allow-random
    vd3d-torch depth --input clip.y4m --model zoedepth-nyu --allow-random-weights
    vd3d-torch depth --input clip.y4m --model video-depth-anything --allow-random-weights
    vd3d-torch depth --input clip.y4m --model marigold --checkpoint marigold_dir/ --steps 4
    vd3d-torch depth --input clip.y4m --model depthcrafter --checkpoint dc_dir/ \\
        --window 24 --overlap 6 --target-fps 15 --dtype bfloat16
    vd3d-torch depth --input clip.y4m --model onnx:model.onnx --inference-size 512
    vd3d-torch depth --input clip.y4m --model local:weights/MyModel
    vd3d-torch render --input clip.y4m --model depth-pro --inference-size 1536 --allow-random
    vd3d-torch models [--family dpt_classic]
    vd3d-torch convert --model depth-anything-v2-small --checkpoint model.safetensors \
        --output weights/da_small        # then --model local:weights/da_small
    vd3d-torch convert --depth-in clip_depth.vd16 --depth-out clip_depth.mkv
    vd3d-torch verify-checkpoints weights/ [--report report.json]
    vd3d-torch frames --extract clip.y4m --output frames/ [--step 2]
    vd3d-torch frames --assemble frames/ --output clip.y4m --fps 24
    vd3d-torch audio rip --input movie.mkv --output audio.aac --codec aac
    vd3d-torch audio attach --video sbs.mp4 --audio audio.aac --output final.mp4
    vd3d-torch scenes --input clip.y4m [--split --output scenes/]
    vd3d-torch preview --input clip.y4m --depth clip_depth.y4m --mode anaglyph \
        [--watch session.json] [--serve 8093]
    vd3d-torch serve [--port 8765] [--device cuda]
    vd3d-torch --lang fr render ...      (or VD3D_LANG=fr)
    python -m visiondepth3d_tpu_torch render|depth|tools|models|convert|... ...

The flags keep the JAX CLI's names, meaning and help strings (translated
through the language packs, ``--lang``), plus ``--device`` (default cuda; a
missing card is an error, not a CPU fallback) on the subcommands that run a
model. ``--mesh`` spreads render, depth and tools over devices: ``dp=N``
(frame segments, batch frames, chunk frames), ``sp=M`` for render (frame
row bands) and depth (the Depth Anything family's model row-sharded: a
token-parallel ViT and a row-banded neck and head), ``tp=K`` for render
and depth (the ViT split Megatron-style), and ``pp=2[,dp=N]`` for render
(depth and stereo stages); with ``--device cpu`` the mesh is the CPU
repeated, else the visible cards (``auto``, the render and depth default,
is one device on a one-card machine). ``depth --mesh sp`` for the other
families, with ``--tiled``, with ``tp`` or for DepthCrafter raises
NotImplementedError (ROADMAP item 6d); the frame tools take dp only. As
in the JAX CLI, the fused render refuses the video and diffusion models
(video-depth-anything, marigold, depthcrafter): their depth goes through
``depth`` first. The messages the JAX CLI prints through ``t(key)`` go
through the same keys here.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

from ..config.i18n import set_language, t, th
from ..pipeline.geometry import parse_timecode, resolve_clip_window
from ..ops.formats import FORMATS
from ..pipeline.stereo_pipeline import RenderConfig, render_stereo_video
from ..stereo import StereoParams


# the families with no per-frame predictor (no ``predict_01``): the fused
# render refuses them, as the JAX CLI does
_NOT_FUSED = ("vda", "diffusion")
# the port's own help strings stay in English: the JAX CLI has no such flag
# (--device, render --resume), or its text is not true of the port (--mesh,
# tools --dtype)
_DEVICE_HELP = "torch device: cuda, cuda:N or cpu"


class _I18nParser(argparse.ArgumentParser):
    """An ArgumentParser that routes every help string through the message
    catalog (``th``: keyed by the English text, falling back to it), as the
    JAX CLI's does; subparsers inherit the class."""

    def add_argument(self, *args, **kwargs):  # noqa: D102
        if isinstance(kwargs.get("help"), str):
            kwargs["help"] = th(kwargs["help"])
        return super().add_argument(*args, **kwargs)

    def add_subparsers(self, **kwargs):
        action = super().add_subparsers(**kwargs)
        orig = action.add_parser

        def add_parser(name, **kw):
            if isinstance(kw.get("help"), str):
                kw["help"] = th(kw["help"])
            return orig(name, **kw)

        action.add_parser = add_parser
        return action


def _add_param_flags(p: argparse.ArgumentParser):
    for f in dataclasses.fields(StereoParams):
        if f.name in ("warp_hw", "max_shift_px_bound"):
            continue
        default = f.default
        if isinstance(default, bool):
            p.add_argument(f"--{f.name}", type=lambda s: s.lower() in ("1", "true", "yes"),
                           default=None, metavar="BOOL")
        elif isinstance(default, (int, float)):
            p.add_argument(f"--{f.name}", type=type(default), default=None)
        elif isinstance(default, str):
            p.add_argument(f"--{f.name}", type=str, default=None)


def build_parser() -> _I18nParser:
    """The whole argument parser (apart from ``main`` so that tests can walk
    every subcommand's help strings)."""
    from ..depth.registry import parse_inference_size

    ap = _I18nParser(prog="vd3d-torch", description="VisionDepth3D on PyTorch/CUDA")
    ap.add_argument("--lang", default=None, metavar="LANG",
                    help="message language (en/fr/de/es/ja; also "
                         "VD3D_LANG env)")
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("render", help="render a 3D video from video + depth")
    p.add_argument("--input", default=None)
    p.add_argument("--batch-videos", default=None,
                   help="directory of videos: batch mode (reference 3D-tab "
                        "paired queue); pairs <name> with <name>_depth in "
                        "--batch-depths")
    p.add_argument("--batch-depths", default=None)
    p.add_argument("--batch-out", default=None)
    p.add_argument("--depth", default=None,
                   help="precomputed depth video; omit to run the fused "
                        "single-pass 2D->3D route with --model")
    p.add_argument("--model", default="depth-anything-v2-small",
                   help="depth model for the fused route (no --depth)")
    p.add_argument("--checkpoint", default=None,
                   help="upstream weights for --model (fused route): HF .safetensors; "
                        "midas-v2 also the isl-org .pt or .onnx")
    p.add_argument("--inference-size", type=parse_inference_size, default=None,
                   metavar="N|WxH|NAME",
                   help="square int, WxH rectangle, or a named preset "
                        "(dc-max-quality, 720p, ... — the reference's "
                        "resolution catalog)")
    p.add_argument("--allow-random", action="store_true",
                   help="fused route without --checkpoint (garbage depth; "
                        "shape/compile testing only)")
    p.add_argument("--output", default=None)
    p.add_argument("--format", default="Full-SBS", choices=list(FORMATS))
    p.add_argument("--height", type=int, default=1080)
    p.add_argument("--aspect", default="Default (16:9)")
    p.add_argument("--preserve-aspect", action="store_true")
    p.add_argument("--codec", default="libx264")
    p.add_argument("--crf", type=int, default=23)
    p.add_argument("--fps", type=float, default=None)
    p.add_argument("--start", default=None,
                   help="clip start: seconds or HH:MM:SS(.ms)")
    p.add_argument("--end", default=None,
                   help="clip end: seconds or HH:MM:SS(.ms); a value <= "
                        "start is treated as a DURATION (reference "
                        "semantics)")
    p.add_argument("--chunk-size", type=int, default=16)
    p.add_argument("--skip-blank-frames", action="store_true")
    p.add_argument("--auto-crop-black-bars", action="store_true")
    p.add_argument("--resume", action="store_true",
                   help="continue an interrupted render from <output>.resume.npz")
    p.add_argument("--mesh", default="auto",
                   help="devices: 'auto' (frame-segment DP over every visible card; one "
                        "device on one card, with --device cpu or with --start/--end), "
                        "'dp=N' (N segments, no checkpoint; "
                        "the CPU N times with --device cpu), 'sp=M' (M row bands per "
                        "frame), 'tp=K' (the depth model split over K devices), combined "
                        "as 'dp=N,sp=M,tp=K'; 'pp=2[,dp=N]' (depth and stereo stages, "
                        "each N devices), 'off'")
    p.add_argument("--mesh-snap-scenes", action="store_true",
                   help="snap DP segment boundaries to scene cuts "
                        "(extra host decode pass)")
    p.add_argument("--preset", default=None,
                   help="builtin preset name or path to a preset JSON")
    p.add_argument("--control", default=None, metavar="FILE",
                   help="cooperative suspend/resume/cancel (the reference's "
                        "in-loop flag poll, render_3d.py:1195-1220): the "
                        "file is polled between chunks — write 'pause' to "
                        "suspend, 'run' (or empty) to resume, 'cancel' to "
                        "stop cleanly")
    p.add_argument("--dry-run", action="store_true",
                   help="print the resolved parameters as JSON and exit")
    p.add_argument("--device", default="cuda", help=_DEVICE_HELP)
    _add_param_flags(p)
    _add_depth_parser(sub)
    _add_frames_convert_parsers(sub)
    mp = sub.add_parser("models", help="list the depth model catalog")
    mp.add_argument("--family", default=None, help="filter by family")
    _add_tools_parser(sub)
    _add_host_tool_parsers(sub)
    vc = sub.add_parser(
        "verify-checkpoints",
        help="walk every converter family over a weights dir, smoke-test "
             "whatever artifacts are present, write a pass/fail report "
             "(first-contact readiness for real released checkpoints)")
    vc.add_argument("dir", help="directory of released checkpoints (see "
                                "utils/verify_checkpoints.py for the "
                                "expected filenames per family)")
    vc.add_argument("--report", default=None,
                    help="report JSON path (default DIR/vd3d_verify.json)")
    vc.add_argument("--device", default="cuda", help=_DEVICE_HELP)
    _add_preview_serve_parsers(sub)
    return ap


def _add_preview_serve_parsers(sub):
    from ..preview import PREVIEW_MODES

    pv = sub.add_parser("preview", help="single-frame diagnostic render")
    pv.add_argument("--input", required=True)
    pv.add_argument("--depth", required=True)
    pv.add_argument("--frame", type=int, default=0)
    pv.add_argument("--mode", default="sbs", choices=PREVIEW_MODES)
    pv.add_argument("--output-dir", default="./preview")
    pv.add_argument("--watch", default=None, metavar="SESSION_JSON",
                    help="interactive mode: watch this params file and "
                         "re-render on every save (debounced)")
    pv.add_argument("--serve", type=int, default=None, metavar="PORT",
                    help="graphical mode: serve a live web UI (preview "
                         "image + param form, two-way bound to the "
                         "session file) at http://localhost:PORT")
    pv.add_argument("--device", default="cuda", help=_DEVICE_HELP)

    sv = sub.add_parser("serve", help="full web control surface: the "
                        "reference's tabbed app (render / depth / tools / "
                        "audio / scenes) with a job queue and "
                        "suspend/resume/cancel, at http://HOST:PORT")
    sv.add_argument("--port", type=int, default=8765)
    sv.add_argument("--host", default="127.0.0.1",
                    help="bind address (0.0.0.0 exposes the app to the "
                         "network — it has no authentication)")
    sv.add_argument("--device", default="cuda", help=_DEVICE_HELP)


def _add_frames_convert_parsers(sub):
    fr = sub.add_parser("frames", help="extract video frames to a folder / "
                                       "assemble a folder back into video")
    fr.add_argument("--extract", metavar="VIDEO", default=None)
    fr.add_argument("--assemble", metavar="FOLDER", default=None)
    fr.add_argument("--output", required=True,
                    help="folder (extract) or video path (assemble)")
    fr.add_argument("--format", default="png",
                    choices=["png", "jpg", "bmp", "webp"])
    fr.add_argument("--step", type=int, default=1,
                    help="keep every Nth frame on extract")
    fr.add_argument("--fps", type=float, default=24.0,
                    help="output frame rate on assemble")

    cv = sub.add_parser("convert", help="convert an upstream checkpoint "
                                        "once into a [Local] model folder, "
                                        "or a 16-bit depth stream between "
                                        ".vd16 and FFV1 gray16le")
    cv.add_argument("--model", default=None,
                    help="catalog entry naming the architecture "
                         "(see vd3d models)")
    cv.add_argument("--checkpoint", default=None,
                    help="upstream weights (.safetensors / RIFE .onnx / "
                         "diffusers dir, whatever the family's loader "
                         "accepts)")
    cv.add_argument("--output", default=None,
                    help="folder to write model.safetensors + vd3d.json")
    cv.add_argument("--inference-size", type=int, default=518)
    cv.add_argument("--depth-in", default=None, metavar="STREAM",
                    help="16-bit depth stream to convert (.vd16 or "
                         "gray16le video)")
    cv.add_argument("--depth-out", default=None, metavar="STREAM",
                    help="converted stream (.vd16, or .mkv for FFV1 "
                         "gray16le — needs ffmpeg)")
    cv.add_argument("--device", default="cuda", help=_DEVICE_HELP)


def _add_host_tool_parsers(sub):
    au = sub.add_parser("audio", help="rip / attach audio tracks (ffmpeg)")
    asub = au.add_subparsers(dest="audio_cmd", required=True)
    ar = asub.add_parser("rip")
    ar.add_argument("--input", required=True)
    ar.add_argument("--output", required=True)
    ar.add_argument("--codec", default="copy")
    ar.add_argument("--bitrate", default=None)
    aa = asub.add_parser("attach")
    aa.add_argument("--video", required=True)
    aa.add_argument("--audio", required=True)
    aa.add_argument("--output", required=True)
    aa.add_argument("--offset", type=float, default=0.0)
    aa.add_argument("--reencode", action="store_true")

    sc = sub.add_parser("scenes", help="content-based scene detection")
    sc.add_argument("--input", required=True)
    sc.add_argument("--threshold", type=float, default=27.0)
    sc.add_argument("--split", action="store_true",
                    help="export one clip per scene (x264 .mp4 when ffmpeg "
                         "is present, matching the reference's FrameTools "
                         "split; uncompressed .y4m otherwise)")
    sc.add_argument("--codec", default="libx264",
                    help="scene-clip codec for --split (ffmpeg encoders, "
                         "e.g. libx264/libx265; 'y4m' forces uncompressed)")
    sc.add_argument("--crf", type=int, default=23,
                    help="quality for --split encoded clips")
    sc.add_argument("--output", default=None, help="scene-clip directory")


def _depth_size(spec):
    """--inference-size of ``depth``: "original" is the source resolution."""
    from ..depth.registry import parse_inference_size

    return None if str(spec).strip().lower() == "original" else parse_inference_size(spec)


def _add_depth_parser(sub):
    dp = sub.add_parser("depth", help="estimate a depth video from a 2D video")
    dp.add_argument("--input", required=True)
    dp.add_argument("--output", default=None)
    dp.add_argument("--control", default=None, metavar="FILE",
                    help="cooperative suspend/resume/cancel control file "
                         "(same contract as vd3d render --control)")
    dp.add_argument("--model", default="depth-anything-v2-small")
    dp.add_argument("--inference-size", type=_depth_size, default=518, metavar="N|WxH|NAME",
                    help="square int, WxH rectangle (e.g. 1024x576), a "
                         "named preset (dc-max-quality, "
                         "depth-anything-wide, 720p, 1080p, ...) or "
                         "'original' for source resolution; snapped per "
                         "model family")
    dp.add_argument("--batch-size", type=int, default=8)
    dp.add_argument("--invert", action="store_true")
    dp.add_argument("--bits", type=int, default=8, choices=[8, 16])
    dp.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"])
    dp.add_argument("--checkpoint", default=None,
                    help="upstream weights for --model: HF .safetensors; midas-v2 also the "
                         "isl-org .pt or .onnx; video-depth-anything the upstream .pth, "
                         ".safetensors or .onnx; marigold and depthcrafter a diffusers "
                         "checkpoint directory. --model also takes onnx:<file.onnx> and "
                         "local:<dir>")
    dp.add_argument("--steps", type=int, default=2,
                    help="diffusion denoise steps")
    dp.add_argument("--window", type=int, default=24,
                    help="DepthCrafter sliding-window size")
    dp.add_argument("--overlap", type=int, default=6,
                    help="DepthCrafter window overlap (>= --window clamps to window - 1)")
    dp.add_argument("--target-fps", type=float, default=15.0,
                    help="stride long clips down to this rate (DepthCrafter)")
    dp.add_argument("--track-letterbox", action="store_true",
                    help="detect/crop black bars and reinsert them in the "
                         "output depth")
    dp.add_argument("--allow-random-weights", action="store_true",
                    help="run without a checkpoint (shape/compile testing "
                         "only; diffusion output is noise)")
    dp.add_argument("--tiled", action="store_true",
                    help="Hann-blended tiled inference: resize to "
                         "--inference-size then run overlapping "
                         "--tile-size model tiles (high-res detail)")
    dp.add_argument("--tile-size", type=int, default=518,
                    help="model resolution per tile in tiled mode")
    dp.add_argument("--exact-head", action="store_true",
                    help="DA family: exact transformers head op order "
                    "(upsample the 32-ch tensor before the last convs) "
                    "instead of the default fast head")
    dp.add_argument("--tile-overlap", type=int, default=64,
                    help="tile overlap in working-resolution pixels")
    dp.add_argument("--mesh", default="auto",
                    help="devices: 'auto' (the batch, or DepthCrafter's windows, over every "
                         "visible card; one device on one card or with --device cpu), "
                         "'dp=N' (the CPU N times with --device cpu), 'sp=M' (each frame's "
                         "rows, and the Depth Anything model's tokens, over M devices), "
                         "'tp=K' (the model split over K devices), 'dp=N,sp=M', 'dp=N,tp=K', "
                         "'off'")
    dp.add_argument("--device", default="cuda", help=_DEVICE_HELP)


def cmd_depth(args) -> int:
    from ..pipeline.depth_pipeline import render_depth_video

    own_weights = args.model.startswith(("onnx:", "local:"))  # the weights are in the file
    if args.checkpoint is None and not args.allow_random_weights and not own_weights:
        print("vd3d-torch depth needs --checkpoint (or --allow-random-weights for testing)",
              file=sys.stderr)
        return 2
    return render_depth_video(args)


def _add_tools_parser(sub):
    from ..enhance.esrgan import ESRGAN_CATALOG

    tp = sub.add_parser("tools", help="RIFE interpolation + Real-ESRGAN upscale")
    tp.add_argument("--input", required=True)
    tp.add_argument("--output", default=None)
    tp.add_argument("--control", default=None, metavar="FILE",
                    help="cooperative suspend/resume/cancel control file "
                         "(same contract as vd3d render --control)")
    tp.add_argument("--rife", action="store_true")
    tp.add_argument("--multiplier", type=int, default=2, choices=[2, 4, 8])
    tp.add_argument("--esrgan", action="store_true")
    tp.add_argument("--esrgan-scale", type=int, default=None, choices=[2, 4],
                    help="override the inferred output scale (needed only "
                         "for KAIR-style .pth files whose unused upconv2 "
                         "makes x2 look like x4)")
    tp.add_argument("--pre-downscale", type=float, default=1.0)
    tp.add_argument("--blend", default="OFF", choices=["OFF", "LOW", "MEDIUM", "HIGH"])
    tp.add_argument("--chunk-size", type=int, default=4)
    tp.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"],
                    help="bfloat16: bf16 conv stacks (<1 u8 step output delta)")
    tp.add_argument("--esrgan-weights", "--esrgan-checkpoint", default=None,
                    dest="esrgan_weights",
                    help="RRDBNet-family checkpoint: .onnx (the formats "
                         "the reference ships), .safetensors, or torch "
                         ".pth; geometry (nf/nb/gc/scale) is inferred")
    tp.add_argument("--esrgan-model", default=None, choices=sorted(ESRGAN_CATALOG),
                    help="named upscaler from the reference's catalog "
                         "(VisionDepth3D.py:1094-1100); resolved under "
                         "--weights-dir")
    tp.add_argument("--weights-dir", default=None,
                    help="directory holding the named catalog artifacts "
                         "(default ./weights)")
    tp.add_argument("--rife-weights", default=None,
                    help="RIFE IFNet checkpoint (.onnx export, .safetensors "
                         "or torch .pth state dict)")
    tp.add_argument("--upscaled-size", action="store_true",
                    help="emit frames at the upscaled size instead of "
                         "resizing back to the source size")
    tp.add_argument("--allow-random-weights", action="store_true",
                    help="run without checkpoints (shape/compile testing "
                         "only; output is garbage)")
    tp.add_argument("--mesh", default="off",
                    help="devices: 'dp=N' splits each chunk's frames over N devices (the "
                         "CPU N times with --device cpu), 'auto' over every visible card, "
                         "'off' (default) one device")
    tp.add_argument("--device", default="cuda", help=_DEVICE_HELP)


def _control_check(args):
    """The ``cancel_check`` of ``--control FILE``, or None."""
    if not getattr(args, "control", None):
        return None
    from ..utils.observability import make_control_check

    return make_control_check(args.control)


def cmd_render(args) -> int:
    from ..config.presets import load_builtin, load_preset, params_to_dict

    if args.input is None and args.batch_videos is None:
        print("render needs --input or --batch-videos", file=sys.stderr)
        return 2
    for flag in ("start", "end"):
        value = getattr(args, flag)
        if value is not None and str(value).strip() and parse_timecode(value) is None:
            raise SystemExit(f"--{flag} {value!r}: not seconds or HH:MM:SS(.ms)")
    if args.preset:
        try:
            params, cfg = load_builtin(args.preset)
        except KeyError:
            params, cfg = load_preset(args.preset)
    else:
        params, cfg = StereoParams(), RenderConfig()
    overrides = {f.name: getattr(args, f.name) for f in dataclasses.fields(StereoParams)
                 if getattr(args, f.name, None) is not None}
    if overrides:
        params = params.replace(**overrides)
    start_s, end_s = resolve_clip_window(args.start, args.end)
    cfg = dataclasses.replace(
        cfg, output_format=args.format, output_height=args.height, aspect=args.aspect,
        preserve_original_aspect=args.preserve_aspect, codec=args.codec, crf=args.crf,
        fps=args.fps, start_s=start_s, end_s=end_s, chunk_size=args.chunk_size,
        skip_blank_frames=args.skip_blank_frames,
        auto_crop_black_bars=args.auto_crop_black_bars,
        resume=args.resume or cfg.resume, device=args.device, mesh=args.mesh,
        mesh_snap_scenes=args.mesh_snap_scenes or cfg.mesh_snap_scenes)
    cancel_check = _control_check(args)

    if args.batch_videos:
        # the paired-queue batch of video + depth videos, one after another
        from ..pipeline.batch import pair_videos_with_depth, run_batch

        items = pair_videos_with_depth(args.batch_videos,
                                       args.batch_depths or args.batch_videos,
                                       args.batch_out or args.batch_videos)
        if not items:
            print(t("batch.none"), file=sys.stderr)
            return 2
        if args.dry_run:
            print(json.dumps({"params": params_to_dict(params, cfg),
                              "items": [dataclasses.asdict(i) for i in items]}, indent=2))
            return 0
        done = run_batch(items, params, cfg,
                         progress_cb=lambda it: print(f"{it.status:9s} {it.input_path}",
                                                      flush=True),
                         cancel_check=cancel_check)
        for it in done:
            print(t("batch.item", status=it.status, input=it.input_path, frames=it.frames,
                    seconds=it.seconds) + (f" - {it.error}" if it.error else ""))
        return 0 if all(i.status == "done" for i in done) else 1

    output = args.output
    if output is None:
        tag = args.format.replace(" ", "").replace(":", "")
        output = f"{args.input.rsplit('.', 1)[0]}_{tag}.y4m"
    if args.dry_run:
        print(json.dumps({"params": params_to_dict(params, cfg), "output": output}, indent=2))
        return 0

    predictor = None
    if args.depth is None:
        from ..depth.registry import CATALOG, load_predictor

        entry = CATALOG.get(args.model)
        if entry is not None and entry.family in _NOT_FUSED:
            print(t("render.fused_family", model=args.model), file=sys.stderr)
            return 2
        own_weights = args.model.startswith(("onnx:", "local:"))  # the weights are in the file
        if args.checkpoint is None and not args.allow_random and not own_weights:
            print(t("render.fused_needs_weights"), file=sys.stderr)
            return 2
        kw = {"inference_size": args.inference_size} if args.inference_size else {}
        predictor = load_predictor(args.model, args.checkpoint, device=args.device, **kw)

    def progress(p):
        print(f"\r{p.frames_done} frames | {p.fps:.2f} fps", end="", flush=True)

    prog = render_stereo_video(args.input, args.depth, output, params, cfg,
                               progress_cb=progress, cancel_check=cancel_check,
                               predictor=predictor)
    print("\n" + t("render.done", frames=prog.frames_done, fps=prog.fps, output=output))
    return 0


def cmd_models(args) -> int:
    """The ported entries of the depth model catalog, with their
    recommended inference sizes and the reference names they cover."""
    from ..depth.registry import CATALOG, inference_resolutions

    for name, e in CATALOG.items():
        if args.family and e.family != args.family:
            continue
        res = "/".join(str(r) for r in inference_resolutions(name))
        print(f"{name:34s} {e.family:12s} sizes {res:20s} [{', '.join(e.reference_names)}]")
    return 0


def cmd_tools(args) -> int:
    import os

    from ..enhance import (ESRGAN_CATALOG, EnhanceConfig, load_esrgan_weights,
                           load_rife_weights, run_merged_pipeline)

    from ..pipeline.mesh_render import mesh_axes_for

    mesh_axes = mesh_axes_for(args.mesh, args.device)
    if mesh_axes and mesh_axes.get("sp", 1) > 1:
        raise SystemExit("vd3d tools supports only the dp mesh axis")
    cfg = EnhanceConfig(
        use_esrgan=args.esrgan, esrgan_scale=args.esrgan_scale or 4,
        pre_downscale=args.pre_downscale, keep_original_size=not args.upscaled_size,
        blend_mode=args.blend, use_rife=args.rife, fps_multiplier=args.multiplier,
        chunk_size=args.chunk_size, allow_random_weights=args.allow_random_weights,
        dtype=args.dtype)
    esrgan_params = rife_params = None
    esrgan_path, esrgan_scale = args.esrgan_weights, args.esrgan_scale
    if args.esrgan_model:
        entry = ESRGAN_CATALOG[args.esrgan_model]
        esrgan_path = os.path.join(args.weights_dir or "weights", entry["file"])
        # the catalog's scale settles what the file's names cannot
        esrgan_scale = esrgan_scale or entry["scale"]
    if esrgan_path:
        esrgan_params, ecfg = load_esrgan_weights(esrgan_path, scale=esrgan_scale)
        # geometry comes from the checkpoint, not the flags
        cfg = dataclasses.replace(
            cfg, esrgan_nf=ecfg.nf, esrgan_nb=ecfg.nb, esrgan_gc=ecfg.gc,
            esrgan_scale=ecfg.scale, esrgan_n_up=ecfg.n_up, esrgan_unshuffle=ecfg.unshuffle)
    if args.rife_weights:
        rife_params = load_rife_weights(args.rife_weights)
    output = args.output or str(args.input).rsplit(".", 1)[0] + "_enhanced.y4m"

    def progress(n, fps):
        print(f"\r{n} frames | {fps:.2f} fps", end="", flush=True)

    n = run_merged_pipeline(args.input, output, cfg, esrgan_params=esrgan_params,
                            rife_params=rife_params, progress_cb=progress,
                            mesh_axes=mesh_axes, cancel_check=_control_check(args),
                            device=args.device)
    print("\n" + t("tools.done", frames=n, output=output))
    return 0


def cmd_audio(args) -> int:
    from ..io.audio import attach_audio, rip_audio

    def progress(pct):
        print(f"\r{pct:.1f}%", end="", flush=True)

    if args.audio_cmd == "rip":
        rip_audio(args.input, args.output, args.codec, args.bitrate, progress)
    else:
        attach_audio(args.video, args.audio, args.output, args.offset, args.reencode, progress)
    print("\ndone")
    return 0


def cmd_scenes(args) -> int:
    """Scene detection; with --split, one clip per scene (the reference's
    FrameTools scene split, VisionDepth3D.py:1187-1247: an x264 .mp4 per
    scene where ffmpeg is present, an uncompressed .y4m otherwise)."""
    import os

    from ..io import ffmpeg as ff
    from ..io.video import open_video, open_writer
    from ..utils import detect_scenes

    with open_video(args.input) as rd:
        fps = rd.fps
        cuts = detect_scenes(iter(rd), threshold=args.threshold)
    print(f"{len(cuts)} scenes")
    for i, c in enumerate(cuts):
        print(f"scene {i}: frame {c} ({c / fps:.2f}s)")
    if not args.split:
        return 0
    out_dir = args.output or os.path.splitext(args.input)[0] + "_scenes"
    os.makedirs(out_dir, exist_ok=True)
    base = os.path.splitext(os.path.basename(args.input))[0]
    starts = list(cuts) or [0]
    if starts[0] != 0:
        starts.insert(0, 0)
    ext = ".y4m" if (args.codec == "y4m" or not ff.have_ffmpeg()) else ".mp4"
    n = 0
    with open_video(args.input) as rd:
        wr, idx = None, 0
        while True:
            frame = rd.read()
            if frame is None:
                break
            if n < len(starts) and idx == starts[n]:
                if wr is not None:
                    wr.close()
                path = os.path.join(out_dir, f"{base}-Scene-{n + 1:03d}{ext}")
                wr = open_writer(path, rd.width, rd.height, fps, codec=args.codec, crf=args.crf)
                n += 1
            wr.write(frame)
            idx += 1
        if wr is not None:
            wr.close()
    print(t("scene.split_done", count=n, output=out_dir))
    return 0


def cmd_frames(args) -> int:
    from ..pipeline.image_pipeline import assemble_frames, extract_frames

    if bool(args.extract) == bool(args.assemble):
        print("frames: give exactly one of --extract VIDEO / --assemble FOLDER")
        return 2
    if args.extract:
        n = extract_frames(args.extract, args.output, fmt=args.format, step=args.step)
    else:
        n = assemble_frames(args.assemble, args.output, fps=args.fps)
    print(f"{n} frames -> {args.output}")
    return 0


def _convert_depth_stream(src: str, dst: str) -> int:
    """`.vd16` <-> FFV1 gray16le conversion (the FFV1 side matches the
    reference's interoperable 16-bit export, render_depth.py:1704-1714)."""
    from ..io.depth_io import (Depth16Reader, Ffv1Gray16Reader, _is_gray16_video,
                               open_depth16_writer)

    if str(src).endswith(".vd16"):
        rd = Depth16Reader(src)
    elif _is_gray16_video(src):
        rd = Ffv1Gray16Reader(src)
    else:
        print(f"{src}: not a 16-bit depth stream (.vd16 or gray16le video)")
        return 2
    n = 0
    try:
        with open_depth16_writer(dst, rd.width, rd.height, rd.fps) as wr:
            for frame in rd:
                wr.write(frame)
                n += 1
    finally:
        rd.close()
    print(t("convert.depth_done", count=n, output=dst))
    return 0


def cmd_convert(args) -> int:
    """One-time checkpoint conversion into a ``local:`` model folder in the
    JAX package's native layout (``vd3d.json`` + a flat "a/b/c"-keyed
    ``model.safetensors`` of the family's JAX params tree, which either
    package loads); with --depth-in/--depth-out, a 16-bit depth stream
    between ``.vd16`` and FFV1 gray16le."""
    if args.depth_in or args.depth_out:
        if not (args.depth_in and args.depth_out):
            print("--depth-in and --depth-out must be given together")
            return 2
        return _convert_depth_stream(args.depth_in, args.depth_out)
    if not (args.model and args.checkpoint and args.output):
        print("checkpoint conversion needs --model, --checkpoint and "
              "--output (or use --depth-in/--depth-out for depth streams)")
        return 2
    from ..depth.convert import to_jax_params
    from ..depth.registry import CATALOG, load_predictor, save_local_params

    entry = CATALOG.get(args.model)
    if args.model.startswith(("onnx:", "local:")) or (entry and entry.family == "diffusion"):
        print(f"{args.model}: family does not expose a single params tree "
              "(diffusion pipelines load from their checkpoint dir "
              "directly — point --checkpoint at the converted dir instead)")
        return 2
    pred = load_predictor(args.model, args.checkpoint, inference_size=args.inference_size,
                          device=args.device)
    save_local_params(args.output, args.model,
                      to_jax_params(CATALOG[args.model].family, pred.model.state_dict(),
                                    pred.cfg))
    print(f"converted {args.checkpoint} -> {args.output} "
          f"(load with --model 'local:{args.output}')")
    return 0


def cmd_verify_checkpoints(args) -> int:
    import os

    from ..utils.verify_checkpoints import verify_checkpoints

    report_path = args.report or os.path.join(args.dir, "vd3d_verify.json")
    report = verify_checkpoints(args.dir, report_path, device=args.device)
    print(json.dumps({k: report[k] for k in ("dir", "passed", "failed", "missing")}))
    print(f"report: {report_path}")
    return 0 if report["failed"] == 0 else 1


def cmd_preview(args) -> int:
    """One frame's diagnostic PNG set; --watch re-renders on every save of
    a session file, --serve adds the web page over it."""
    from ..preview import save_preview_set, serve_preview, watch_preview
    from ..preview.watch import _load_frame_pair

    if args.serve is not None:
        def started(port):
            print(f"preview UI at http://localhost:{port} — "
                  "Ctrl-C (or quit:true in the session file) to stop", flush=True)

        n = serve_preview(args.input, args.depth, args.output_dir, port=args.serve,
                          session_path=args.watch, server_started=started,
                          device=args.device)
        print(f"\n{n} renders -> {args.output_dir}")
        return 0
    if args.watch:
        print(f"watching {args.watch} — edit any field and save; "
              f'set "quit": true (or Ctrl-C) to stop', flush=True)
        n = watch_preview(args.input, args.depth, args.watch, args.output_dir,
                          device=args.device)
        print(f"\n{n} renders -> {args.output_dir}")
        return 0
    frame01, depth01 = _load_frame_pair(args.input, args.depth, args.frame)
    out_dir = save_preview_set(frame01, depth01, args.output_dir, mode=args.mode,
                               device=args.device)
    print(f"preview saved to {out_dir}")
    return 0


def cmd_serve(args) -> int:
    from ..serve import serve

    serve(port=args.port, host=args.host, device=args.device)
    return 0


def main(argv=None) -> int:
    import os

    # the language is set before the parsers are built, so that --help is
    # translated; --lang is pre-scanned from the raw arguments
    raw = sys.argv[1:] if argv is None else list(argv)
    lang = os.environ.get("VD3D_LANG")
    for i, a in enumerate(raw):
        if a == "--lang" and i + 1 < len(raw):
            lang = raw[i + 1]
        elif a.startswith("--lang="):
            lang = a.split("=", 1)[1]
    if lang:
        set_language(lang)
    args = build_parser().parse_args(argv)
    return {"render": cmd_render, "depth": cmd_depth, "tools": cmd_tools,
            "models": cmd_models, "frames": cmd_frames, "convert": cmd_convert,
            "audio": cmd_audio, "scenes": cmd_scenes,
            "verify-checkpoints": cmd_verify_checkpoints, "preview": cmd_preview,
            "serve": cmd_serve}[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
