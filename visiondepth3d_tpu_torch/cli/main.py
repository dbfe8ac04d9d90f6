"""vd3d-torch command line: the ``render``, ``depth``, ``tools`` and
``models`` subcommands of ``vd3d``.

    vd3d-torch render --input clip.y4m --model depth-anything-v2-small \\
        --checkpoint model.safetensors --format Full-SBS --device cuda
    vd3d-torch render --input clip.y4m --allow-random --dof_strength 2
    vd3d-torch render --input clip.y4m --depth clip_depth.y4m \\
        --format "Red-Cyan Anaglyph" --preset best3d --control ctl.txt --resume
    vd3d-torch render --batch-videos in/ --batch-depths depth/ --batch-out out/
    vd3d-torch depth --input clip.y4m --checkpoint model.safetensors \\
        --dtype bfloat16 --batch-size 8 [--tiled] [--bits 16]
    vd3d-torch tools --input clip.y4m --esrgan --esrgan-weights x4.onnx \\
        --rife --rife-weights rife.onnx --dtype bfloat16
    vd3d-torch models [--family dpt_dinov2]
    python -m visiondepth3d_tpu_torch render|depth|tools|models ...

The flags keep the JAX CLI's names and meaning, plus ``--device`` (default
cuda; a missing card is an error, not a CPU fallback). Flags of features
not ported yet (render --mesh other than off; depth --mesh other than
auto/off, the diffusion and video-depth models) raise NotImplementedError.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

from ..pipeline.geometry import parse_timecode, resolve_clip_window
from ..ops.formats import FORMATS
from ..pipeline.stereo_pipeline import RenderConfig, render_stereo_video
from ..stereo import StereoParams


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


def build_parser() -> argparse.ArgumentParser:
    from ..depth.registry import parse_inference_size

    ap = argparse.ArgumentParser(prog="vd3d-torch",
                                 description="VisionDepth3D on PyTorch/CUDA")
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("render", help="render a 3D video (fused 2D->3D, or video + depth)")
    p.add_argument("--input", default=None)
    p.add_argument("--batch-videos", default=None,
                   help="directory of videos: batch mode; pairs <name> with <name>_depth "
                        "in --batch-depths")
    p.add_argument("--batch-depths", default=None)
    p.add_argument("--batch-out", default=None)
    p.add_argument("--depth", default=None,
                   help="precomputed depth video; omit to run the fused route with --model")
    p.add_argument("--model", default="depth-anything-v2-small",
                   help="depth model of the fused route (vd3d-torch models)")
    p.add_argument("--checkpoint", default=None,
                   help="HF .safetensors weights for --model (fused route)")
    p.add_argument("--inference-size", type=parse_inference_size, default=None,
                   metavar="N|WxH|NAME")
    p.add_argument("--allow-random", action="store_true",
                   help="fused route without --checkpoint (random weights; "
                        "shape and speed testing only)")
    p.add_argument("--output", default=None)
    p.add_argument("--format", default="Full-SBS", choices=list(FORMATS))
    p.add_argument("--height", type=int, default=1080)
    p.add_argument("--aspect", default="Default (16:9)")
    p.add_argument("--preserve-aspect", action="store_true")
    p.add_argument("--codec", default="libx264")
    p.add_argument("--crf", type=int, default=23)
    p.add_argument("--fps", type=float, default=None)
    p.add_argument("--start", default=None, help="clip start: seconds or HH:MM:SS(.ms)")
    p.add_argument("--end", default=None,
                   help="clip end; a value <= start is a duration")
    p.add_argument("--chunk-size", type=int, default=16)
    p.add_argument("--skip-blank-frames", action="store_true")
    p.add_argument("--auto-crop-black-bars", action="store_true")
    p.add_argument("--resume", action="store_true",
                   help="continue an interrupted render from <output>.resume.npz")
    p.add_argument("--mesh", default="off", help="only 'off' is ported")
    p.add_argument("--preset", default=None,
                   help="builtin preset name or path to a preset JSON")
    p.add_argument("--control", default=None, metavar="FILE",
                   help="polled between chunks: 'pause' suspends, 'run' (or empty) "
                        "resumes, 'cancel' stops cleanly")
    p.add_argument("--dry-run", action="store_true",
                   help="print the resolved parameters as JSON and exit")
    p.add_argument("--device", default="cuda", help="torch device: cuda, cuda:N or cpu")
    _add_param_flags(p)
    _add_depth_parser(sub)
    _add_tools_parser(sub)
    mp = sub.add_parser("models", help="list the ported depth model catalog")
    mp.add_argument("--family", default=None, help="only this family (dpt_dinov2)")
    return ap


def _depth_size(spec):
    """--inference-size of ``depth``: "original" is the source resolution."""
    from ..depth.registry import parse_inference_size

    return None if str(spec).strip().lower() == "original" else parse_inference_size(spec)


def _add_depth_parser(sub):
    dp = sub.add_parser("depth", help="estimate a depth video from a 2D video")
    dp.add_argument("--input", required=True)
    dp.add_argument("--output", default=None)
    dp.add_argument("--control", default=None, metavar="FILE",
                    help="suspend/resume/cancel control file, polled between batches")
    dp.add_argument("--model", default="depth-anything-v2-small")
    dp.add_argument("--inference-size", type=_depth_size, default=518, metavar="N|WxH|NAME",
                    help="square int, WxH, a named preset, or 'original' for the source "
                         "resolution; snapped to the patch multiple")
    dp.add_argument("--batch-size", type=int, default=8)
    dp.add_argument("--invert", action="store_true")
    dp.add_argument("--bits", type=int, default=8, choices=[8, 16])
    dp.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"])
    dp.add_argument("--checkpoint", default=None, help="HF .safetensors weights for --model")
    dp.add_argument("--steps", type=int, default=2, help="diffusion denoise steps (not ported)")
    dp.add_argument("--window", type=int, default=24,
                    help="DepthCrafter sliding-window size (not ported)")
    dp.add_argument("--overlap", type=int, default=6)
    dp.add_argument("--target-fps", type=float, default=15.0,
                    help="stride long clips down to this rate (DepthCrafter; not ported)")
    dp.add_argument("--track-letterbox", action="store_true",
                    help="detect and crop black bars, reinsert them in the output depth")
    dp.add_argument("--allow-random-weights", action="store_true",
                    help="run without --checkpoint (random weights; shape and speed testing "
                         "only)")
    dp.add_argument("--tiled", action="store_true",
                    help="Hann-blended tiled inference: resize to --inference-size, then run "
                         "overlapping --tile-size model tiles")
    dp.add_argument("--tile-size", type=int, default=518)
    dp.add_argument("--exact-head", action="store_true",
                    help="the transformers head op order instead of the fast head")
    dp.add_argument("--tile-overlap", type=int, default=64)
    dp.add_argument("--mesh", default="auto", help="'auto' or 'off' (one device)")
    dp.add_argument("--device", default="cuda", help="torch device: cuda, cuda:N or cpu")


def cmd_depth(args) -> int:
    from ..pipeline.depth_pipeline import render_depth_video

    if args.checkpoint is None and not args.allow_random_weights:
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
                    help="suspend/resume/cancel control file, polled between chunks")
    tp.add_argument("--rife", action="store_true")
    tp.add_argument("--multiplier", type=int, default=2, choices=[2, 4, 8])
    tp.add_argument("--esrgan", action="store_true")
    tp.add_argument("--esrgan-scale", type=int, default=None, choices=[2, 4],
                    help="override the inferred output scale (KAIR-style .pth files "
                         "whose unused upconv2 makes x2 look like x4)")
    tp.add_argument("--pre-downscale", type=float, default=1.0)
    tp.add_argument("--blend", default="OFF", choices=["OFF", "LOW", "MEDIUM", "HIGH"])
    tp.add_argument("--chunk-size", type=int, default=4)
    tp.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"],
                    help="bfloat16: bf16 conv stacks (<1 u8 step output delta)")
    tp.add_argument("--esrgan-weights", "--esrgan-checkpoint", default=None,
                    dest="esrgan_weights",
                    help="RRDBNet-family checkpoint: .onnx, .safetensors or torch .pth; "
                         "geometry (nf/nb/gc/scale) is inferred")
    tp.add_argument("--esrgan-model", default=None, choices=sorted(ESRGAN_CATALOG),
                    help="named upscaler from the reference's catalog, resolved under "
                         "--weights-dir")
    tp.add_argument("--weights-dir", default=None,
                    help="directory holding the named catalog artifacts (default ./weights)")
    tp.add_argument("--rife-weights", default=None,
                    help="RIFE IFNet checkpoint (.onnx, .safetensors or torch .pth)")
    tp.add_argument("--upscaled-size", action="store_true",
                    help="emit frames at the upscaled size instead of the source size")
    tp.add_argument("--allow-random-weights", action="store_true",
                    help="run without checkpoints (shape and speed testing only)")
    tp.add_argument("--mesh", default="off", help="only 'off' is ported")
    tp.add_argument("--device", default="cuda", help="torch device: cuda, cuda:N or cpu")


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
        resume=args.resume or cfg.resume, device=args.device, mesh=args.mesh)
    cancel_check = _control_check(args)

    if args.batch_videos:
        # the paired-queue batch of video + depth videos, one after another
        from ..pipeline.batch import pair_videos_with_depth, run_batch

        items = pair_videos_with_depth(args.batch_videos,
                                       args.batch_depths or args.batch_videos,
                                       args.batch_out or args.batch_videos)
        if not items:
            print("no video/depth pairs found", file=sys.stderr)
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
            print(f"{it.status}: {it.input_path} ({it.frames} frames, {it.seconds:.1f} s)"
                  + (f" - {it.error}" if it.error else ""))
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
        from ..depth.registry import load_predictor

        if args.checkpoint is None and not args.allow_random:
            print("the fused route needs --checkpoint (or --allow-random for testing)",
                  file=sys.stderr)
            return 2
        kw = {"inference_size": args.inference_size} if args.inference_size else {}
        predictor = load_predictor(args.model, args.checkpoint, device=args.device, **kw)

    def progress(p):
        print(f"\r{p.frames_done} frames | {p.fps:.2f} fps", end="", flush=True)

    prog = render_stereo_video(args.input, args.depth, output, params, cfg,
                               progress_cb=progress, cancel_check=cancel_check,
                               predictor=predictor)
    print(f"\nrendered {prog.frames_done} frames ({prog.fps:.2f} fps) -> {output}")
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

    if args.mesh not in (None, "off"):
        raise NotImplementedError("vd3d-torch tools --mesh is not ported yet (one device)")
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
                            cancel_check=_control_check(args), device=args.device)
    print(f"\nenhanced {n} frames -> {output}")
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return {"render": cmd_render, "depth": cmd_depth, "tools": cmd_tools,
            "models": cmd_models}[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
