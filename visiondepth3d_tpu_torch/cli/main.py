"""vd3d-torch command line: the ``render`` subcommand of ``vd3d``.

    vd3d-torch render --input clip.y4m --model depth-anything-v2-small \\
        --checkpoint model.safetensors --format Full-SBS --device cuda
    python -m visiondepth3d_tpu_torch render ...

The flags keep the JAX CLI's names and meaning, plus ``--device`` (default
cuda; a missing card is an error, not a CPU fallback). Flags of features
not ported yet (--mesh other than off, --skip-blank-frames,
--auto-crop-black-bars) raise NotImplementedError.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

from ..pipeline.geometry import parse_timecode, resolve_clip_window
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
    p.add_argument("--input", required=True)
    p.add_argument("--depth", default=None,
                   help="precomputed depth video; omit to run the fused route with --model")
    p.add_argument("--model", default="depth-anything-v2-small")
    p.add_argument("--checkpoint", default=None,
                   help="HF .safetensors weights for --model (fused route)")
    p.add_argument("--inference-size", type=parse_inference_size, default=None,
                   metavar="N|WxH|NAME")
    p.add_argument("--allow-random", action="store_true",
                   help="fused route without --checkpoint (random weights; "
                        "shape and speed testing only)")
    p.add_argument("--output", default=None)
    p.add_argument("--format", default="Full-SBS",
                   choices=["Half-SBS", "Full-SBS", "VR", "Red-Cyan Anaglyph",
                            "Passive Interlaced"])
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
    p.add_argument("--mesh", default="off", help="only 'off' is ported")
    p.add_argument("--device", default="cuda", help="torch device: cuda, cuda:N or cpu")
    _add_param_flags(p)
    return ap


def cmd_render(args) -> int:
    for flag in ("start", "end"):
        value = getattr(args, flag)
        if value is not None and str(value).strip() and parse_timecode(value) is None:
            raise SystemExit(f"--{flag} {value!r}: not seconds or HH:MM:SS(.ms)")
    overrides = {f.name: getattr(args, f.name) for f in dataclasses.fields(StereoParams)
                 if getattr(args, f.name, None) is not None}
    params = StereoParams(**overrides)
    start_s, end_s = resolve_clip_window(args.start, args.end)
    cfg = RenderConfig(
        output_format=args.format, output_height=args.height, aspect=args.aspect,
        preserve_original_aspect=args.preserve_aspect, codec=args.codec, crf=args.crf,
        fps=args.fps, start_s=start_s, end_s=end_s, chunk_size=args.chunk_size,
        device=args.device, skip_blank_frames=args.skip_blank_frames,
        auto_crop_black_bars=args.auto_crop_black_bars, mesh=args.mesh)
    output = args.output
    if output is None:
        tag = args.format.replace(" ", "").replace(":", "")
        output = f"{args.input.rsplit('.', 1)[0]}_{tag}.y4m"

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
                               progress_cb=progress, predictor=predictor)
    print(f"\nrendered {prog.frames_done} frames ({prog.fps:.2f} fps) -> {output}")
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return cmd_render(args)


if __name__ == "__main__":
    sys.exit(main())
