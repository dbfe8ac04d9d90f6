"""One-command real-checkpoint readiness: ``vd3d-torch verify-checkpoints DIR``.

The port of ``visiondepth3d_tpu/utils/verify_checkpoints.py``, with the
same filenames and the same report. Every converter family loads whatever
artifacts are present in ``DIR``, runs a short smoke on a synthetic
perspective scene on ``device`` (the card unless the caller passes "cpu"),
and a machine-readable report (``passed``, ``failed``, ``missing``,
``results.<name>.status``) lands next to the weights. Expected filenames
(a missing file reports "missing", not a failure)::

    DIR/
      depth-anything-v2-{small,base,large}.safetensors  # HF *-hf repos
      dpt-large.safetensors                 # Intel/dpt-large
      dpt-beit-large-512.safetensors        # Intel/dpt-beit-large-512
      dpt-hybrid.safetensors                # Intel/dpt-hybrid-midas
      midas-v2.safetensors                  # qualcomm/Midas-V2
      zoedepth-nyu.safetensors              # Intel/zoedepth-nyu
      zoedepth-nyu-kitti.safetensors        # Intel/zoedepth-nyu-kitti
      depth-pro.safetensors                 # apple/DepthPro-hf
      video-depth-anything.safetensors      # VDA-Small
      rife.onnx                             # RIFE_fp32.onnx
      esrgan-x4.safetensors                 # RealESRGAN_x4plus state dict
      RealESR_Gx4_fp16.onnx ... BSRGANx4_fp16.onnx  # the reference's five
                                            # shipped upscalers (ESRGAN_CATALOG)
      marigold/                             # diffusers checkpoint dir
      depthcrafter/                         # unet/ vae/ image_encoder/ dirs

The feed-forward families load at inference size 266 as in the JAX walk;
the registry snaps it per family, and Depth Pro takes its smallest valid
size, 1536, where the JAX walk's 266 cannot run (ROADMAP Queue 3, F20).
"""

from __future__ import annotations

import json
import os
import time
import traceback

import numpy as np
import torch

from ..device import DEFAULT_DEVICE, resolve_device


def ground_plane_scene(h: int = 210, w: int = 280) -> np.ndarray:
    """Textured perspective scene: floor in the lower half (near), sky in
    the upper (far). Any real monocular depth model orders these."""
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.zeros((h, w, 3), np.float32)
    horizon = h * 2 // 5
    img[:horizon] = [0.55, 0.7, 0.9]  # sky
    t = (yy - horizon).clip(min=1) / (h - horizon)
    tile = (np.sin(xx / (3 + 30 * t)) > 0) ^ (np.sin(yy / 6.0) > 0)
    floor = np.where(tile, 0.65, 0.35).astype(np.float32)
    for c, base in enumerate((0.8, 0.6, 0.45)):
        img[horizon:, :, c] = floor[horizon:] * base
    return img[None]  # [1, H, W, 3]


def _host(x) -> np.ndarray:
    return x.float().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _on(frame: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(frame)).to(device)


def _depth_sanity(pred) -> dict:
    d = _host(pred(torch.from_numpy(ground_plane_scene())))[0]
    if not np.isfinite(d).all():
        raise AssertionError("non-finite depth")
    if d.std() <= 1e-4:
        raise AssertionError("constant depth")
    hh = d.shape[0]
    near = float(d[int(hh * 0.8):].mean())  # floor rows
    far = float(d[: int(hh * 0.3)].mean())  # sky rows
    return {"near_mean": round(near, 4), "far_mean": round(far, 4),
            "std": round(float(d.std()), 4)}


_FEEDFORWARD = [
    ("depth-anything-v2-small.safetensors", "depth-anything-v2-small"),
    ("depth-anything-v2-base.safetensors", "depth-anything-v2-base"),
    ("depth-anything-v2-large.safetensors", "depth-anything-v2-large"),
    ("dpt-large.safetensors", "dpt-large"),
    ("dpt-beit-large-512.safetensors", "dpt-beit-large-512"),
    ("dpt-hybrid.safetensors", "midas-v3-hybrid"),
    ("midas-v2.safetensors", "midas-v2"),
    ("zoedepth-nyu.safetensors", "zoedepth-nyu"),
    ("zoedepth-nyu-kitti.safetensors", "zoedepth-nyu-kitti"),
    ("depth-pro.safetensors", "depth-pro"),
    ("video-depth-anything.safetensors", "video-depth-anything"),
]


def _check_feedforward(path: str, model: str, device) -> dict:
    from ..depth.registry import load_predictor

    pred = load_predictor(model, path, inference_size=266, device=device)
    if hasattr(pred, "predict_01"):
        return _depth_sanity(pred)
    # the windowed video predictor (VDA) takes [T, H, W, 3] clips
    scene = np.repeat(ground_plane_scene(126, 168), 4, axis=0)
    d = _host(pred(torch.from_numpy(scene)))
    if not np.isfinite(d).all():
        raise AssertionError("non-finite depth")
    return {"std": round(float(d.std()), 4)}


def _check_rife(path: str, device) -> dict:
    from ..enhance.rife import load_rife_weights, rife_apply

    state_cfg = load_rife_weights(path)
    a = ground_plane_scene(96, 128)[0]
    b = np.roll(a, 4, axis=1)
    mid = _host(rife_apply(state_cfg, _on(a, device), _on(b, device)))
    if not np.isfinite(mid).all():
        raise AssertionError("non-finite frame")
    d_mid = float(np.abs(mid - a).mean())
    d_full = float(np.abs(b - a).mean())
    if not (0 < d_mid < d_full):
        raise AssertionError(
            f"midpoint not between endpoints (|mid-a|={d_mid:.4f}, "
            f"|b-a|={d_full:.4f})")
    return {"cfg": str(state_cfg[1]), "mid_delta": round(d_mid, 4)}


def _check_esrgan(path: str, scale_hint=None, device=DEFAULT_DEVICE) -> dict:
    from ..enhance.esrgan import esrgan_apply, load_esrgan_weights

    state, cfg = load_esrgan_weights(path, scale=scale_hint)
    x = ground_plane_scene(48, 64)[0]
    y = _host(esrgan_apply(state, _on(x, device), cfg=cfg))
    want = (48 * cfg.scale, 64 * cfg.scale, 3)
    if y.shape != want:
        raise AssertionError(f"output {y.shape}, expected {want}")
    if not np.isfinite(y).all():
        raise AssertionError("non-finite output")
    return {"cfg": str(cfg)}


def _check_diffusion(path: str, name: str, device) -> dict:
    from ..depth.diffusion import load_diffusion_pipeline

    if name == "marigold":
        pipe = load_diffusion_pipeline("marigold", path, device=device)
        d = _host(pipe(torch.from_numpy(ground_plane_scene(96, 128))))
    else:
        pipe = load_diffusion_pipeline("depthcrafter", path, steps=2, window=8, overlap=2,
                                       device=device)
        d = _host(pipe(torch.from_numpy(np.repeat(ground_plane_scene(64, 96), 10, axis=0))))
    if not np.isfinite(d).all():
        raise AssertionError("non-finite depth")
    if d.std() <= 1e-4:
        raise AssertionError("constant depth")
    return {"std": round(float(d.std()), 4)}


def verify_checkpoints(ckpt_dir: str, report_path: str | None = None,
                       progress=print, device=DEFAULT_DEVICE) -> dict:
    """Walk every converter family over ``ckpt_dir``; return (and
    optionally write) a machine-readable pass/fail report."""
    from ..enhance.esrgan import ESRGAN_CATALOG

    resolve_device(device)
    checks: list[tuple[str, str, object]] = []
    for fname, model in _FEEDFORWARD:
        checks.append((model, fname,
                       lambda p, m=model: _check_feedforward(p, m, device)))
    checks.append(("rife", "rife.onnx", lambda p: _check_rife(p, device)))
    checks.append(("esrgan-x4", "esrgan-x4.safetensors",
                   lambda p: _check_esrgan(p, None, device)))
    for cat_name, entry in sorted(ESRGAN_CATALOG.items()):
        checks.append((f"esrgan:{cat_name}", entry["file"],
                       lambda p, s=entry["scale"]: _check_esrgan(p, s, device)))
    checks.append(("marigold", "marigold",
                   lambda p: _check_diffusion(p, "marigold", device)))
    checks.append(("depthcrafter", "depthcrafter",
                   lambda p: _check_diffusion(p, "depthcrafter", device)))

    results: dict[str, dict] = {}
    for name, fname, fn in checks:
        path = os.path.join(ckpt_dir, fname)
        exists = os.path.isdir(path) if fname in ("marigold", "depthcrafter") \
            else os.path.exists(path)
        if not exists:
            results[name] = {"status": "missing", "file": fname}
            continue
        t0 = time.time()
        try:
            notes = fn(path)
            results[name] = {"status": "pass", "file": fname,
                             "seconds": round(time.time() - t0, 1),
                             **(notes or {})}
            progress(f"PASS {name}")
        except Exception as e:  # noqa: BLE001 — report, don't abort the walk
            results[name] = {"status": "fail", "file": fname,
                             "seconds": round(time.time() - t0, 1),
                             "error": f"{type(e).__name__}: {e}",
                             "trace": traceback.format_exc(limit=6)}
            progress(f"FAIL {name}: {type(e).__name__}: {e}")

    n_pass = sum(1 for r in results.values() if r["status"] == "pass")
    n_fail = sum(1 for r in results.values() if r["status"] == "fail")
    report = {"dir": os.path.abspath(ckpt_dir), "passed": n_pass,
              "failed": n_fail,
              "missing": len(results) - n_pass - n_fail,
              "results": results}
    if report_path:
        with open(report_path, "w") as f:
            json.dump(report, f, indent=2)
    return report
