"""Build and load the hand-written CUDA kernels.

All ``csrc/*.cu`` sources compile with ``nvcc`` into one shared library with
a plain C interface, loaded through ``ctypes``: one ``nvcc`` a source, all
started together, then one link. The build runs at first use, into
``kernels/_build/``, under a file name keyed by a hash of the sources and
flags, so an edited source rebuilds and an unchanged one loads at once.
No fast math: the statistics kernels rely on IEEE float32 division.

Every launcher takes raw device pointers, sizes and PyTorch's current CUDA
stream, and returns the ``cudaError_t`` of its launch; ``check`` raises on a
nonzero code. The wrappers launch only through ``launch``, which makes the
input's card the current device for the call: the library's launches and
its one-time configuration (shared-memory attributes, SM counts, cluster
sizes, kept per device) follow the current device, so a tensor on
``cuda:1`` never runs on whatever card happens to be current.
``launch_counts`` counts the launches of each kernel wrapper (in
``launch``, nowhere else); ``device_ops`` counts the device operations one
call enqueues.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-O3", "-std=c++17", "-gencode", "arch=compute_90a,code=sm_90a",
              "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas", "-v")

KERNELS = ("stereo_warp", "feather_heal", "quantile_pair", "subject_stats", "conv3x3",
           "dof_grade", "vmem_attention", "quantile_hist_band", "quantile_pair_finish",
           "subject_hist_band", "subject_stats_finish")
launch_counts = dict.fromkeys(KERNELS, 0)

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
build_log = ""


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def find_nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    if Path("/usr/local/cuda/bin/nvcc").exists():
        return "/usr/local/cuda/bin/nvcc"
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels cannot be built")


def build_library() -> Path:
    """Compile csrc/*.cu into _build/ unless an up-to-date build exists."""
    global build_log
    sources = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    out = BUILD_DIR / f"libvd3d_kernels_{digest.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc, tag = find_nvcc(), f"{out.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in sources]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(sources, objs)]
    build_log = "".join(p.communicate()[0] for p in procs)
    try:
        failed = [src.name for src, p in zip(sources, procs) if p.returncode != 0]
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{build_log}")
        tmp = out.with_name(f"{tag}.tmp")
        res = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed (rc={res.returncode}):\n"
                               f"{res.stdout}{res.stderr}")
        os.replace(tmp, out)
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = _declare(ctypes.CDLL(str(build_library())))
        return _lib


def _declare(L: ctypes.CDLL) -> ctypes.CDLL:
    p, i, f, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
    sigs = {
        "vd3d_stereo_warp": [p, p, p, p, p, p, p, i, i, i, p],
        "vd3d_feather_heal": [p, p, p, p, p, p, p, i, i, i, f, f, f, i, i, i, p],
        "vd3d_quantile_pair": [p, i, i, ll, f, f, p, p, p],
        "vd3d_subject_stats": [p, i, i, ll, p, p],
        "vd3d_conv3x3": [p, p, p, p, i, i, i, i, i, i, i, i, i, i, i, f, i, p],
        "vd3d_dof_grade": [p, p, p, p, p, p, i, i, p, p, i, f, f, f, f, f, i, i, p],
        "vd3d_attention": [p, p, p, p, i, i, i, i, i, f, i, p],
        "vd3d_quantile_hist_band": [p, i, i, ll, p, p],
        "vd3d_quantile_pair_finish": [p, ll, f, f, p, p],
        "vd3d_subject_hist_band": [p, i, i, ll, p, p],
        "vd3d_subject_stats_finish": [p, p, p],
        "vd3d_subject_cluster": [],
        "vd3d_empty": [p],
    }
    for name, args in sigs.items():
        fn = getattr(L, name)
        fn.argtypes = args
        fn.restype = ctypes.c_int
    L.vd3d_error_string.argtypes = [ctypes.c_int]
    L.vd3d_error_string.restype = ctypes.c_char_p
    return L


def check(rc: int, what: str) -> None:
    if rc != 0:
        msg = lib().vd3d_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA launch failed ({rc}: {msg})")


def stream_of(t) -> int:
    """PyTorch's current CUDA stream on t's device, as a raw handle."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream


def launch(name: str, t, fn: str, *args) -> None:
    """Launch kernel ``name`` through the library function ``fn`` with
    ``args`` and the current stream of t's device, inside that device (made
    current for the call, then restored); raise on a failed launch, count
    one that succeeded."""
    import torch

    with torch.cuda.device(t.device):
        rc = getattr(lib(), fn)(*args, stream_of(t))
    check(rc, name)
    launch_counts[name] += 1


def device_ops(fn) -> int:
    """The device operations (kernels, memsets, copies) one call of fn()
    enqueues. fn() is captured once into a CUDA graph, which is never
    replayed, and the graph's nodes of those types are counted through the
    driver API: a count that needs no profiler."""
    import torch

    cu = ctypes.CDLL("libcuda.so.1")

    def call(rc, what):
        if rc != 0:
            raise RuntimeError(f"{what} failed ({rc})")

    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    handle = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    call(cu.cuGraphGetNodes(handle, None, ctypes.byref(n)), "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * n.value)()
    call(cu.cuGraphGetNodes(handle, nodes, ctypes.byref(n)), "cuGraphGetNodes")
    kind, count = ctypes.c_int(0), 0
    for node in nodes[:n.value]:
        call(cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)),
             "cuGraphNodeGetType")
        # CU_GRAPH_NODE_TYPE_KERNEL 0, _MEMCPY 1, _MEMSET 2
        count += kind.value in (0, 1, 2)
    del graph
    torch.cuda.empty_cache()
    return count


def require_cuda(what: str, *tensors) -> None:
    """Raise unless every tensor is a CUDA tensor on one device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{what}: all inputs must be CUDA tensors on one device, "
                             f"got {[str(x.device) for x in tensors]}")
