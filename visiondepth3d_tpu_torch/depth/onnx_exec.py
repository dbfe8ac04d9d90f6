"""Arbitrary-ONNX depth models: a small graph interpreter over PyTorch.

Counterpart of ``visiondepth3d_tpu/depth/onnx_exec.py``. The reference runs
any ``[Local]`` folder holding a ``model.onnx`` through onnxruntime
(render_depth.py:716-724,832-954); here the graph (parsed without the
``onnx`` package by ``utils/onnx_reader.read_onnx_graph``) is walked node by
node onto torch ops on the executor's device.

- Shape arithmetic stays in numpy on the host, as in the JAX package:
  every value that feeds a shape position (Reshape targets, Resize scales,
  Slice bounds, ...) is closed over backward from those positions, the
  initializers in that closure stay numpy arrays, and the ops of
  ``_HOST_SET`` run in numpy when all their inputs are host values. A
  shape that depends on the data raises ``OnnxUnsupportedOp``, as it does
  in the JAX package.
- Data tensors stay NCHW as exported. Host values an op mixes with
  tensors move to the device as the JAX package's defaults would hold them
  (float64 as float32).
- Each op computes what the JAX package's does, including where that
  differs from the ONNX spec: Resize without align_corners is
  ``jax.image.resize`` (half-pixel, antialiased when it shrinks, Keys cubic
  a = -0.5, nearest at floor((i + 0.5) in / out)); HardSigmoid and
  HardSwish take alpha 1/6 and Elu alpha 1 whatever the attributes say.
- An op outside the table fails when the graph is loaded, naming it.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..device import DEFAULT_DEVICE, resolve_device
from ..ops.resize import resize_bilinear
from ..utils.onnx_reader import read_onnx_graph


class OnnxUnsupportedOp(NotImplementedError):
    pass


def _is_host(*vals) -> bool:
    return all(isinstance(v, np.ndarray) or np.isscalar(v) for v in vals)


# ops evaluated on host numpy when ALL inputs are host values (shape math)
_HOST_SET = {
    "Add", "Sub", "Mul", "Div", "Concat", "Gather", "Slice", "Squeeze",
    "Unsqueeze", "Cast", "Range", "Where", "Equal", "Greater", "Less",
    "Shape", "Constant", "ConstantOfShape", "Reshape", "Expand", "Floor",
    "Ceil", "Min", "Max", "ReduceProd", "Identity",
}

_ONNX_DTYPES = {
    1: torch.float32, 2: torch.uint8, 3: torch.int8, 6: torch.int32, 7: torch.int64,
    9: torch.bool, 10: torch.float16, 11: torch.float64, 16: torch.bfloat16,
}
# the JAX package casts on the host with numpy; bfloat16 has no numpy type
_NP_DTYPES = {1: np.float32, 2: np.uint8, 3: np.int8, 6: np.int32, 7: np.int64,
              9: np.bool_, 10: np.float16, 11: np.float64}

# input positions that must be host-static (shape parameters)
_STATIC_ARGS = {
    "Reshape": (1,), "Resize": (1, 2, 3), "Upsample": (1,),
    "Slice": (1, 2, 3, 4), "Expand": (1,), "Tile": (1,),
    "ConstantOfShape": (0,), "Pad": (1,), "Split": (1,),
    "Unsqueeze": (1,), "Squeeze": (1,), "Range": (0, 1, 2),
}


def _auto_pads(attrs, kernel_hw, strides, in_hw, dilations=(1, 1)):
    """-> [(lo, hi), ...] spatial padding from the pads / auto_pad attributes."""
    auto = attrs.get("auto_pad", b"NOTSET")
    auto = auto.decode() if isinstance(auto, bytes) else auto
    if auto in ("SAME_UPPER", "SAME_LOWER"):
        out = []
        for i in range(2):
            eff_k = (kernel_hw[i] - 1) * dilations[i] + 1
            osz = -(-in_hw[i] // strides[i])
            total = max(0, (osz - 1) * strides[i] + eff_k - in_hw[i])
            lo = total // 2 if auto == "SAME_UPPER" else total - total // 2
            out.append((lo, total - lo))
        return out
    pads = attrs.get("pads", [0, 0, 0, 0])
    n = len(pads) // 2
    return [(int(pads[i]), int(pads[i + n])) for i in range(n)]


def _flat_pad(pads) -> list[int]:
    """[(lo, hi)] per leading spatial dim -> F.pad's last-dim-first list."""
    out = []
    for lo, hi in reversed(pads):
        out += [lo, hi]
    return out


class OnnxExecutor:
    """Runs a parsed ONNX graph on ``device``.

    ``run(params, feeds)`` takes the initializer table (host arrays or
    tensors on the device) and the graph inputs. Values feeding shape
    positions are read from the host initializer table, never from
    ``params``, so the shape subgraph stays in numpy."""

    def __init__(self, path_or_graph, device=DEFAULT_DEVICE):
        g = path_or_graph if isinstance(path_or_graph, dict) else read_onnx_graph(path_or_graph)
        self.graph = g
        self.device = resolve_device(device)
        self.inputs = g["inputs"]
        self.output_names = [n for n, _ in g["outputs"]]
        self.initializers = g["initializers"]
        # ops present but unimplemented fail at load, not at call time
        missing = sorted({n["op"] for n in g["nodes"]} - set(_DISPATCH) - {"Constant"})
        if missing:
            raise OnnxUnsupportedOp(
                f"ONNX graph uses unsupported op(s) {missing}. The executor covers the "
                f"conv/ViT depth-model op set; for a known architecture convert the "
                f"checkpoint instead (`vd3d convert --model <family>`; families: `vd3d models`).")
        self._static_names = self._static_closure(g["nodes"])

    @staticmethod
    def _static_closure(nodes) -> set:
        """Names that must stay on the host: the backward closure of every
        shape-parameter input position."""
        static: set = set()
        for node in nodes:
            for pos in _STATIC_ARGS.get(node["op"], ()):
                if pos < len(node["inputs"]) and node["inputs"][pos]:
                    static.add(node["inputs"][pos])
        changed = True
        while changed:
            changed = False
            for node in nodes:
                if any(o in static for o in node["outputs"]):
                    for i in node["inputs"]:
                        if i and i not in static:
                            static.add(i)
                            changed = True
        return static

    def device_params(self) -> dict:
        """The initializers as the predictor holds them: float tensors on the
        device, int64 ones (shape data) as host arrays."""
        return {k: v if v.dtype == np.int64 else _to_device(v, self.device)
                for k, v in self.initializers.items()}

    def run(self, params: dict, feeds: dict) -> list:
        env: dict = dict(params)
        # shape-subgraph constants come from the host table
        for k in self._static_names & set(self.initializers):
            env[k] = self.initializers[k]
        env.update(feeds)
        for node in self.graph["nodes"]:
            op = node["op"]
            fn = _DISPATCH.get(op)
            if fn is None:
                raise OnnxUnsupportedOp(f"node {node['name']!r}: op {op!r} unsupported")
            args = [env[i] if i else None for i in node["inputs"]]
            host = op in _HOST_SET and _is_host(*(a for a in args if a is not None))
            if not host:  # the data inputs on the device; shape parameters stay host
                static = _STATIC_ARGS.get(op, ())
                args = [a if a is None or i in static else _on(a, self.device)
                        for i, a in enumerate(args)]
            out = fn(node, args, host)
            if not isinstance(out, (list, tuple)):
                out = [out]
            for name, val in zip(node["outputs"], out):
                if name:
                    env[name] = val
        return [env[n] for n in self.output_names]


# --- op implementations ----------------------------------------------------

def _to_device(v, device) -> torch.Tensor:
    """A host value on ``device`` as the JAX package holds it (float64 as
    float32, no 64-bit floats on the device)."""
    a = np.asarray(v)
    if a.dtype == np.float64:
        a = a.astype(np.float32)
    return torch.from_numpy(np.array(a)).to(device)


def _on(v, device):
    return v if isinstance(v, torch.Tensor) else _to_device(v, device)


def _const_int(v, what):
    """Shape parameters must be host values."""
    if isinstance(v, np.ndarray) or np.isscalar(v):
        return np.asarray(v)
    raise OnnxUnsupportedOp(f"{what} depends on a data-driven shape - the executor keeps "
                            f"shapes static (host numpy)")


def _ew(fn_t, fn_n=None):
    def impl(node, a, host):
        f = (fn_n or fn_t) if host else fn_t
        return f(*[x for x in a if x is not None])
    return impl


def _conv(node, a, host):
    x, w = a[0], a[1]
    b = a[2] if len(a) > 2 else None
    attrs = node["attrs"]
    if x.ndim != 4:
        raise OnnxUnsupportedOp(f"Conv rank {x.ndim} (only 2-D convs)")
    strides = tuple(attrs.get("strides", [1, 1]))
    dil = tuple(attrs.get("dilations", [1, 1]))
    pads = _auto_pads(attrs, w.shape[2:], strides, x.shape[2:], dil)
    y = F.conv2d(F.pad(x, _flat_pad(pads)), w, None, strides, 0, dil,
                 int(attrs.get("group", 1)))
    return y if b is None else y + b.reshape(1, -1, 1, 1)


def _conv_transpose(node, a, host):
    x, w = a[0], a[1]
    b = a[2] if len(a) > 2 else None
    attrs = node["attrs"]
    strides = tuple(attrs.get("strides", [1, 1]))
    pads = [int(p) for p in attrs.get("pads", [0, 0, 0, 0])]
    out_pad = [int(p) for p in attrs.get("output_padding", [0, 0])]
    if int(attrs.get("group", 1)) != 1:
        raise OnnxUnsupportedOp("grouped ConvTranspose")
    # the full transposed conv, output_padding appended at the end, then
    # pads cropped from both sides (ONNX's output size)
    y = F.pad(F.conv_transpose2d(x, w, None, strides), (0, out_pad[1], 0, out_pad[0]))
    y = y[..., pads[0]: y.shape[-2] - pads[2], pads[1]: y.shape[-1] - pads[3]]
    return y if b is None else y + b.reshape(1, -1, 1, 1)


def _gemm(node, a, host):
    x, w = a[0], a[1]
    attrs = node["attrs"]
    if int(attrs.get("transA", 0)):
        x = x.T
    if int(attrs.get("transB", 0)):
        w = w.T
    y = float(attrs.get("alpha", 1.0)) * (x @ w)
    if len(a) > 2 and a[2] is not None:
        y = y + float(attrs.get("beta", 1.0)) * a[2]
    return y


def _pool(avg: bool):
    def impl(node, a, host):
        x = a[0]
        attrs = node["attrs"]
        k = tuple(attrs.get("kernel_shape"))
        strides = tuple(attrs.get("strides", [1] * len(k)))
        pads = _auto_pads(attrs, k, strides, x.shape[2:])
        if int(attrs.get("ceil_mode", 0)):
            # extend the upper pad so the last partial window is included
            pads = [(lo, hi + s - 1) for (lo, hi), s in zip(pads, strides)]
        nd = len(k)
        if avg:
            pool = (F.avg_pool1d, F.avg_pool2d, F.avg_pool3d)[nd - 1]
            area = float(np.prod(k))
            total = pool(F.pad(x, _flat_pad(pads)), k, strides) * area
            if int(attrs.get("count_include_pad", 0)):
                return total / area
            ones = F.pad(torch.ones((1, 1) + tuple(x.shape[2:]), dtype=x.dtype,
                                    device=x.device), _flat_pad(pads))
            return total / (pool(ones, k, strides) * area)
        pool = (F.max_pool1d, F.max_pool2d, F.max_pool3d)[nd - 1]
        return pool(F.pad(x, _flat_pad(pads), value=-math.inf), k, strides)
    return impl


def _bshape(x):
    return (1, -1) + (1,) * (x.ndim - 2)


def _batchnorm(node, a, host):
    x, scale, bias, mean, var = a[:5]
    eps = float(node["attrs"].get("epsilon", 1e-5))
    s = _bshape(x)
    return (x - mean.reshape(s)) * (scale.reshape(s) * torch.rsqrt(var.reshape(s) + eps)) \
        + bias.reshape(s)


def _instancenorm(node, a, host):
    x, scale, bias = a[:3]
    eps = float(node["attrs"].get("epsilon", 1e-5))
    axes = tuple(range(2, x.ndim))
    mu = x.mean(dim=axes, keepdim=True)
    var = x.var(dim=axes, keepdim=True, unbiased=False)
    return (x - mu) * torch.rsqrt(var + eps) * scale.reshape(_bshape(x)) + bias.reshape(_bshape(x))


def _layernorm(node, a, host):
    x, scale = a[0], a[1]
    bias = a[2] if len(a) > 2 else None
    attrs = node["attrs"]
    axes = tuple(range(int(attrs.get("axis", -1)) % x.ndim, x.ndim))
    mu = x.mean(dim=axes, keepdim=True)
    var = x.var(dim=axes, keepdim=True, unbiased=False)
    y = (x - mu) * torch.rsqrt(var + float(attrs.get("epsilon", 1e-5))) * scale
    return y + bias if bias is not None else y


def _softmax(node, a, host):
    return torch.softmax(a[0], dim=int(node["attrs"].get("axis", -1)))


def _reshape(node, a, host):
    shape = _const_int(a[1], "Reshape target").astype(np.int64).tolist()
    cur = list(np.shape(a[0]))
    allow0 = int(node["attrs"].get("allowzero", 0))
    out = [cur[i] if s == 0 and not allow0 else int(s) for i, s in enumerate(shape)]
    return np.reshape(a[0], out) if host else a[0].reshape(out)


def _transpose(node, a, host):
    perm = node["attrs"].get("perm")
    if host:
        return np.transpose(a[0], perm)
    return a[0].permute(*(perm if perm is not None else range(a[0].ndim - 1, -1, -1)))


def _concat(node, a, host):
    axis = int(node["attrs"].get("axis", 0))
    vals = [v for v in a if v is not None]
    return np.concatenate(vals, axis=axis) if host else torch.cat(vals, dim=axis)


def _gather(node, a, host):
    axis = int(node["attrs"].get("axis", 0))
    if host:
        return np.take(a[0], _const_int(a[1], "Gather indices"), axis=axis)
    idx = a[1].long()
    axis %= a[0].ndim
    # negative indices wrap; the result holds the index's shape at ``axis``
    idx = torch.where(idx < 0, idx + a[0].shape[axis], idx)
    out = torch.index_select(a[0], axis, idx.reshape(-1))
    return out.reshape(a[0].shape[:axis] + idx.shape + a[0].shape[axis + 1:])


def _axes_arg(node, a, idx):
    if len(a) > idx and a[idx] is not None:
        return _const_int(a[idx], "axes").astype(np.int64).ravel().tolist()
    ax = node["attrs"].get("axes")
    return list(ax) if ax is not None else None


def _unsqueeze(node, a, host):
    axes = _axes_arg(node, a, 1) or []
    x = a[0]
    out_rank = np.ndim(x) + len(axes)
    for ax in sorted(ax % out_rank for ax in axes):
        x = np.expand_dims(x, ax) if host else x.unsqueeze(ax)
    return x


def _squeeze(node, a, host):
    axes = _axes_arg(node, a, 1)
    x = a[0]
    if axes is None:
        return np.squeeze(x) if host else x.squeeze()
    axes = tuple(ax % np.ndim(x) for ax in axes)
    return np.squeeze(x, axis=axes) if host else x.squeeze(axes)


def _slice(node, a, host):
    x = a[0]
    rank = np.ndim(x)
    if len(a) > 1:  # opset >= 10: inputs
        starts = _const_int(a[1], "Slice starts").ravel().tolist()
        ends = _const_int(a[2], "Slice ends").ravel().tolist()
        axes = (_const_int(a[3], "Slice axes").ravel().tolist()
                if len(a) > 3 and a[3] is not None else list(range(rank)))
        steps = (_const_int(a[4], "Slice steps").ravel().tolist()
                 if len(a) > 4 and a[4] is not None else [1] * len(starts))
    else:  # opset 1 attributes
        starts = list(node["attrs"].get("starts"))
        ends = list(node["attrs"].get("ends"))
        axes = list(node["attrs"].get("axes", range(rank)))
        steps = [1] * len(starts)
    sl = [slice(None)] * rank
    for s, e, ax, st in zip(starts, ends, axes, steps):
        big = 1 << 62
        s = None if s in (-big, big) else int(s)
        e = None if (e is not None and abs(int(e)) >= big) else int(e)
        sl[int(ax) % rank] = slice(s, e, int(st))
    if host or all(s.step in (None, 1) for s in sl):
        return x[tuple(sl)]
    # torch slices take positive steps only: index the rest
    for ax, s in enumerate(sl):
        if s.step not in (None, 1):
            idx = torch.from_numpy(np.arange(x.shape[ax])[s].copy()).to(x.device)
            x = torch.index_select(x, ax, idx)
            sl[ax] = slice(None)
    return x[tuple(sl)]


def _cast(node, a, host):
    code = int(node["attrs"].get("to", 1))
    if host:
        return np.asarray(a[0]).astype(_NP_DTYPES.get(code, np.float32))
    return a[0].to(_ONNX_DTYPES.get(code, torch.float32))


def _reduce(t_fn, np_fn):
    def impl(node, a, host):
        axes = _axes_arg(node, a, 1)
        keep = bool(int(node["attrs"].get("keepdims", 1)))
        if host:
            return np_fn(a[0], axis=tuple(axes) if axes else None, keepdims=keep)
        x = a[0]
        dims = tuple(ax % x.ndim for ax in axes) if axes else tuple(range(x.ndim))
        return t_fn(x, dims, keep)
    return impl


def _prod(x, dims, keep):
    for d in sorted(dims, reverse=True):
        x = torch.prod(x, dim=d, keepdim=keep)
    return x


# jax.image.resize's kernels (scale_and_translate), applied per axis
def _triangle(x):
    return np.maximum(0.0, 1.0 - np.abs(x))


def _keys_cubic(x):
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out)


def _jax_resize_matrix(in_size: int, out_size: int, kernel) -> np.ndarray:
    """(out, in) weights of ``jax.image.resize`` along one axis (float32, as
    the JAX package builds them)."""
    f32 = np.float32
    inv_scale = f32(1.0 / (out_size / in_size))
    kernel_scale = max(inv_scale, f32(1.0))  # antialias when shrinking
    sample = (np.arange(out_size, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(in_size, dtype=f32)[:, None]) / kernel_scale
    w = kernel(x).astype(f32)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(f32).eps,
                 w / np.where(total != 0, total, 1), 0).astype(f32)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[None, :], w, 0).astype(f32).T


def _resize(node, a, host):
    x = a[0]
    attrs = node["attrs"]
    mode = attrs.get("mode", b"nearest")
    mode = mode.decode() if isinstance(mode, bytes) else mode
    ctm = attrs.get("coordinate_transformation_mode", b"half_pixel")
    ctm = ctm.decode() if isinstance(ctm, bytes) else ctm
    sizes = scales = None
    if len(a) > 3 and a[3] is not None and np.size(_const_int(a[3], "Resize sizes")):
        sizes = _const_int(a[3], "Resize sizes").ravel().astype(int).tolist()
    elif len(a) > 2 and a[2] is not None and np.size(_const_int(a[2], "Resize scales")):
        scales = _const_int(a[2], "Resize scales").ravel().tolist()
    elif len(a) > 1 and a[1] is not None and np.size(a[1]):  # Upsample v9
        scales = _const_int(a[1], "Upsample scales").ravel().tolist()
    if sizes is None:
        sizes = [int(round(d * s)) for d, s in zip(x.shape, scales)]
    if mode not in ("nearest", "linear", "cubic"):
        raise OnnxUnsupportedOp(f"Resize mode {mode!r}")
    if mode != "nearest" and ctm == "align_corners":
        return _resize_align_corners(x, sizes)
    out = x if mode == "nearest" else x.float() if not x.is_floating_point() else x
    for ax, (n_in, n_out) in enumerate(zip(x.shape, sizes)):
        if n_in == n_out:
            continue
        if mode == "nearest":
            idx = np.floor((np.arange(n_out, dtype=np.float32) + 0.5) * n_in / n_out
                           ).astype(np.int64)
            out = torch.index_select(out, ax, torch.from_numpy(idx).to(out.device))
        else:
            m = _jax_resize_matrix(n_in, n_out, _triangle if mode == "linear" else _keys_cubic)
            m = torch.from_numpy(m).to(device=out.device, dtype=out.dtype)
            out = torch.tensordot(out, m, dims=([ax], [1])).movedim(-1, ax)
    return out


def _resize_align_corners(x, sizes):
    out = x
    for ax in range(x.ndim):
        n_in, n_out = x.shape[ax], sizes[ax]
        if n_in == n_out:
            continue
        if n_out == 1 or n_in == 1:
            idx = torch.zeros(n_out, dtype=torch.float32, device=x.device)
        else:
            idx = torch.linspace(0.0, n_in - 1.0, n_out, device=x.device)
        lo = torch.clamp(torch.floor(idx).long(), 0, n_in - 1)
        hi = torch.clamp(lo + 1, 0, n_in - 1)
        shape = [1] * out.ndim
        shape[ax] = n_out
        w = (idx - lo).to(x.dtype).reshape(shape)
        out = torch.index_select(out, ax, lo) * (1 - w) + torch.index_select(out, ax, hi) * w
    return out


def _pad(node, a, host):
    x = a[0]
    attrs = node["attrs"]
    mode = attrs.get("mode", b"constant")
    mode = mode.decode() if isinstance(mode, bytes) else mode
    if len(a) > 1 and a[1] is not None:
        pads = _const_int(a[1], "Pad pads").ravel().astype(int).tolist()
    else:
        pads = list(attrs.get("pads"))
    n = len(pads) // 2
    widths = [(pads[i], pads[i + n]) for i in range(n)]
    if mode not in ("constant", "reflect", "edge"):
        raise OnnxUnsupportedOp(f"Pad mode {mode!r}")
    if mode == "constant":
        cval = float(a[2].reshape(-1)[0]) if len(a) > 2 and a[2] is not None else 0.0
        return F.pad(x, _flat_pad(widths), value=cval)
    # torch pads the trailing dims only in these modes: drop the leading zeros
    lead = 0
    while lead < n and widths[lead] == (0, 0):
        lead += 1
    tail = _flat_pad(widths[lead:])
    return F.pad(x, tail, mode="reflect" if mode == "reflect" else "replicate")


def _split(node, a, host):
    x = a[0]
    axis = int(node["attrs"].get("axis", 0))
    if len(a) > 1 and a[1] is not None:
        split = _const_int(a[1], "Split sizes").ravel().astype(int).tolist()
    else:
        split = node["attrs"].get("split")
    if split is None:
        n_out = len(node["outputs"])
        split = [x.shape[axis] // n_out] * n_out
    if host:
        return list(np.split(x, np.cumsum(split)[:-1].tolist(), axis=axis))
    return list(torch.split(x, list(split), dim=axis))


def _expand(node, a, host):
    tgt = _const_int(a[1], "Expand shape").ravel().astype(int).tolist()
    cur = list(np.shape(a[0]))
    # ONNX Expand broadcasts both ways: max() per dim
    while len(cur) < len(tgt):
        cur.insert(0, 1)
    out = [max(c, t) if t != 1 else c for c, t in zip(cur, tgt)]
    return np.broadcast_to(a[0], out) if host else a[0].expand(out)


def _constant(node, a, host):
    val = node["attrs"].get("value")
    if val is None:
        for k in ("value_float", "value_int"):
            if k in node["attrs"]:
                return np.asarray(node["attrs"][k])
        raise OnnxUnsupportedOp("Constant without value")
    return np.asarray(val)


def _constant_of_shape(node, a, host):
    shape = _const_int(a[0], "ConstantOfShape").ravel().astype(int).tolist()
    val = node["attrs"].get("value")
    v = np.asarray(val).ravel()[0] if val is not None else np.float32(0)
    return np.full(shape, v)


def _shape_op(node, a, host):
    return np.asarray(np.shape(a[0]), np.int64)


def _clip(node, a, host):
    x = a[0]
    lo = a[1] if len(a) > 1 and a[1] is not None else node["attrs"].get("min")
    hi = a[2] if len(a) > 2 and a[2] is not None else node["attrs"].get("max")
    if lo is not None:
        x = torch.maximum(x, _on(lo, x.device).to(x.dtype))
    if hi is not None:
        x = torch.minimum(x, _on(hi, x.device).to(x.dtype))
    return x


def _leaky(node, a, host):
    alpha = float(node["attrs"].get("alpha", 0.01))
    return torch.where(a[0] >= 0, a[0], alpha * a[0])


def _prelu(node, a, host):
    x, slope = a[0], a[1]
    if slope.ndim == 1 and x.ndim == 4:
        slope = slope.reshape(1, -1, 1, 1)
    return torch.where(x >= 0, x, slope * x)


def _range(node, a, host):
    s, e, d = (np.asarray(v).ravel()[0] for v in a[:3])
    return np.arange(s, e, d)


def _where(node, a, host):
    return np.where(a[0], a[1], a[2]) if host else torch.where(a[0].bool(), a[1], a[2])


def _tile(node, a, host):
    reps = _const_int(a[1], "Tile repeats").ravel().astype(int).tolist()
    return np.tile(a[0], reps) if host else a[0].repeat(reps)


def _flatten(node, a, host):
    axis = int(node["attrs"].get("axis", 1))
    lead = int(np.prod(np.shape(a[0])[:axis]) or 1)
    return a[0].reshape(lead, -1)


def _gelu(node, a, host):
    approx = node["attrs"].get("approximate", b"none")
    approx = approx.decode() if isinstance(approx, bytes) else approx
    return F.gelu(a[0], approximate="tanh" if approx == "tanh" else "none")


def _einsum(node, a, host):
    eq = node["attrs"].get("equation")
    eq = eq.decode() if isinstance(eq, bytes) else eq
    return torch.einsum(eq, *[v for v in a if v is not None])


def _hard_sigmoid(x):
    return torch.clamp(x / 6.0 + 0.5, 0, 1)


def _global_avg_pool(node, a, host):
    return a[0].mean(dim=tuple(range(2, a[0].ndim)), keepdim=True)


_DISPATCH = {
    "Conv": _conv,
    "ConvTranspose": _conv_transpose,
    "Gemm": _gemm,
    "MatMul": _ew(torch.matmul),
    "Einsum": _einsum,
    "Add": _ew(torch.add, np.add),
    "Sub": _ew(torch.subtract, np.subtract),
    "Mul": _ew(torch.multiply, np.multiply),
    "Div": _ew(torch.true_divide, np.divide),
    "Pow": _ew(torch.pow, np.power),
    "Sqrt": _ew(torch.sqrt, np.sqrt),
    "Exp": _ew(torch.exp, np.exp),
    "Log": _ew(torch.log, np.log),
    "Abs": _ew(torch.abs, np.abs),
    "Neg": _ew(torch.negative, np.negative),
    "Floor": _ew(torch.floor, np.floor),
    "Ceil": _ew(torch.ceil, np.ceil),
    "Min": _ew(torch.minimum, np.minimum),
    "Max": _ew(torch.maximum, np.maximum),
    "Reciprocal": _ew(torch.reciprocal),
    "Erf": _ew(torch.erf),
    "Relu": _ew(torch.relu),
    "LeakyRelu": _leaky,
    "PRelu": _prelu,
    "Elu": _ew(F.elu),
    "Sigmoid": _ew(torch.sigmoid),
    "HardSigmoid": _ew(_hard_sigmoid),
    "HardSwish": _ew(lambda x: x * _hard_sigmoid(x)),
    "Tanh": _ew(torch.tanh, np.tanh),
    "Gelu": _gelu,
    "Softmax": _softmax,
    "Softplus": _ew(F.softplus),
    "Clip": _clip,
    "Equal": _ew(torch.eq, np.equal),
    "Greater": _ew(torch.gt, np.greater),
    "Less": _ew(torch.lt, np.less),
    "Not": _ew(torch.logical_not),
    "And": _ew(torch.logical_and),
    "Or": _ew(torch.logical_or),
    "Where": _where,
    "Shape": _shape_op,
    "Constant": _constant,
    "ConstantOfShape": _constant_of_shape,
    "Range": _range,
    "Reshape": _reshape,
    "Transpose": _transpose,
    "Concat": _concat,
    "Gather": _gather,
    "Slice": _slice,
    "Squeeze": _squeeze,
    "Unsqueeze": _unsqueeze,
    "Expand": _expand,
    "Flatten": _flatten,
    "Tile": _tile,
    "Cast": _cast,
    "Identity": lambda node, a, host: a[0],
    "Dropout": lambda node, a, host: a[0],
    "ReduceMean": _reduce(lambda x, d, k: x.mean(dim=d, keepdim=k), np.mean),
    "ReduceSum": _reduce(lambda x, d, k: x.sum(dim=d, keepdim=k), np.sum),
    "ReduceMax": _reduce(lambda x, d, k: x.amax(dim=d, keepdim=k), np.max),
    "ReduceMin": _reduce(lambda x, d, k: x.amin(dim=d, keepdim=k), np.min),
    "ReduceProd": _reduce(_prod, np.prod),
    "GlobalAveragePool": _global_avg_pool,
    "MaxPool": _pool(avg=False),
    "AveragePool": _pool(avg=True),
    "BatchNormalization": _batchnorm,
    "InstanceNormalization": _instancenorm,
    "LayerNormalization": _layernorm,
    "Resize": _resize,
    "Upsample": _resize,
    "Pad": _pad,
    "Split": _split,
}


class OnnxDepthPredictor:
    """The depth predictor over an arbitrary ONNX depth graph (the
    reference's run_onnx closure, render_depth.py:832-954): the first
    input's rank says image ([B, 3, H, W]) or video ([1, T, 3, H, W]);
    fixed square spatial dims in the graph win over the requested size,
    which snaps down to a multiple of 32 (at least 32); ImageNet
    normalization; [B, H, W, 3] float RGB in [0, 1] -> [B, s, s] float32
    raw depth. ``_size`` is (s, s), as the port's other predictors hold
    it (the tiled route reads ``_size[0]``). Runs in float32."""

    IMAGENET_MEAN = (0.485, 0.456, 0.406)
    IMAGENET_STD = (0.229, 0.224, 0.225)

    def __init__(self, onnx_path, inference_size: int = 518, device=DEFAULT_DEVICE):
        self.device = resolve_device(device)
        self.exe = OnnxExecutor(onnx_path, self.device)
        if not self.exe.inputs:
            raise ValueError(f"{onnx_path}: graph has no inputs")
        self.input_name, shape = self.exe.inputs[0]
        rank = len(shape) if shape else 4
        if rank not in (4, 5):
            raise OnnxUnsupportedOp(f"{onnx_path}: rank-{rank} input (expect [B,3,H,W] image "
                                    f"or [1,T,3,H,W] video)")
        self.video = rank == 5
        s = inference_size
        if shape:
            fixed = [d for d in shape[-2:] if d]
            if len(fixed) == 2 and fixed[0] == fixed[1]:
                s = fixed[0]
        s = max(32, s - s % 32)
        self._size = (s, s)
        self.params = self.exe.device_params()
        self._mean = torch.tensor(self.IMAGENET_MEAN, device=self.device)
        self._std = torch.tensor(self.IMAGENET_STD, device=self.device)

    @torch.no_grad()
    def __call__(self, frames01: torch.Tensor) -> torch.Tensor:
        x = torch.as_tensor(frames01).to(device=self.device, dtype=torch.float32)
        x = resize_bilinear(x, self._size, channel_last=True)
        x = ((x - self._mean) / self._std).permute(0, 3, 1, 2)  # NCHW
        if self.video:
            x = x[None]  # [1, T, 3, H, W]
        out = self.exe.run(self.params, {self.input_name: x})[0]
        out = _on(out, self.device).float()
        return out.reshape((-1,) + tuple(out.shape[-2:]))
