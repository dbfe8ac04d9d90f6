"""The port's ONNX route (``depth/onnx_exec.py``, ``onnx:`` and ``local:``
names) against the JAX package.

The graphs are written by the port's ``write_onnx_graph`` (neither machine
has the ``onnx`` package). float32 throughout:

- the JAX package's eight ONNX tests, mirrored: the graph round trip (the
  JAX reader parses the port's file alike), a conv/BN/ReLU/Resize net and a
  ViT block against torch ops (2e-4 and 2e-5, the JAX package's bounds),
  the Shape -> Gather -> Concat -> Reshape idiom kept on the host, pools
  and pads, the unsupported op, the predictor's contract, and a ``local:``
  folder holding a raw ``model.onnx`` through the depth route;
- every op of the interpreter, one parametrized case each, against the JAX
  ``OnnxExecutor`` on the same graph and inputs: max |d| <= 1e-5 x (1 +
  max |ref|) (integer and shape results equal);
- the predictor at rank 4 and rank 5 against the JAX predictor: 1e-5 x
  max |ref|;
- ``onnx:`` and ``local:`` through ``load_predictor`` and the depth route
  against the JAX route: u8 within 1 step;
- ``--tiled`` with an ONNX model: the JAX route fails on the predictor's
  int ``_size`` (F2); the port's predictor holds (s, s) and the tiled
  route runs, from the CLI too;
- a ``local:`` folder of ``format: "native"`` (a JAX params tree, flat
  "a/b/c" keys) through the family's ``from_jax_params``: the JAX
  predictor's depth within 1e-4 of its range; a family without one
  raises, naming those that have one;
- on a card (``cuda`` marker): the ONNX predictor against the CPU.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch
torch.set_num_threads(1)

from visiondepth3d_tpu.depth import registry as jregistry
from visiondepth3d_tpu.depth.configs import DA_TINY as JDA_TINY
from visiondepth3d_tpu.depth.model import init_random
from visiondepth3d_tpu.depth.onnx_exec import OnnxDepthPredictor as JPredictor
from visiondepth3d_tpu.depth.onnx_exec import OnnxExecutor as JExecutor
from visiondepth3d_tpu.pipeline.depth_pipeline import DepthConfig as JConfig
from visiondepth3d_tpu.pipeline.depth_pipeline import render_depth_video_file as jroute
from visiondepth3d_tpu.utils.onnx_reader import read_onnx_graph as jread_graph
from test_torch_depth_route import _read, _write_clip
from test_torch_reference import bounded
from visiondepth3d_tpu_torch.depth import configs as tconfigs
from visiondepth3d_tpu_torch.depth import registry as tregistry
from visiondepth3d_tpu_torch.depth.onnx_exec import (OnnxDepthPredictor, OnnxExecutor,
                                                     OnnxUnsupportedOp)
from visiondepth3d_tpu_torch.pipeline.depth_pipeline import DepthConfig, render_depth_video_file
from visiondepth3d_tpu_torch.utils.onnx_reader import read_onnx_graph, write_onnx_graph

F = torch.nn.functional


def _node(op, inputs, outputs, **attrs):
    return {"op": op, "inputs": inputs, "outputs": outputs, "attrs": attrs}


def _run(path, feeds):
    """The port's executor on the CPU: outputs as numpy."""
    exe = OnnxExecutor(path, device="cpu")
    outs = exe.run(exe.device_params(), {k: torch.from_numpy(v) for k, v in feeds.items()})
    return [o.numpy() if isinstance(o, torch.Tensor) else np.asarray(o) for o in outs]


def _depth_graph(path, seed=4, video=False):
    """A small depth net: conv encoder, a stride-2 conv, bilinear Resize back
    up, Concat with the skip, a 1x1 conv and a Sigmoid; [B, 3, H, W] (or
    [1, T, 3, H, W], squeezed to frames) -> [B, H, W]."""
    rng = np.random.default_rng(seed)
    inits = {"w1": rng.standard_normal((8, 3, 3, 3)).astype(np.float32) * 0.3,
             "b1": rng.standard_normal(8).astype(np.float32) * 0.1,
             "w2": rng.standard_normal((8, 8, 3, 3)).astype(np.float32) * 0.2,
             "w3": rng.standard_normal((1, 16, 1, 1)).astype(np.float32) * 0.3,
             "scales": np.asarray([1.0, 1.0, 2.0, 2.0], np.float32)}
    nodes = []
    x = "input"
    if video:
        nodes.append(_node("Squeeze", ["input"], ["frames"], axes=[0]))
        x = "frames"
    nodes += [_node("Conv", [x, "w1", "b1"], ["h1"], pads=[1, 1, 1, 1]),
              _node("Relu", ["h1"], ["h1r"]),
              _node("Conv", ["h1r", "w2"], ["h2"], strides=[2, 2], pads=[1, 1, 1, 1]),
              _node("Relu", ["h2"], ["h2r"]),
              _node("Resize", ["h2r", "", "scales"], ["up"], mode=b"linear"),
              _node("Concat", ["up", "h1r"], ["cat"], axis=1),
              _node("Conv", ["cat", "w3"], ["h3"]),
              _node("Sigmoid", ["h3"], ["h4"]),
              _node("Squeeze", ["h4"], ["depth"], axes=[1])]
    shape = [1, None, 3, None, None] if video else [None, 3, None, None]
    write_onnx_graph(str(path), inputs=[("input", shape)], outputs=[("depth", None)],
                     nodes=nodes, initializers=inits)
    return path


# ---------------------------------------------------------------- the JAX package's tests


def test_roundtrip_graph_parse(tmp_path):
    p = str(tmp_path / "m.onnx")
    w = np.random.default_rng(0).standard_normal((4, 3, 3, 3)).astype(np.float32)
    write_onnx_graph(p, inputs=[("x", [1, 3, 8, 8])], outputs=[("y", [1, 4, 8, 8])],
                     nodes=[_node("Conv", ["x", "w"], ["y"], pads=[1, 1, 1, 1], strides=[1, 1],
                                  mode=b"x", alpha=0.5)],
                     initializers={"w": w})
    g = read_onnx_graph(p)
    assert g["inputs"] == [("x", [1, 3, 8, 8])]
    assert g["outputs"][0][0] == "y"
    assert g["nodes"][0]["op"] == "Conv"
    assert g["nodes"][0]["attrs"] == {"pads": [1, 1, 1, 1], "strides": [1, 1], "mode": b"x",
                                      "alpha": 0.5}
    np.testing.assert_array_equal(g["initializers"]["w"], w)
    j = jread_graph(p)
    assert (j["inputs"], j["outputs"], j["nodes"]) == (g["inputs"], g["outputs"], g["nodes"])


def test_conv_bn_relu_resize_vs_torch(tmp_path):
    rng = np.random.default_rng(1)
    w1 = rng.standard_normal((8, 3, 3, 3)).astype(np.float32) * 0.2
    b1 = rng.standard_normal(8).astype(np.float32) * 0.1
    scale = rng.random(8).astype(np.float32) + 0.5
    bias = rng.standard_normal(8).astype(np.float32) * 0.1
    mean = rng.standard_normal(8).astype(np.float32) * 0.1
    var = rng.random(8).astype(np.float32) + 0.5
    w2 = rng.standard_normal((1, 8, 1, 1)).astype(np.float32) * 0.2
    p = str(tmp_path / "m.onnx")
    write_onnx_graph(p, inputs=[("x", [None, 3, 32, 32])], outputs=[("d", None)], nodes=[
        _node("Conv", ["x", "w1", "b1"], ["h1"], strides=[2, 2], pads=[1, 1, 1, 1]),
        _node("BatchNormalization", ["h1", "scale", "bias", "mean", "var"], ["h2"],
              epsilon=1e-5),
        _node("Relu", ["h2"], ["h3"]),
        _node("Resize", ["h3", "", "scales"], ["h4"], mode=b"linear",
              coordinate_transformation_mode=b"half_pixel"),
        _node("Conv", ["h4", "w2"], ["h5"]),
        _node("Squeeze", ["h5"], ["d"], axes=[1])],
        initializers={"w1": w1, "b1": b1, "scale": scale, "bias": bias, "mean": mean,
                      "var": var, "w2": w2,
                      "scales": np.asarray([1.0, 1.0, 2.0, 2.0], np.float32)})
    x = rng.standard_normal((2, 3, 32, 32)).astype(np.float32)
    (got,) = _run(p, {"x": x})
    t = torch.from_numpy
    h = F.conv2d(t(x), t(w1), t(b1), 2, 1)
    h = torch.relu(F.batch_norm(h, t(mean), t(var), t(scale), t(bias), eps=1e-5))
    h = F.interpolate(h, scale_factor=2, mode="bilinear", align_corners=False)
    np.testing.assert_allclose(got, F.conv2d(h, t(w2)).squeeze(1).numpy(), atol=2e-4)


def test_vit_block_ops_vs_torch(tmp_path):
    rng = np.random.default_rng(2)
    d = 16
    wq = rng.standard_normal((d, d)).astype(np.float32) * 0.2
    g = rng.random(d).astype(np.float32) + 0.5
    b = rng.standard_normal(d).astype(np.float32) * 0.1
    p = str(tmp_path / "vit.onnx")
    write_onnx_graph(p, inputs=[("x", [1, 8, d])], outputs=[("y", None)], nodes=[
        _node("LayerNormalization", ["x", "g", "b"], ["h"], axis=-1, epsilon=1e-5),
        _node("MatMul", ["h", "wq"], ["q"]),
        _node("Transpose", ["q"], ["qt"], perm=[0, 2, 1]),
        _node("MatMul", ["q", "qt"], ["att"]),
        _node("Softmax", ["att"], ["attp"], axis=-1),
        _node("MatMul", ["attp", "q"], ["o"]),
        _node("Div", ["o", "c_sqrt2"], ["o1"]),
        _node("Erf", ["o1"], ["o2"]),
        _node("Add", ["o2", "c_one"], ["o3"]),
        _node("Mul", ["o", "o3"], ["o4"]),
        _node("Mul", ["o4", "c_half"], ["y"])],
        initializers={"wq": wq, "g": g, "b": b, "c_sqrt2": np.float32(np.sqrt(2.0)),
                      "c_one": np.float32(1.0), "c_half": np.float32(0.5)})
    x = rng.standard_normal((1, 8, d)).astype(np.float32)
    (got,) = _run(p, {"x": x})
    h = F.layer_norm(torch.from_numpy(x), (d,), torch.from_numpy(g), torch.from_numpy(b),
                     eps=1e-5)
    q = h @ torch.from_numpy(wq)
    o = torch.softmax(q @ q.transpose(1, 2), dim=-1) @ q
    np.testing.assert_allclose(got, F.gelu(o).numpy(), atol=2e-5)


def test_shape_math_stays_on_the_host(tmp_path):
    """Shape -> Gather -> Unsqueeze -> Concat -> Reshape: the exporter's
    dynamic-shape idiom runs in numpy; the data goes through torch."""
    p = str(tmp_path / "s.onnx")
    write_onnx_graph(p, inputs=[("x", [2, 3, 4, 5])], outputs=[("y", None), ("tgt", None)],
                     nodes=[_node("Shape", ["x"], ["sh"]),
                            _node("Gather", ["sh", "i0"], ["b"], axis=0),
                            _node("Unsqueeze", ["b"], ["b1"], axes=[0]),
                            _node("Concat", ["b1", "negone"], ["tgt"], axis=0),
                            _node("Reshape", ["x", "tgt"], ["y"])],
                     initializers={"i0": np.asarray(0, np.int64),
                                   "negone": np.asarray([-1], np.int64)})
    exe = OnnxExecutor(p, device="cpu")
    x = torch.rand(2, 3, 4, 5, generator=torch.Generator().manual_seed(0))
    y, tgt = exe.run(exe.device_params(), {"x": x})
    assert isinstance(tgt, np.ndarray) and tgt.tolist() == [2, -1]
    assert isinstance(y, torch.Tensor) and torch.equal(y, x.reshape(2, 60))


def test_pool_pad_ops_vs_torch(tmp_path):
    rng = np.random.default_rng(3)
    p = str(tmp_path / "pool.onnx")
    write_onnx_graph(p, inputs=[("x", [1, 2, 8, 8])], outputs=[("y", None), ("z", None)],
                     nodes=[_node("Pad", ["x", "pads"], ["xp"], mode=b"reflect"),
                            _node("MaxPool", ["xp"], ["y"], kernel_shape=[2, 2],
                                  strides=[2, 2]),
                            _node("AveragePool", ["x"], ["z"], kernel_shape=[3, 3],
                                  strides=[1, 1], pads=[1, 1, 1, 1])],
                     initializers={"pads": np.asarray([0, 0, 1, 1, 0, 0, 1, 1], np.int64)})
    x = rng.standard_normal((1, 2, 8, 8)).astype(np.float32)
    y, z = _run(p, {"x": x})
    xt = torch.from_numpy(x)
    np.testing.assert_allclose(y, F.max_pool2d(F.pad(xt, (1, 1, 1, 1), mode="reflect"), 2, 2)
                               .numpy(), atol=1e-6)
    np.testing.assert_allclose(z, F.avg_pool2d(xt, 3, 1, 1, count_include_pad=False).numpy(),
                               atol=1e-6)


def test_unsupported_op_fails_actionably(tmp_path):
    p = str(tmp_path / "bad.onnx")
    write_onnx_graph(p, inputs=[("x", [1, 3, 8, 8])], outputs=[("y", None)],
                     nodes=[_node("GridSample", ["x", "x"], ["y"])], initializers={})
    with pytest.raises(OnnxUnsupportedOp, match="GridSample.*vd3d convert"):
        OnnxExecutor(p, device="cpu")
    assert issubclass(OnnxUnsupportedOp, NotImplementedError)


def test_onnx_depth_predictor_contract(tmp_path):
    """[B, H, W, 3] float RGB in [0, 1] -> [B, s, s] raw depth, ImageNet
    normalized, the size snapped down to 32: 70 -> (64, 64)."""
    pred = OnnxDepthPredictor(_depth_graph(tmp_path / "d.onnx"), inference_size=70,
                              device="cpu")
    assert pred._size == (64, 64) and not pred.video
    frames = torch.rand(2, 48, 80, 3, generator=torch.Generator().manual_seed(4))
    d = pred(frames)
    assert d.shape == (2, 64, 64) and d.dtype == torch.float32 and torch.isfinite(d).all()


def test_local_onnx_dir_e2e_pipeline(tmp_path):
    mdir = tmp_path / "MyDepthModel"
    mdir.mkdir()
    _depth_graph(mdir / "model.onnx")
    src = tmp_path / "in.y4m"
    _write_clip(src, 32, 48, 5)
    cfg = DepthConfig(model=f"local:{mdir}", inference_size=64, batch_size=2, device="cpu")
    assert render_depth_video_file(src, tmp_path / "d.y4m", cfg) == 5
    assert _read(tmp_path / "d.y4m").shape == (5, 32, 48)


# ---------------------------------------------------------------- each op against JAX


def _f32(*shape, seed=0, lo=-1.0, hi=1.0):
    return np.random.default_rng(seed).uniform(lo, hi, shape).astype(np.float32)


X = (2, 3, 10, 8)  # the default input
OPS = {
    "conv_pads_dilation": ([_node("Conv", ["x", "w", "b"], ["y"], pads=[1, 2, 0, 1],
                                  dilations=[2, 1], strides=[1, 2])],
                           {"w": _f32(4, 3, 3, 3, seed=1), "b": _f32(4, seed=2)}),
    "conv_same_groups": ([_node("Conv", ["x", "w"], ["y"], strides=[2, 2],
                                auto_pad=b"SAME_UPPER", group=3)], {"w": _f32(6, 1, 3, 3)}),
    "conv_transpose": ([_node("ConvTranspose", ["x", "w", "b"], ["y"], strides=[2, 2],
                              pads=[1, 0, 0, 1], output_padding=[1, 1])],
                       {"w": _f32(3, 4, 3, 3, seed=3), "b": _f32(4, seed=4)}),
    "gemm": ([_node("Flatten", ["x"], ["f"]),
              _node("Gemm", ["f", "w", "c"], ["y"], transB=1, alpha=0.5, beta=2.0)],
             {"w": _f32(5, 240, seed=5), "c": _f32(5, seed=6)}),
    "gemm_transA": ([_node("Flatten", ["x"], ["f"]),
                     _node("Gemm", ["f", "w"], ["y"], transA=1)], {"w": _f32(2, 7, seed=7)}),
    "matmul": ([_node("MatMul", ["x", "w"], ["y"])], {"w": _f32(8, 5, seed=8)}),
    "einsum": ([_node("Einsum", ["x", "w"], ["y"], equation=b"bchw,wk->bckh")],
               {"w": _f32(8, 4, seed=9)}),
    "binary": ([_node("Add", ["x", "c"], ["a"]), _node("Sub", ["a", "x"], ["s"]),
                _node("Mul", ["s", "x"], ["m"]), _node("Div", ["m", "c"], ["d"]),
                _node("Min", ["d", "x"], ["mn"]), _node("Max", ["mn", "c"], ["y"])],
               {"c": _f32(1, 3, 1, 1, seed=10, lo=0.5, hi=2.0)}),
    "pow_sqrt_exp_log": ([_node("Abs", ["x"], ["a"]), _node("Sqrt", ["a"], ["s"]),
                          _node("Pow", ["s", "p"], ["pw"]), _node("Exp", ["pw"], ["e"]),
                          _node("Log", ["e"], ["l"]), _node("Reciprocal", ["e"], ["r"]),
                          _node("Add", ["l", "r"], ["y"])], {"p": np.float32(1.5)}),
    "rounding": ([_node("Mul", ["x", "c"], ["m"]), _node("Floor", ["m"], ["f"]),
                  _node("Ceil", ["m"], ["c2"]), _node("Neg", ["c2"], ["n"]),
                  _node("Add", ["f", "n"], ["y"])], {"c": np.float32(3.7)}),
    "activations": ([_node("Relu", ["x"], ["r"]), _node("Sigmoid", ["x"], ["s"]),
                     _node("Tanh", ["x"], ["t"]), _node("Elu", ["x"], ["e"]),
                     _node("Softplus", ["x"], ["sp"]), _node("HardSigmoid", ["x"], ["hs"]),
                     _node("HardSwish", ["x"], ["hw"]), _node("Erf", ["x"], ["er"]),
                     _node("Concat", ["r", "s", "t", "e", "sp", "hs", "hw", "er"], ["y"],
                           axis=1)], {}),
    "leaky_prelu": ([_node("LeakyRelu", ["x"], ["l"], alpha=0.2),
                     _node("PRelu", ["l", "slope"], ["y"])], {"slope": _f32(3, seed=11)}),
    "gelu": ([_node("Gelu", ["x"], ["a"]), _node("Gelu", ["x"], ["b"], approximate=b"tanh"),
              _node("Sub", ["a", "b"], ["y"])], {}),
    "softmax": ([_node("Softmax", ["x"], ["y"], axis=1)], {}),
    "clip_inputs": ([_node("Clip", ["x", "lo", "hi"], ["y"])],
                    {"lo": np.float32(-0.3), "hi": np.float32(0.4)}),
    "clip_attrs": ([_node("Clip", ["x"], ["y"], min=-0.2, max=0.1)], {}),
    "logic_where": ([_node("Greater", ["x", "z"], ["g"]), _node("Less", ["x", "c"], ["l"]),
                     _node("And", ["g", "l"], ["a"]), _node("Not", ["a"], ["n"]),
                     _node("Or", ["n", "g"], ["o"]), _node("Equal", ["o", "a"], ["e"]),
                     _node("Where", ["e", "x", "c"], ["y"])],
                    {"z": np.float32(0.0), "c": np.float32(0.5)}),
    "reshape_transpose": ([_node("Reshape", ["x", "s"], ["r"]),
                           _node("Transpose", ["r"], ["y"], perm=[2, 0, 1])],
                          {"s": np.asarray([0, -1, 8], np.int64)}),
    "gather_data": ([_node("Gather", ["x", "i"], ["y"], axis=2)],
                    {"i": np.asarray([[0, -1], [3, 4]], np.int64)}),
    "slice_steps": ([_node("Slice", ["x", "st", "en", "ax", "sp"], ["y"])],
                    {"st": np.asarray([-1, 1], np.int64), "en": np.asarray([-100, 9], np.int64),
                     "ax": np.asarray([2, 3], np.int64), "sp": np.asarray([-2, 3], np.int64)}),
    "squeeze_unsqueeze": ([_node("Unsqueeze", ["x", "a"], ["u"]),
                           _node("Squeeze", ["u", "a"], ["s"]),
                           _node("Unsqueeze", ["s"], ["y"], axes=[-1])],
                          {"a": np.asarray([1, 4], np.int64)}),
    "expand_tile": ([_node("ReduceMean", ["x"], ["m"], axes=[1], keepdims=1),
                     _node("Expand", ["m", "s"], ["e"]), _node("Tile", ["e", "r"], ["y"])],
                    {"s": np.asarray([1, 3, 1, 1], np.int64),
                     "r": np.asarray([1, 1, 2, 1], np.int64)}),
    "cast_split": ([_node("Cast", ["x"], ["c"], to=6), _node("Cast", ["c"], ["f"], to=1),
                    _node("Split", ["f", "sizes"], ["y", "z"], axis=2)],
                   {"sizes": np.asarray([3, 7], np.int64)}),
    "split_even": ([_node("Split", ["x"], ["y", "z"], axis=3)], {}),
    "reduces": ([_node("ReduceSum", ["x"], ["s"], axes=[2, 3], keepdims=0),
                 _node("ReduceMax", ["x"], ["mx"], axes=[3], keepdims=0),
                 _node("ReduceMin", ["mx"], ["mn"], axes=[2], keepdims=0),
                 _node("ReduceProd", ["mn"], ["p"], axes=[1], keepdims=1),
                 _node("Add", ["s", "p"], ["y"])], {}),
    "global_pool": ([_node("GlobalAveragePool", ["x"], ["y"])], {}),
    "maxpool_ceil": ([_node("MaxPool", ["x"], ["y"], kernel_shape=[3, 3], strides=[2, 2],
                            ceil_mode=1)], {}),
    "avgpool_pads": ([_node("AveragePool", ["x"], ["y"], kernel_shape=[3, 3], strides=[2, 2],
                            pads=[1, 1, 1, 1], ceil_mode=1)], {}),
    "avgpool_with_pads": ([_node("AveragePool", ["x"], ["y"], kernel_shape=[2, 3],
                                 pads=[1, 0, 0, 1], count_include_pad=1)], {}),
    "norms": ([_node("BatchNormalization", ["x", "g", "b", "m", "v"], ["bn"], epsilon=1e-3),
               _node("InstanceNormalization", ["bn", "g", "b"], ["inn"]),
               _node("LayerNormalization", ["inn", "lg"], ["y"], axis=2)],
              {"g": _f32(3, seed=12, lo=0.5), "b": _f32(3, seed=13), "m": _f32(3, seed=14),
               "v": _f32(3, seed=15, lo=0.5, hi=1.5), "lg": _f32(10, 8, seed=16)}),
    "resize_linear_down": ([_node("Resize", ["x", "", "s"], ["y"], mode=b"linear")],
                           {"s": np.asarray([1, 1, 0.5, 0.375], np.float32)}),
    "resize_cubic_up": ([_node("Resize", ["x", "", "s"], ["y"], mode=b"cubic")],
                        {"s": np.asarray([1, 1, 2, 1.5], np.float32)}),
    "resize_nearest_sizes": ([_node("Resize", ["x", "", "", "s"], ["y"], mode=b"nearest")],
                             {"s": np.asarray([2, 3, 13, 7], np.int64)}),
    "resize_align_corners": ([_node("Resize", ["x", "", "s"], ["y"], mode=b"linear",
                                    coordinate_transformation_mode=b"align_corners")],
                             {"s": np.asarray([1, 1, 2, 2], np.float32)}),
    "upsample": ([_node("Upsample", ["x", "s"], ["y"], mode=b"nearest")],
                 {"s": np.asarray([1, 1, 2, 3], np.float32)}),
    "pad_constant": ([_node("Pad", ["x", "p", "v"], ["y"])],
                     {"p": np.asarray([0, 1, 2, 0, 0, 0, 1, 3], np.int64),
                      "v": np.float32(0.7)}),
    "pad_edge_attr": ([_node("Pad", ["x"], ["y"], mode=b"edge", pads=[0, 0, 2, 1, 0, 0, 1, 3])],
                      {}),
    "host_constants": ([_node("Constant", [], ["c"], value=np.asarray([2, 5], np.int64)),
                        _node("ConstantOfShape", ["c"], ["z"],
                              value=np.asarray([0.25], np.float32)),
                        _node("Range", ["r0", "r1", "r2"], ["r"]),
                        _node("Cast", ["r"], ["rf"], to=1),
                        _node("Mul", ["z", "rf"], ["y"])],
                       {"r0": np.asarray(0, np.int64), "r1": np.asarray(10, np.int64),
                        "r2": np.asarray(2, np.int64)}),
    "identity_dropout": ([_node("Identity", ["x"], ["i"]), _node("Dropout", ["i"], ["y"])], {}),
}


@pytest.mark.parametrize("name", sorted(OPS))
def test_op_matches_jax(name, tmp_path):
    nodes, inits = OPS[name]
    outputs = [o for o in nodes[-1]["outputs"]]
    p = str(tmp_path / f"{name}.onnx")
    write_onnx_graph(p, inputs=[("x", list(X))], outputs=[(o, None) for o in outputs],
                     nodes=nodes, initializers=inits)
    x = _f32(*X, seed=20)
    jexe = JExecutor(p)
    want = [np.asarray(o) for o in jexe.run(jexe.initializers, {"x": x})]
    got = _run(p, {"x": x})
    for g, w in zip(got, want):
        assert g.shape == w.shape, (g.shape, w.shape)
        if w.dtype.kind in "biu":
            np.testing.assert_array_equal(g, w)
        else:
            assert np.abs(g - w).max() <= 1e-5 * (1 + np.abs(w).max())


# ---------------------------------------------------------------- the predictor


@pytest.mark.parametrize("video", [False, True], ids=["rank4", "rank5"])
def test_predictor_matches_jax(video, tmp_path):
    path = _depth_graph(tmp_path / "d.onnx", video=video)
    jpred = JPredictor(str(path), inference_size=70)
    pred = OnnxDepthPredictor(path, inference_size=70, device="cpu")
    assert pred.video == jpred.video == video and pred._size == (jpred._size,) * 2
    frames = np.random.default_rng(5).random((3, 40, 56, 3)).astype(np.float32)
    want = np.asarray(jpred(frames))
    got = pred(torch.from_numpy(frames)).numpy()
    assert got.shape == want.shape == (3, 64, 64)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_fixed_graph_size_wins(tmp_path):
    """A graph whose input is fixed at 96 x 96 runs at 96 whatever is asked."""
    p = tmp_path / "fixed.onnx"
    write_onnx_graph(str(p), inputs=[("input", [1, 3, 96, 96])], outputs=[("d", None)],
                     nodes=[_node("ReduceMean", ["input"], ["d"], axes=[1], keepdims=0)],
                     initializers={})
    assert OnnxDepthPredictor(p, inference_size=518, device="cpu")._size == (96, 96)


@pytest.mark.parametrize("kind", ["onnx", "local"])
def test_names_through_the_route_match_jax(kind, tmp_path):
    """onnx:<file> and local:<dir with model.onnx> through load_predictor and
    the depth route, u8 and per-frame percentiles, against the JAX route."""
    mdir = tmp_path / "model"
    mdir.mkdir()
    _depth_graph(mdir / "model.onnx")
    name = f"onnx:{mdir / 'model.onnx'}" if kind == "onnx" else f"local:{mdir}"
    pred = tregistry.load_predictor(name, inference_size=64, device="cpu")
    assert isinstance(pred, OnnxDepthPredictor) and pred._size == (64, 64)
    clip = tmp_path / "clip.y4m"
    _write_clip(clip, 40, 56, 5)
    kw = dict(model=name, inference_size=64, batch_size=2)
    assert bounded(jroute, clip, tmp_path / "jax.y4m", JConfig(mesh="off", **kw)) == 5
    assert render_depth_video_file(clip, tmp_path / "port.y4m",
                                   DepthConfig(device="cpu", **kw)) == 5
    want, got = _read(tmp_path / "jax.y4m"), _read(tmp_path / "port.y4m")
    assert got.shape == want.shape == (5, 40, 56) and got.std() > 0
    assert np.abs(got - want).max() <= 1


def test_tiled_onnx_route(tmp_path):
    """F2: the JAX route's tiled mode reads ``_size[0]`` of the ONNX
    predictor's int size and fails; the port's (s, s) tiles."""
    from visiondepth3d_tpu_torch.cli.main import main as cli_main

    model = _depth_graph(tmp_path / "m.onnx")
    clip = tmp_path / "clip.y4m"
    _write_clip(clip, 48, 96, 3)
    kw = dict(model=f"onnx:{model}", inference_size=64, tile_size=64, tile_overlap=16,
              tiled=True, batch_size=2)
    with pytest.raises(TypeError, match="not subscriptable"):
        bounded(jroute, clip, tmp_path / "jax.y4m", JConfig(mesh="off", **kw))
    assert render_depth_video_file(clip, tmp_path / "port.y4m",
                                   DepthConfig(device="cpu", **kw)) == 3
    got = _read(tmp_path / "port.y4m")
    assert got.shape == (3, 48, 96) and got.std() > 0
    out = tmp_path / "cli.y4m"
    assert cli_main(["depth", "--input", str(clip), "--output", str(out), "--device", "cpu",
                     "--model", f"onnx:{model}", "--inference-size", "64", "--tiled",
                     "--tile-size", "64", "--tile-overlap", "16", "--batch-size", "2"]) == 0
    np.testing.assert_array_equal(_read(out), got)


def _save_native(root, params, base):
    from safetensors.numpy import save_file

    flat = {}

    def walk(prefix, node):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(f"{prefix}{k}/", v)
            else:
                flat[f"{prefix}{k}"] = np.ascontiguousarray(np.asarray(v, np.float32))

    walk("", params)
    root.mkdir()
    save_file(flat, str(root / "model.safetensors"))
    (root / "vd3d.json").write_text(json.dumps({"family": "x", "base": base}))


def test_local_native_params(tmp_path):
    """A JAX params tree of the tiny Depth Anything, saved flat as the JAX
    package's ``vd3d convert`` saves it, loads through from_jax_params."""
    size = 56
    root = tmp_path / "native"
    _save_native(root, init_random(JDA_TINY, seed=3, size=size), "depth-anything-v2-small")
    jpred = jregistry.load_predictor(f"local:{root}", None, size, config=JDA_TINY)
    pred = tregistry.load_predictor(f"local:{root}", None, size, config=tconfigs.DA_TINY,
                                    device="cpu")
    frames = np.random.default_rng(6).random((2, size, size, 3)).astype(np.float32)
    want = np.asarray(jpred(frames))
    got = pred(torch.from_numpy(frames)).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-4 * float(want.max() - want.min())


def test_local_native_without_a_converter_raises(tmp_path):
    root = tmp_path / "marigold"
    _save_native(root, {"a": {"b": np.zeros(2)}}, "marigold")
    with pytest.raises(NotImplementedError, match="diffusion family.*dpt_dinov2.*vda"):
        tregistry.load_predictor(f"local:{root}", device="cpu")
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError, match="vd3d.json"):
        tregistry.load_predictor(f"local:{tmp_path / 'empty'}", device="cpu")


# ---------------------------------------------------------------- the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("video", [False, True], ids=["rank4", "rank5"])
def test_cuda_onnx_predictor_matches_cpu(cuda, video, tmp_path):
    """float32, TF32 off: 1e-5 x max |ref|."""
    path = _depth_graph(tmp_path / "d.onnx", video=video)
    frames = torch.from_numpy(np.random.default_rng(7).random((3, 40, 56, 3)).astype(np.float32))
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        want = OnnxDepthPredictor(path, 64, device="cpu")(frames)
        got = OnnxDepthPredictor(path, 64, device="cuda")(frames.to(cuda)).cpu()
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()
