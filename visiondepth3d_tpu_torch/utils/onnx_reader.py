"""Minimal ONNX reader and writer — no ``onnx`` package required.

The port's copy of ``visiondepth3d_tpu/utils/onnx_reader.py`` (numpy only).
The reference distributes RIFE and Real-ESRGAN as ONNX exports
(``weights/RIFE_fp32.onnx``, merged_pipeline.py:52-60); the port converts
their weights into its modules' state dicts, for which the initializer
table (name -> tensor) is enough. The ONNX depth route
(``depth/onnx_exec.py``) runs a whole graph: ``read_onnx_graph`` parses
its nodes, attributes, inputs and outputs too, and ``write_onnx_graph``
emits one (the tests' and the smoke script's fixtures). ONNX is protobuf,
and the handful of wire-format fields involved are stable, so a tiny
hand-rolled parser avoids a dependency on the ``onnx`` package.

Wire format walked here:
  ModelProto.graph        = field 7  (length-delimited GraphProto)
  GraphProto.initializer  = field 5  (repeated TensorProto)
  TensorProto.dims        = field 1  (repeated varint)
  TensorProto.data_type   = field 2  (varint; 1=f32 6=i32 7=i64 10=f16 11=f64)
  TensorProto.float_data  = field 4  (packed floats, alt encoding)
  TensorProto.int64_data  = field 7  (packed varints, alt encoding)
  TensorProto.name        = field 8  (bytes)
  TensorProto.raw_data    = field 9  (bytes, little-endian)
"""

from __future__ import annotations

import numpy as np

_DTYPES = {
    1: np.float32,
    6: np.int32,
    7: np.int64,
    9: np.bool_,
    10: np.float16,
    11: np.float64,
    12: np.uint32,
    13: np.uint64,
}


def _read_varint(buf: bytes, pos: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _fields(buf: bytes):
    """Yield (field_number, wire_type, value) over a protobuf message.

    value is an int for varints, bytes for length-delimited fields, and
    raw little-endian bytes for fixed32/fixed64.
    """
    pos = 0
    n = len(buf)
    while pos < n:
        key, pos = _read_varint(buf, pos)
        field, wire = key >> 3, key & 0x7
        if wire == 0:  # varint
            val, pos = _read_varint(buf, pos)
        elif wire == 1:  # fixed64
            val, pos = buf[pos : pos + 8], pos + 8
        elif wire == 2:  # length-delimited
            ln, pos = _read_varint(buf, pos)
            val, pos = buf[pos : pos + ln], pos + ln
        elif wire == 5:  # fixed32
            val, pos = buf[pos : pos + 4], pos + 4
        else:
            raise ValueError(f"unsupported protobuf wire type {wire}")
        yield field, wire, val


def _parse_tensor(buf: bytes) -> tuple[str, np.ndarray]:
    dims: list[int] = []
    dtype_code = 1
    name = ""
    raw = None
    float_data: list[float] = []
    int64_data: list[int] = []
    for field, wire, val in _fields(buf):
        if field == 1 and wire == 0:
            dims.append(val)
        elif field == 2 and wire == 0:
            dtype_code = val
        elif field == 8 and wire == 2:
            name = val.decode("utf-8")
        elif field == 9 and wire == 2:
            raw = val
        elif field == 4:
            if wire == 2:  # packed
                float_data.extend(np.frombuffer(val, "<f4").tolist())
            else:
                float_data.append(np.frombuffer(val, "<f4")[0])
        elif field == 7:
            if wire == 2:  # packed varints
                pos = 0
                while pos < len(val):
                    v, pos = _read_varint(val, pos)
                    int64_data.append(v)
            else:
                int64_data.append(val)
    dtype = _DTYPES.get(dtype_code)
    if dtype is None:
        raise ValueError(f"initializer {name!r}: unsupported dtype {dtype_code}")
    if raw is not None:
        arr = np.frombuffer(raw, np.dtype(dtype).newbyteorder("<"))
    elif float_data:
        arr = np.asarray(float_data, np.float32)
    elif int64_data:
        arr = np.asarray(int64_data, np.int64)
    else:
        arr = np.zeros(0, dtype)
    return name, arr.reshape(dims).astype(dtype, copy=False)


def read_onnx_initializers(path) -> dict[str, np.ndarray]:
    """Parse an .onnx file and return its initializers as name -> ndarray."""
    with open(path, "rb") as f:
        model = f.read()
    graph = None
    for field, wire, val in _fields(model):
        if field == 7 and wire == 2:
            graph = val
            break
    if graph is None:
        raise ValueError(f"{path}: no graph found (not an ONNX ModelProto?)")
    out: dict[str, np.ndarray] = {}
    for field, wire, val in _fields(graph):
        if field == 5 and wire == 2:
            name, arr = _parse_tensor(val)
            out[name] = arr
    return out


def _parse_attribute(buf: bytes):
    """AttributeProto -> (name, python value).

    Fields: name=1, f=2 (fixed32 float), i=3 (varint int, zigzag NOT used
    by onnx), s=4 (bytes), t=5 (TensorProto), floats=7, ints=8, strings=9.
    """
    name = ""
    f_val = i_val = s_val = t_val = None
    floats: list[float] = []
    ints: list[int] = []
    strings: list[bytes] = []
    for field, wire, val in _fields(buf):
        if field == 1 and wire == 2:
            name = val.decode("utf-8")
        elif field == 2 and wire == 5:
            f_val = float(np.frombuffer(val, "<f4")[0])
        elif field == 3 and wire == 0:
            i_val = _signed(val)
        elif field == 4 and wire == 2:
            s_val = val
        elif field == 5 and wire == 2:
            t_val = _parse_tensor(val)[1]
        elif field == 7:
            if wire == 2:
                floats.extend(np.frombuffer(val, "<f4").tolist())
            elif wire == 5:
                floats.append(float(np.frombuffer(val, "<f4")[0]))
        elif field == 8:
            if wire == 2:
                pos = 0
                while pos < len(val):
                    v, pos = _read_varint(val, pos)
                    ints.append(_signed_of(v))
            elif wire == 0:
                ints.append(_signed(val))
        elif field == 9 and wire == 2:
            strings.append(val)
    for v in (t_val, s_val, f_val, i_val):
        if v is not None:
            return name, v
    if floats:
        return name, floats
    if ints:
        return name, ints
    if strings:
        return name, strings
    return name, None


def _signed_of(v: int) -> int:
    """Protobuf int64 varints are two's-complement over 64 bits."""
    return v - (1 << 64) if v >= (1 << 63) else v


def _signed(v: int) -> int:
    return _signed_of(v)


def _parse_node(buf: bytes):
    """NodeProto -> dict(op, inputs, outputs, name, attrs)."""
    inputs: list[str] = []
    outputs: list[str] = []
    name = op = ""
    attrs: dict = {}
    for field, wire, val in _fields(buf):
        if field == 1 and wire == 2:
            inputs.append(val.decode("utf-8"))
        elif field == 2 and wire == 2:
            outputs.append(val.decode("utf-8"))
        elif field == 3 and wire == 2:
            name = val.decode("utf-8")
        elif field == 4 and wire == 2:
            op = val.decode("utf-8")
        elif field == 5 and wire == 2:
            k, v = _parse_attribute(val)
            attrs[k] = v
    return {"op": op, "name": name, "inputs": inputs, "outputs": outputs,
            "attrs": attrs}


def _parse_value_info(buf: bytes):
    """ValueInfoProto -> (name, [dim or None, ...] or None)."""
    name = ""
    shape = None
    for field, wire, val in _fields(buf):
        if field == 1 and wire == 2:
            name = val.decode("utf-8")
        elif field == 2 and wire == 2:  # TypeProto
            for f2, w2, v2 in _fields(val):
                if f2 == 1 and w2 == 2:  # tensor_type
                    for f3, w3, v3 in _fields(v2):
                        if f3 == 2 and w3 == 2:  # shape
                            dims: list = []
                            for f4, w4, v4 in _fields(v3):
                                if f4 == 1 and w4 == 2:  # dim
                                    dim_val = None
                                    for f5, w5, v5 in _fields(v4):
                                        if f5 == 1 and w5 == 0:
                                            dim_val = v5
                                    dims.append(dim_val)
                            shape = dims
    return name, shape


def read_onnx_graph(path) -> dict:
    """Full-graph parse: {inputs, outputs, nodes, initializers}.

    inputs/outputs: [(name, shape-with-None-for-dynamic)], graph inputs
    exclude initializer names (matching onnxruntime's get_inputs()).
    """
    with open(path, "rb") as f:
        model = f.read()
    graph = None
    for field, wire, val in _fields(model):
        if field == 7 and wire == 2:
            graph = val
            break
    if graph is None:
        raise ValueError(f"{path}: no graph found (not an ONNX ModelProto?)")
    nodes: list = []
    inits: dict[str, np.ndarray] = {}
    inputs: list = []
    outputs: list = []
    for field, wire, val in _fields(graph):
        if field == 1 and wire == 2:
            nodes.append(_parse_node(val))
        elif field == 5 and wire == 2:
            name, arr = _parse_tensor(val)
            inits[name] = arr
        elif field == 11 and wire == 2:
            inputs.append(_parse_value_info(val))
        elif field == 12 and wire == 2:
            outputs.append(_parse_value_info(val))
    inputs = [(n, s) for n, s in inputs if n not in inits]
    return {"inputs": inputs, "outputs": outputs, "nodes": nodes,
            "initializers": inits}


def _varint(v: int) -> bytes:
    out = b""
    while True:
        b7 = v & 0x7F
        v >>= 7
        if v:
            out += bytes([b7 | 0x80])
        else:
            return out + bytes([b7])


def _field(num: int, wire: int, payload) -> bytes:
    key = _varint(num << 3 | wire)
    if wire == 0:
        return key + _varint(payload)
    if wire == 5:
        return key + payload
    return key + _varint(len(payload)) + payload


def _tensor_bytes(name: str, arr: np.ndarray) -> bytes:
    shape = arr.shape  # ascontiguousarray promotes 0-d to (1,)
    arr = np.ascontiguousarray(arr)
    code = {v: k for k, v in _DTYPES.items()}[arr.dtype.type]
    t = b"".join(_field(1, 0, d) for d in shape)
    t += _field(2, 0, code)
    t += _field(8, 2, name.encode("utf-8"))
    t += _field(9, 2, arr.astype(arr.dtype.newbyteorder("<")).tobytes())
    return t


def write_onnx_initializers(path, tensors: dict[str, np.ndarray]) -> None:
    """Emit a minimal valid ONNX ModelProto holding only initializers.

    Test/fixture helper: round-trips through read_onnx_initializers and
    matches the wire layout real exporters produce for the fields we read.
    """
    graph = b"".join(_field(5, 2, _tensor_bytes(n, a))
                     for n, a in tensors.items())
    model = _field(1, 0, 8)  # ir_version
    model += _field(7, 2, graph)
    with open(path, "wb") as f:
        f.write(model)


def _attr_bytes(name: str, val) -> bytes:
    a = _field(1, 2, name.encode("utf-8"))
    if isinstance(val, np.ndarray):
        a += _field(5, 2, _tensor_bytes("", val))
    elif isinstance(val, bytes):
        a += _field(4, 2, val)
    elif isinstance(val, str):
        a += _field(4, 2, val.encode("utf-8"))
    elif isinstance(val, float):
        a += _field(2, 5, np.float32(val).tobytes())
    elif isinstance(val, int):
        a += _field(3, 0, val & ((1 << 64) - 1))
    elif isinstance(val, (list, tuple)):
        if all(isinstance(v, int) for v in val):
            for v in val:
                a += _field(8, 0, v & ((1 << 64) - 1))
        else:
            for v in val:
                a += _field(7, 5, np.float32(v).tobytes())
    else:
        raise TypeError(f"attribute {name}: {type(val)}")
    return a


def _value_info_bytes(name: str, shape) -> bytes:
    dims = b""
    for d in shape or ():
        dims += _field(1, 2, b"" if d is None else _field(1, 0, d))
    tensor_type = _field(1, 0, 1) + _field(2, 2, dims)  # elem f32
    return _field(1, 2, name.encode("utf-8")) + _field(
        2, 2, _field(1, 2, tensor_type))


def write_onnx_graph(path, inputs, outputs, nodes,
                     initializers: dict[str, np.ndarray]) -> None:
    """Emit a full ONNX ModelProto — the fixture generator for the graph
    executor tests (the environment has no ``onnx`` package and torch's
    exporter requires it).

    inputs/outputs: [(name, shape)]; nodes: [{"op", "inputs", "outputs",
    "attrs", "name"?}].
    """
    graph = b""
    for n in nodes:
        nb = b""
        for i in n["inputs"]:
            nb += _field(1, 2, i.encode("utf-8"))
        for o in n["outputs"]:
            nb += _field(2, 2, o.encode("utf-8"))
        nb += _field(3, 2, n.get("name", "").encode("utf-8"))
        nb += _field(4, 2, n["op"].encode("utf-8"))
        for k, v in n.get("attrs", {}).items():
            nb += _field(5, 2, _attr_bytes(k, v))
        graph += _field(1, 2, nb)
    for name, arr in initializers.items():
        graph += _field(5, 2, _tensor_bytes(name, arr))
    for name, shape in inputs:
        graph += _field(11, 2, _value_info_bytes(name, shape))
    for name, shape in outputs:
        graph += _field(12, 2, _value_info_bytes(name, shape))
    model = _field(1, 0, 8)
    model += _field(7, 2, graph)
    with open(path, "wb") as f:
        f.write(model)
