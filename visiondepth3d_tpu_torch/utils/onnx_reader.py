"""Minimal ONNX initializer reader — no ``onnx`` package required.

The port's copy of ``visiondepth3d_tpu/utils/onnx_reader.py`` (numpy only),
without its graph parser, which the port's ONNX route will bring when it
needs it. The reference distributes RIFE and Real-ESRGAN as ONNX exports
(``weights/RIFE_fp32.onnx``, merged_pipeline.py:52-60); the port converts
their weights into its modules' state dicts, and all it needs from the
file is the initializer table (name -> tensor). ONNX is protobuf, and the
handful of wire-format fields involved are stable, so a tiny hand-rolled
parser avoids a dependency on the ``onnx`` package.

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
