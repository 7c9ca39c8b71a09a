"""Minimal ONNX weight reader (no onnxruntime / onnx dependency).

The port's own copy of `adaprompt_tpu/utils/onnx_port.py` (numpy only). The
reference's face stack ships as insightface `antelopev2` ONNX models
(RetinaFace detector + ArcFace/glintr100 recognizer). Recognition runs
through the port's IResNet (models/arcface.py); this module extracts the
weights directly from the .onnx file by walking the protobuf wire format:
only the initializer tensors are needed, so a full ONNX runtime is
unnecessary.

Wire-format facts used (onnx.proto3):
  ModelProto.graph        = field 7  (message GraphProto)
  GraphProto.initializer  = field 5  (repeated message TensorProto)
  TensorProto.dims        = field 1  (repeated int64)
  TensorProto.data_type   = field 2  (enum; 1=float32, 6=int32, 7=int64,
                                      10=float16, 11=double)
  TensorProto.float_data  = field 4  (repeated float, packed)
  TensorProto.int64_data  = field 7  (repeated int64, packed)
  TensorProto.name        = field 8  (string)
  TensorProto.raw_data    = field 9  (bytes, little-endian)
"""

from __future__ import annotations

import numpy as np

_DTYPES = {1: np.float32, 2: np.uint8, 3: np.int8, 6: np.int32,
           7: np.int64, 10: np.float16, 11: np.float64}


def _read_varint(buf: bytes, i: int):
    out = 0
    shift = 0
    while True:
        b = buf[i]
        i += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, i
        shift += 7


def _fields(buf: bytes):
    """Yield (field_number, wire_type, value_bytes_or_int) over a message."""
    i = 0
    n = len(buf)
    while i < n:
        key, i = _read_varint(buf, i)
        field, wire = key >> 3, key & 7
        if wire == 0:          # varint
            val, i = _read_varint(buf, i)
        elif wire == 1:        # 64-bit
            val = buf[i:i + 8]
            i += 8
        elif wire == 2:        # length-delimited
            ln, i = _read_varint(buf, i)
            val = buf[i:i + ln]
            i += ln
        elif wire == 5:        # 32-bit
            val = buf[i:i + 4]
            i += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, val


def _parse_tensor(buf: bytes):
    dims, dtype, name, raw = [], 1, "", b""
    float_data, int64_data = [], []
    for field, wire, val in _fields(buf):
        if field == 1:
            if wire == 0:
                dims.append(val)
            else:  # packed
                i = 0
                while i < len(val):
                    d, i = _read_varint(val, i)
                    dims.append(d)
        elif field == 2 and wire == 0:
            dtype = val
        elif field == 4:
            float_data.extend(np.frombuffer(val, np.float32).tolist()
                              if wire == 2 else
                              [np.frombuffer(val, np.float32)[0]])
        elif field == 7 and wire == 2:
            i = 0
            while i < len(val):
                d, i = _read_varint(val, i)
                int64_data.append(d)
        elif field == 8 and wire == 2:
            name = val.decode("utf-8")
        elif field == 9 and wire == 2:
            raw = val
    np_dtype = _DTYPES.get(dtype)
    if np_dtype is None:
        return name, None
    if raw:
        arr = np.frombuffer(raw, np_dtype)
    elif float_data:
        arr = np.asarray(float_data, np.float32)
    elif int64_data:
        arr = np.asarray(int64_data, np.int64)
    else:
        arr = np.zeros((0,), np_dtype)
    if dims:
        arr = arr.reshape(dims)
    return name, arr


def read_onnx_initializers(path: str) -> dict:
    """Return {initializer_name: np.ndarray} from an .onnx file."""
    with open(path, "rb") as f:
        buf = f.read()
    out = {}
    for field, wire, val in _fields(buf):
        if field == 7 and wire == 2:                  # ModelProto.graph
            for gfield, gwire, gval in _fields(val):
                if gfield == 5 and gwire == 2:        # GraphProto.initializer
                    name, arr = _parse_tensor(gval)
                    if arr is not None:
                        out[name] = arr
    return out
