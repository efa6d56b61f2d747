"""Minimal protobuf wire-format encoder/decoder (schema-less).

Clean-room implementation of the protobuf wire encoding (varint /
fixed32 / fixed64 / length-delimited), used to read the reference's
serialized model artifacts (`data_spec.pb`, `header.pb`, node records)
without depending on protoc or the reference's .proto files. Field
numbers and semantics are interface facts of the file format, cited at
each use site in ydf_tpu_torch/models/ydf_format.py. The port's own copy
of ydf_tpu/utils/protowire.py, byte for byte the same encodings.

A decoded message is a dict: field_number -> list of raw values in file
order, where a raw value is an int (varint, fixed32, fixed64 — kept as
unsigned bits) or bytes (length-delimited). Typed accessors reinterpret
raw values (float bits, zigzag, packed arrays, UTF-8, submessages).
"""

from __future__ import annotations

import struct
from typing import Dict, List, Optional, Union

import numpy as np

RawValue = Union[int, bytes]
Message = Dict[int, List[RawValue]]

_WIRE_VARINT = 0
_WIRE_FIXED64 = 1
_WIRE_BYTES = 2
_WIRE_START_GROUP = 3
_WIRE_END_GROUP = 4
_WIRE_FIXED32 = 5


def read_varint(buf: bytes, pos: int) -> tuple[int, int]:
    """Returns (value, new_pos)."""
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not (b & 0x80):
            return result, pos
        shift += 7
        if shift > 70:
            raise ValueError("varint too long")


def decode(buf: bytes) -> Message:
    """Decodes one message body into {field: [raw values]}."""
    msg: Message = {}
    pos, end = 0, len(buf)
    while pos < end:
        tag, pos = read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == _WIRE_VARINT:
            val, pos = read_varint(buf, pos)
        elif wire == _WIRE_FIXED64:
            (val,) = struct.unpack_from("<Q", buf, pos)
            pos += 8
        elif wire == _WIRE_BYTES:
            ln, pos = read_varint(buf, pos)
            val = buf[pos : pos + ln]
            pos += ln
        elif wire == _WIRE_FIXED32:
            (val,) = struct.unpack_from("<I", buf, pos)
            pos += 4
        elif wire in (_WIRE_START_GROUP, _WIRE_END_GROUP):
            raise ValueError("proto groups are not supported")
        else:
            raise ValueError(f"unknown wire type {wire}")
        msg.setdefault(field, []).append(val)
    return msg


# --------------------------------------------------------------------- #
# Typed accessors
# --------------------------------------------------------------------- #


def _last(msg: Message, field: int) -> Optional[RawValue]:
    vs = msg.get(field)
    return vs[-1] if vs else None


def get_int(msg: Message, field: int, default: int = 0) -> int:
    v = _last(msg, field)
    return default if v is None else int(v)


def get_sint(msg: Message, field: int, default: int = 0) -> int:
    """int32/int64 fields: varints are two's-complement 64-bit."""
    v = _last(msg, field)
    if v is None:
        return default
    v = int(v)
    return v - (1 << 64) if v >= (1 << 63) else v


def get_bool(msg: Message, field: int, default: bool = False) -> bool:
    v = _last(msg, field)
    return default if v is None else bool(v)


def get_float(msg: Message, field: int, default: float = 0.0) -> float:
    """float field (fixed32 bits)."""
    v = _last(msg, field)
    if v is None:
        return default
    return float(np.uint32(v).view(np.float32))


def get_double(msg: Message, field: int, default: float = 0.0) -> float:
    v = _last(msg, field)
    if v is None:
        return default
    return float(np.uint64(v).view(np.float64))


def get_bytes(msg: Message, field: int, default: bytes = b"") -> bytes:
    v = _last(msg, field)
    return default if v is None else bytes(v)


def get_str(msg: Message, field: int, default: str = "") -> str:
    v = _last(msg, field)
    return default if v is None else bytes(v).decode("utf-8")


def get_msg(msg: Message, field: int) -> Optional[Message]:
    v = _last(msg, field)
    return None if v is None else decode(bytes(v))


def get_repeated_msg(msg: Message, field: int) -> List[Message]:
    return [decode(bytes(v)) for v in msg.get(field, [])]


def get_packed_floats(msg: Message, field: int) -> np.ndarray:
    """repeated float [packed]; also accepts unpacked fixed32 records."""
    out = []
    for v in msg.get(field, []):
        if isinstance(v, bytes):
            out.append(np.frombuffer(v, dtype="<f4"))
        else:
            out.append(np.uint32(v).view(np.float32).reshape(1))
    if not out:
        return np.zeros((0,), np.float32)
    return np.concatenate(out).astype(np.float32)


def get_packed_doubles(msg: Message, field: int) -> np.ndarray:
    out = []
    for v in msg.get(field, []):
        if isinstance(v, bytes):
            out.append(np.frombuffer(v, dtype="<f8"))
        else:
            out.append(np.uint64(v).view(np.float64).reshape(1))
    if not out:
        return np.zeros((0,), np.float64)
    return np.concatenate(out).astype(np.float64)


def get_packed_varints(msg: Message, field: int) -> List[int]:
    """repeated int32/int64 [packed]; also accepts unpacked varints."""
    out: List[int] = []
    for v in msg.get(field, []):
        if isinstance(v, bytes):
            pos = 0
            while pos < len(v):
                val, pos = read_varint(v, pos)
                out.append(val)
        else:
            out.append(int(v))
    return out


# --------------------------------------------------------------------- #
# Encoder (schema-less writers, field numbers supplied by the caller)
# --------------------------------------------------------------------- #


def encode_varint(value: int) -> bytes:
    out = bytearray()
    v = value & ((1 << 64) - 1)  # two's-complement for negative ints
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _tag(field: int, wire: int) -> bytes:
    return encode_varint((field << 3) | wire)


def put_int(field: int, value: int) -> bytes:
    return _tag(field, _WIRE_VARINT) + encode_varint(int(value))


def put_bool(field: int, value: bool) -> bytes:
    return put_int(field, 1 if value else 0)


def put_float(field: int, value: float) -> bytes:
    return _tag(field, _WIRE_FIXED32) + np.float32(value).tobytes()


def put_double(field: int, value: float) -> bytes:
    return _tag(field, _WIRE_FIXED64) + np.float64(value).tobytes()


def put_bytes(field: int, value: bytes) -> bytes:
    return _tag(field, _WIRE_BYTES) + encode_varint(len(value)) + value


def put_str(field: int, value: str) -> bytes:
    return put_bytes(field, value.encode("utf-8"))


def put_msg(field: int, body: bytes) -> bytes:
    return put_bytes(field, body)


def put_packed_floats(field: int, values) -> bytes:
    arr = np.asarray(values, dtype="<f4")
    if arr.size == 0:
        return b""
    return put_bytes(field, arr.tobytes())


def put_packed_doubles(field: int, values) -> bytes:
    arr = np.asarray(values, dtype="<f8")
    if arr.size == 0:
        return b""
    return put_bytes(field, arr.tobytes())


def put_packed_varints(field: int, values) -> bytes:
    if len(values) == 0:
        return b""
    body = b"".join(encode_varint(int(v)) for v in values)
    return put_bytes(field, body)
