"""Avro Object Container File reader, no Avro library (counterpart of
ydf_tpu/dataset/avro.py, itself the reference's `avro:` prefix): decodes
record schemas with the field types the reference consumes —
primitives, `["null", T]` unions, arrays of primitives (multi-valued /
categorical-set cells) and arrays of float arrays
(NUMERICAL_VECTOR_SEQUENCE cells). Codecs: null and deflate.
"""

from __future__ import annotations

import json
import struct
import zlib
from typing import Any, Dict, List

import numpy as np

_MAGIC = b"Obj\x01"


class _Reader:
    def __init__(self, buf: bytes):
        self.b = buf
        self.pos = 0

    def read(self, n: int) -> bytes:
        out = self.b[self.pos: self.pos + n]
        if len(out) < n:
            raise ValueError("truncated Avro data")
        self.pos += n
        return out

    def long(self) -> int:
        acc = 0
        shift = 0
        while True:
            byte = self.b[self.pos]
            self.pos += 1
            acc |= (byte & 0x7F) << shift
            if not byte & 0x80:
                break
            shift += 7
        return (acc >> 1) ^ -(acc & 1)  # zigzag

    def value(self, schema) -> Any:
        if isinstance(schema, list):  # union
            idx = self.long()
            return self.value(schema[idx])
        if isinstance(schema, dict):
            t = schema["type"]
            if t == "array":
                items = []
                while True:
                    cnt = self.long()
                    if cnt == 0:
                        break
                    if cnt < 0:
                        self.long()  # block byte size (skippable hint)
                        cnt = -cnt
                    for _ in range(cnt):
                        items.append(self.value(schema["items"]))
                return items
            if t == "record":
                return {
                    f["name"]: self.value(f["type"])
                    for f in schema["fields"]
                }
            return self.value(t)
        if schema == "null":
            return None
        if schema == "boolean":
            return self.read(1)[0] != 0
        if schema in ("int", "long"):
            return self.long()
        if schema == "float":
            return struct.unpack("<f", self.read(4))[0]
        if schema == "double":
            return struct.unpack("<d", self.read(8))[0]
        if schema in ("string", "bytes"):
            n = self.long()
            raw = self.read(n)
            return raw.decode("utf-8", "replace") if schema == "string" else raw
        raise NotImplementedError(f"Avro type {schema!r}")


def read_avro_rows(path: str) -> tuple:
    """(rows: list of field dicts, schema)"""
    data = open(path, "rb").read()
    if data[:4] != _MAGIC:
        raise ValueError(f"{path} is not an Avro container file")
    r = _Reader(data)
    r.pos = 4
    meta: Dict[str, bytes] = {}
    while True:
        cnt = r.long()
        if cnt == 0:
            break
        if cnt < 0:
            r.long()
            cnt = -cnt
        for _ in range(cnt):
            k = r.read(r.long()).decode()
            meta[k] = bytes(r.read(r.long()))
    sync = r.read(16)
    codec = meta.get("avro.codec", b"null").decode()
    if codec not in ("null", "deflate"):
        raise NotImplementedError(f"Avro codec {codec!r}")
    schema = json.loads(meta["avro.schema"])
    rows: List[Dict[str, Any]] = []
    while r.pos < len(data):
        n_obj = r.long()
        size = r.long()
        block = r.read(size)
        if codec == "deflate":
            block = zlib.decompress(block, -15)  # raw deflate
        br = _Reader(block)
        for _ in range(n_obj):
            rows.append(br.value(schema))
        if r.read(16) != sync:
            raise ValueError("Avro sync marker mismatch")
    return rows, schema


def read_avro_columns(files: List[str]) -> Dict[str, np.ndarray]:
    """Sharded Avro files → columnar dict. Nested float arrays become
    [L, D] ndarray cells (vector sequences); flat arrays stay lists;
    null/None cells become NaN (numerical) or missing markers."""
    rows: List[Dict[str, Any]] = []
    schema = None
    for f in files:
        rr, schema = read_avro_rows(f)
        rows.extend(rr)
    if schema is None or not rows:
        return {}
    cols: Dict[str, np.ndarray] = {}
    for field in schema["fields"]:
        name = field["name"]
        if _is_null_type(field["type"]):
            continue  # a pure-null column carries no data
        vals = [row.get(name) for row in rows]
        if all(
            v is None or isinstance(v, (bool, int, float)) for v in vals
        ):
            cols[name] = np.array(
                [np.nan if v is None else float(v) for v in vals],
                np.float64,
            )
        elif all(v is None or isinstance(v, str) for v in vals):
            cols[name] = np.array(
                ["" if v is None else v for v in vals], object
            )
        else:
            arr = np.empty((len(vals),), object)
            for i, v in enumerate(vals):
                if isinstance(v, list) and v and isinstance(v[0], list):
                    arr[i] = np.asarray(v, np.float32)  # vector sequence
                elif isinstance(v, (bytes, bytearray)):
                    arr[i] = v.decode("utf-8", "replace")
                else:
                    arr[i] = v
            cols[name] = arr
    return cols


def _is_null_type(t) -> bool:
    return t == "null" or (isinstance(t, dict) and t.get("type") == "null")
