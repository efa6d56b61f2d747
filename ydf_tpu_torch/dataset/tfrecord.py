"""TFRecord of tf.Example, reader and writer, no TensorFlow (counterpart
of ydf_tpu/dataset/tfrecord.py, itself the reference's TF-free
`tfrecord` / `tfrecord-nocompression` prefixes): record framing is
[u64le length][u32 masked-crc32c(length)][payload][u32 masked-crc32c
(payload)], optionally whole-file gzip (the reference's
FORMAT_TFE_TFRECORD_COMPRESSED_V2). Payloads are tf.Example protos,
parsed with the same schema-less wire codec as the model format
(utils/protowire.py):

    Example{ features:1 } Features{ feature(map):1 }
    map entry{ key:1, value:2 } Feature{ bytes_list:1, float_list:2,
    int64_list:3 }, each list: repeated field 1.

Column typing: one value per Example → scalar column (bytes decode to
str); zero values → missing; multi-valued features → object list cells
(inference then treats string lists as CATEGORICAL_SET).
"""

from __future__ import annotations

import glob
import gzip
import os
import struct
from typing import Dict, Iterator, List, Optional

import numpy as np

from ydf_tpu_torch.utils import protowire as pw

# --------------------------------------------------------------------- #
# crc32c (Castagnoli), table-driven — needed to WRITE valid files
# (readers like TensorFlow verify it; our reader skips verification).
# --------------------------------------------------------------------- #

_CRC_TABLE: Optional[List[int]] = None


def _crc32c_table() -> List[int]:
    global _CRC_TABLE
    if _CRC_TABLE is None:
        poly = 0x82F63B78
        tbl = []
        for i in range(256):
            c = i
            for _ in range(8):
                c = (c >> 1) ^ poly if c & 1 else c >> 1
            tbl.append(c)
        _CRC_TABLE = tbl
    return _CRC_TABLE


def _crc32c(data: bytes) -> int:
    tbl = _crc32c_table()
    c = 0xFFFFFFFF
    for b in data:
        c = tbl[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    c = _crc32c(data)
    return ((c >> 15 | c << 17) + 0xA282EAD8) & 0xFFFFFFFF


# --------------------------------------------------------------------- #
# Record framing
# --------------------------------------------------------------------- #


def _open_maybe_gzip(path: str):
    with open(path, "rb") as f:
        magic = f.read(2)
    if magic == b"\x1f\x8b":
        return gzip.open(path, "rb")
    return open(path, "rb")


def iter_records(path: str) -> Iterator[bytes]:
    with _open_maybe_gzip(path) as f:
        while True:
            head = f.read(12)
            if len(head) < 12:
                return
            (length,) = struct.unpack("<Q", head[:8])
            payload = f.read(length)
            f.read(4)  # payload crc (unverified, like a fast reader)
            if len(payload) < length:
                raise ValueError(f"Truncated TFRecord in {path}")
            yield payload


def write_records(path: str, records, compressed: bool = False) -> None:
    opener = gzip.open if compressed else open
    with opener(path, "wb") as f:
        for rec in records:
            head = struct.pack("<Q", len(rec))
            f.write(head)
            f.write(struct.pack("<I", _masked_crc(head)))
            f.write(rec)
            f.write(struct.pack("<I", _masked_crc(rec)))


# --------------------------------------------------------------------- #
# tf.Example ⇄ columns
# --------------------------------------------------------------------- #


def _parse_example(buf: bytes) -> Dict[str, list]:
    msg = pw.decode(buf)
    feats = pw.get_msg(msg, 1)  # Example.features
    out: Dict[str, list] = {}
    if feats is None:
        return out
    for entry in pw.get_repeated_msg(feats, 1):  # map<string, Feature>
        key = pw.get_str(entry, 1)
        feature = pw.get_msg(entry, 2)
        if feature is None:
            out[key] = []
            continue
        bl = pw.get_msg(feature, 1)
        fl = pw.get_msg(feature, 2)
        il = pw.get_msg(feature, 3)
        if fl is not None:
            out[key] = [float(v) for v in pw.get_packed_floats(fl, 1)]
        elif il is not None:
            # int64 varints are two's-complement 64-bit: without the sign
            # fold, -1 reads as 2^64-1.
            out[key] = [
                v - (1 << 64) if v >= (1 << 63) else v
                for v in map(int, pw.get_packed_varints(il, 1))
            ]
        elif bl is not None:
            out[key] = [
                b.decode("utf-8", "replace")
                for b in _repeated_bytes(bl, 1)
            ]
        else:
            out[key] = []
    return out


def _repeated_bytes(msg: pw.Message, field: int) -> List[bytes]:
    # Message is {field: [raw values]}; BytesList items arrive as bytes.
    return [
        v
        for v in msg.get(field, [])
        if isinstance(v, (bytes, bytearray))
    ]


def read_tfrecord_columns(files: List[str]) -> Dict[str, np.ndarray]:
    """Sharded TFRecord files → columnar dict (row-wise Examples are
    transposed into columns, the reference's example-reader role)."""
    records = (rec for path in files for rec in iter_records(path))
    return tf_examples_to_columns(records)


def tf_examples_to_columns(serialized) -> Dict[str, np.ndarray]:
    """Serialized tf.Example protos → columnar dict. Also the serving
    adapter's parser (reference serving/tf_example.{h,cc}: feed
    tf.Examples straight to the engines)."""
    rows: List[Dict[str, list]] = []
    keys: List[str] = []
    seen = set()
    for rec in serialized:
        ex = _parse_example(rec)
        rows.append(ex)
        for k in ex:
            if k not in seen:
                seen.add(k)
                keys.append(k)
    n = len(rows)
    cols: Dict[str, np.ndarray] = {}
    for k in keys:
        vals = [r.get(k, []) for r in rows]
        lens = {len(v) for v in vals}
        if lens <= {0, 1}:
            scalars = [v[0] if v else None for v in vals]
            types = {type(s) for s in scalars if s is not None}
            if types <= {float, int}:
                cols[k] = np.array(
                    [np.nan if s is None else float(s) for s in scalars],
                    np.float64,
                )
            else:
                cols[k] = np.array(
                    ["" if s is None else str(s) for s in scalars], object
                )
        else:
            arr = np.empty((n,), object)
            for i, v in enumerate(vals):
                arr[i] = v
            cols[k] = arr
    return cols


def _encode_feature(value) -> bytes:
    if isinstance(value, (list, tuple, np.ndarray)):
        values = list(value)
    else:
        values = [value]
    if all(isinstance(v, (int, np.integer)) for v in values):
        inner = pw.put_msg(3, pw.put_packed_varints(1, values))
    elif all(isinstance(v, (int, float, np.floating, np.integer))
             for v in values):
        inner = pw.put_msg(2, pw.put_packed_floats(1, values))
    else:
        body = b"".join(
            pw.put_bytes(1, str(v).encode("utf-8")) for v in values
        )
        inner = pw.put_msg(1, body)
    return inner


def write_tfrecord_columns(
    path: str, cols: Dict[str, np.ndarray], compressed: bool = False
) -> None:
    n = len(next(iter(cols.values())))

    def records():
        for i in range(n):
            feats = b""
            for k, v in cols.items():
                cell = v[i]
                if cell is None or (
                    isinstance(cell, float) and np.isnan(cell)
                ):
                    continue  # missing = absent feature
                entry = pw.put_str(1, k) + pw.put_msg(
                    2, _encode_feature(cell)
                )
                feats += pw.put_msg(1, entry)
            yield pw.put_msg(1, feats)

    write_records(path, records(), compressed=compressed)


def resolve_tfrecord_path(path: str) -> List[str]:
    files = (
        sorted(glob.glob(path))
        if any(c in path for c in "*?[")
        else sorted(glob.glob(path + "-?????-of-?????")) or [path]
    )
    files = [f for f in files if os.path.exists(f)]
    if not files:
        raise FileNotFoundError(path)
    return files
