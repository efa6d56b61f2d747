"""polars / xarray dataset ingestion, duck-typed (counterpart of
ydf_tpu/dataset/frame_io.py).

Neither library ships in every image, so, as in grain_io.py, detection
goes through sys.modules: nothing here imports polars or xarray unless
the caller already did, and the adapters rely only on the stable public
surface (`df.columns` + `df[col].to_numpy()` for polars;
`ds.data_vars` + `ds[name].values` for xarray), so any object exposing
that surface ingests the same way.
"""

from __future__ import annotations

import sys
from typing import Any, Dict

import numpy as np


def _module_class(mod_name: str, cls_name: str):
    m = sys.modules.get(mod_name)
    c = getattr(m, cls_name, None) if m is not None else None
    return c if isinstance(c, type) else None


def is_polars_frame(data: Any) -> bool:
    c = _module_class("polars", "DataFrame")
    return c is not None and isinstance(data, c)


def is_xarray_dataset(data: Any) -> bool:
    c = _module_class("xarray", "Dataset")
    return c is not None and isinstance(data, c)


def polars_to_columns(df: Any) -> Dict[str, np.ndarray]:
    """polars DataFrame → {column: np.ndarray}. String/categorical
    columns come back as object arrays, which dataspec inference treats
    as CATEGORICAL — same as the pandas path."""
    out = {}
    for c in df.columns:
        out[str(c)] = np.asarray(df[c].to_numpy())
    return out


def iter_frame_chunks(frame: Any, chunk_rows: int):
    """Streams {column: ndarray} row chunks (≤ chunk_rows each) out of
    an in-memory columnar frame — pandas or polars DataFrame, or a
    plain dict of arrays. The fused ingestion path (dataset/cache.py)
    uses this to bin an in-memory frame into the on-disk cache chunk by
    chunk: each chunk is a row slice, converted column-wise."""
    if isinstance(frame, dict):
        n = len(next(iter(frame.values()))) if frame else 0
        cols = {k: np.asarray(v) for k, v in frame.items()}
        for s in range(0, n, chunk_rows):
            yield {k: v[s: s + chunk_rows] for k, v in cols.items()}
        return
    if not (hasattr(frame, "columns") and hasattr(frame, "__getitem__")):
        raise TypeError(
            f"Unsupported frame type for chunked ingestion: {type(frame)}"
        )
    n = len(frame)
    names = [str(c) for c in frame.columns]
    for s in range(0, n, chunk_rows):
        sl = frame[s: s + chunk_rows] if is_polars_frame(frame) else (
            frame.iloc[s: s + chunk_rows]
        )
        yield {c: np.asarray(sl[c].to_numpy()) for c in names}


def xarray_to_columns(ds: Any) -> Dict[str, np.ndarray]:
    """xarray Dataset → {variable: np.ndarray}; every data_var must be
    1-D over the shared example dimension (the reference's xarray_io
    contract)."""
    out = {}
    for name in ds.data_vars:
        v = np.asarray(ds[name].values)
        if v.ndim != 1:
            raise ValueError(
                f"xarray variable {name!r} has shape {v.shape}; expected "
                "1-D columns over the example dimension"
            )
        out[str(name)] = v
    return out
