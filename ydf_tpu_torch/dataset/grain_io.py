"""PyGrain dataset ingestion (counterpart of ydf_tpu/dataset/grain_io.py).

A Grain DataLoader / MapDataset / IterDataset (or their iterators)
yields one example per element, typically a `{column: value}` dict, and
ingestion stacks the elements per key into the columnar layout. Grain
is detected via sys.modules so the dependency stays optional: nothing
here imports grain unless the caller already did."""

from __future__ import annotations

import sys
from typing import Any, Dict

import numpy as np


def _grain_classes():
    mods = []
    for name in ("grain", "grain.python"):
        m = sys.modules.get(name)
        if m is not None:
            mods.append(m)
    classes = []
    for m in mods:
        for cname in (
            "DataLoader",
            "DataLoaderIterator",
            "DatasetIterator",
            "PyGrainDatasetIterator",
            "MapDataset",
            "IterDataset",
        ):
            c = getattr(m, cname, None)
            if isinstance(c, type):
                classes.append(c)
    return tuple(classes)


def is_grain(data: Any) -> bool:
    classes = _grain_classes()
    return bool(classes) and isinstance(data, classes)


def _scalarize(v: Any) -> Any:
    if isinstance(v, np.ndarray) and v.ndim == 0:
        v = v.item()
    elif isinstance(v, np.generic):
        v = v.item()
    if isinstance(v, bytes):
        return v.decode("utf-8", "replace")
    return v


def to_columns(data: Any) -> Dict[str, np.ndarray]:
    """Iterates the Grain pipeline once and converts per-example dicts
    into columns through the shared row-wise machinery: union of keys
    over ALL rows, None/absent cells become missing (NaN / ""), scalar
    typing via dataset/example.py, and array-valued cells (item sets,
    vector sequences) via dataspec.column_array's object-array
    normalization — the same invariants every other ingestion path
    upholds."""
    from ydf_tpu_torch.dataset.dataspec import column_array
    from ydf_tpu_torch.dataset.example import examples_to_columns

    rows = list(iter(data))
    if not rows:
        raise ValueError("Empty Grain dataset")
    bad = next((r for r in rows if not isinstance(r, dict)), None)
    if bad is not None:
        raise ValueError(
            "Grain elements must be {column: value} dicts; got "
            f"{type(bad).__name__}"
        )
    keys: list = []
    seen = set()
    array_keys = set()
    for r in rows:
        for k, v in r.items():
            if k not in seen:
                seen.add(k)
                keys.append(k)
            if isinstance(v, (np.ndarray, list, tuple)) and not (
                isinstance(v, np.ndarray) and v.ndim == 0
            ):
                array_keys.add(k)
    scalar_rows = [
        {
            k: _scalarize(v)
            for k, v in r.items()
            if k not in array_keys and v is not None
        }
        for r in rows
    ]
    out: Dict[str, np.ndarray] = examples_to_columns(scalar_rows)
    for key in keys:
        if key in array_keys:
            out[key] = column_array([r.get(key) for r in rows])
    # Preserve the pipeline's column order.
    return {k: out[k] for k in keys if k in out}
