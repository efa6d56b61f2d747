"""Columnar in-memory dataset: name → 1-D numpy array + dataspec
(counterpart of ydf_tpu/dataset/dataset.py). Serving ingests a dict of
arrays or a pandas DataFrame against the model's dataspec and encodes it
with the same rules, so encodings equal the JAX package's bit for bit.
"""

from __future__ import annotations

from typing import Any, Dict, Union

import numpy as np

from ydf_tpu_torch.dataset.dataspec import (
    DataSpecification,
    column_array,
    is_missing_item,
)

InputData = Union["Dataset", Dict[str, Any], "pandas.DataFrame"]  # noqa: F821


class Dataset:
    """Columnar dataset: name → 1-D numpy array + dataspec."""

    def __init__(self, data: Dict[str, np.ndarray],
                 dataspec: DataSpecification):
        self.data = {k: np.asarray(v) for k, v in data.items()}
        self.dataspec = dataspec
        sizes = {len(v) for v in self.data.values()}
        if len(sizes) > 1:
            raise ValueError(f"Ragged columns: {sizes}")
        self.num_rows = sizes.pop() if sizes else 0

    @staticmethod
    def from_data(data: InputData,
                  dataspec: DataSpecification) -> "Dataset":
        """A dict of arrays/lists, a pandas DataFrame or a Dataset, keyed
        under `dataspec` (dataspec inference waits for the training
        slice)."""
        if isinstance(data, Dataset):
            return Dataset(data.data, dataspec)
        if isinstance(data, dict):
            cols = {k: column_array(v) for k, v in data.items()}
        elif hasattr(data, "to_dict") and hasattr(data, "columns"):
            cols = {c: data[c].to_numpy() for c in data.columns}
        else:
            raise TypeError(f"Unsupported dataset type: {type(data)}")
        return Dataset(cols, dataspec)

    def encoded_numerical(self, name: str, impute: bool = True) -> np.ndarray:
        """float32 values; missing → column-mean imputation, or kept as
        NaN when impute=False."""
        col = self.dataspec.column_by_name(name)
        raw = self.data[name]
        vals = raw if raw.dtype == np.float32 else raw.astype(np.float32)
        if impute and raw.dtype.kind not in "iub":  # ints/bools carry no NaN
            nan = np.isnan(vals)
            if nan.any():
                vals = np.where(nan, np.float32(col.mean), vals)
        return vals

    def encoded_categorical(self, name: str,
                            missing_code: int = 0) -> np.ndarray:
        """int32 dictionary indices; unknown → 0 (OOV), missing →
        `missing_code`."""
        col = self.dataspec.column_by_name(name)
        raw = self.data[name]
        if col.vocabulary is None:
            raise ValueError(f"Column {name!r} has no vocabulary")
        lookup = {item: i for i, item in enumerate(col.vocabulary)}
        if np.issubdtype(raw.dtype, np.number) and raw.dtype != np.bool_:
            # Numbers are keyed by their string form; the lookup runs over
            # the distinct values (np.unique collapses NaNs to one entry).
            fv = raw.astype(np.float64)
            uniq, inv = np.unique(fv, return_inverse=True)
            codes = np.array(
                [
                    missing_code
                    if np.isnan(v)
                    else lookup.get(
                        str(int(v)) if float(v).is_integer() else str(v), 0
                    )
                    for v in uniq.tolist()
                ],
                dtype=np.int32,
            )
            return codes[inv.reshape(fv.shape)]

        def code(v) -> int:
            if is_missing_item(v):
                return missing_code
            return lookup.get(str(v), 0)

        if raw.dtype.kind in "US":
            # Fixed-width strings hold no None/NaN: look up the distinct
            # values only.
            uniq, inv = np.unique(raw, return_inverse=True)
            codes = np.array([code(v) for v in uniq.tolist()], np.int32)
            return codes[inv.reshape(raw.shape)]
        return np.array([code(v) for v in raw.tolist()], dtype=np.int32)
