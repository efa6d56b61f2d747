"""Columnar in-memory dataset: name → 1-D numpy array + dataspec
(counterpart of ydf_tpu/dataset/dataset.py). A dict of arrays, a pandas
or polars DataFrame, an xarray Dataset, a Grain loader or a typed path
("csv:/data/train-*.csv", the four "tfrecord…:" prefixes, "avro:") is
keyed under a model's dataspec (serving) or under the one inferred from
it (training), and encoded with the JAX package's rules, so encodings
equal its own bit for bit. CSV files go through the port's loader
(dataset/native_csv.py), whole, in sorted shard order.
"""

from __future__ import annotations

import glob
import os
import weakref
from typing import Any, Dict, List, Optional, Union

import numpy as np

from ydf_tpu_torch.config import Task
from ydf_tpu_torch.utils import telemetry
from ydf_tpu_torch.dataset.dataspec import (
    ColumnType,
    DataSpecification,
    column_array,
    infer_dataspec,
    is_missing_item,
    tokenize_set_value,
    vector_sequence_cell,
)

InputData = Union["Dataset", Dict[str, Any], str,
                  "pandas.DataFrame"]  # noqa: F821

# The reference's TFRecord format prefixes (formats.cc:56-81).
_TFRECORD_PREFIXES = ("tfrecord", "tfrecordv2+gz+tfe",
                      "tfrecord-nocompression", "tfrecordv2+tfe")


def _split_typed_path(path: str):
    """"prefix:path" -> (format, path); an untyped path is csv."""
    if ":" in path and not os.path.exists(path):
        prefix, _, rest = path.partition(":")
        if prefix == "csv":
            return "csv", rest
        if prefix in _TFRECORD_PREFIXES:
            return "tfrecord", rest
        if prefix == "avro":
            return "avro", rest
        raise ValueError(f"Unsupported dataset format prefix {prefix!r}")
    return "csv", path


def _resolve_typed_path(path: str) -> List[str]:
    """A typed, sharded or glob path ("csv:/p/a*.csv") -> its files,
    sorted."""
    _, path = _split_typed_path(path)
    files = sorted(glob.glob(path)) if any(c in path for c in "*?[") \
        else [path]
    if not files:
        raise FileNotFoundError(path)
    return files


def _read_csv(path: str) -> Dict[str, np.ndarray]:
    """One CSV file's columns through the port's loader: float64 with
    NaN missing, or object strings with "" missing. Raises where the
    loader does (no pandas fallback)."""
    from ydf_tpu_torch.dataset import native_csv

    return native_csv.read_csv(path)


def read_path_columns(path: str) -> Dict[str, np.ndarray]:
    """The columns of a typed path: every shard read and concatenated in
    sorted order."""
    fmt, raw_path = _split_typed_path(path)
    if fmt == "tfrecord":
        from ydf_tpu_torch.dataset.tfrecord import (
            read_tfrecord_columns, resolve_tfrecord_path)

        return read_tfrecord_columns(resolve_tfrecord_path(raw_path))
    if fmt == "avro":
        from ydf_tpu_torch.dataset.avro import read_avro_columns
        from ydf_tpu_torch.dataset.tfrecord import resolve_tfrecord_path

        return read_avro_columns(resolve_tfrecord_path(raw_path))
    parts = [_read_csv(f) for f in _resolve_typed_path(path)]
    return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}


# The learners' live bin matrices (device tensors) for the memory
# ledger's "bin_matrix" pull source, sampled only at ledger snapshots.
_LIVE_BIN_MATRICES: "weakref.WeakSet" = weakref.WeakSet()


def track_bin_matrix(bins):
    """Counts `bins` (a tensor) in the "bin_matrix" memory row while it
    lives; returns it."""
    _LIVE_BIN_MATRICES.add(bins)
    return bins


def bin_matrix_bytes_total() -> int:
    """The bytes of every live bin matrix."""
    return sum(int(b.numel()) * b.element_size()
               for b in list(_LIVE_BIN_MATRICES))


telemetry.register_mem_source("bin_matrix", bin_matrix_bytes_total)


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
    def from_examples(examples, dataspec: Optional[DataSpecification] = None,
                      **kwargs) -> "Dataset":
        """Row-wise ingestion: a sequence of {column: value} dicts
        (dataset/example.py); a column missing from a row is a missing
        cell."""
        from ydf_tpu_torch.dataset.example import examples_to_columns

        return Dataset.from_data(examples_to_columns(examples),
                                 dataspec=dataspec, **kwargs)

    @staticmethod
    def from_data(
        data: InputData,
        dataspec: Optional[DataSpecification] = None,
        label: Optional[str] = None,
        max_vocab_count: int = 2000,
        min_vocab_frequency: int = 5,
        column_types: Optional[Dict[str, ColumnType]] = None,
        detect_numerical_as_discretized: bool = False,
        discretized_max_bins: int = 255,
    ) -> "Dataset":
        """A dict of arrays/lists, a pandas or polars DataFrame, an
        xarray Dataset, a Grain loader, a typed path or a Dataset, keyed
        under `dataspec`, or under the dataspec inferred from the data
        when none is given (counterpart of the JAX package's
        Dataset.from_data). With detect_numerical_as_discretized, the
        inferred numerical features are DISCRETIZED_NUMERICAL with at
        most `discretized_max_bins` bins."""
        from ydf_tpu_torch.dataset import frame_io, grain_io

        if isinstance(data, Dataset):
            if dataspec is not None:
                return Dataset(data.data, dataspec)
            mismatched = [
                name for name, t in (column_types or {}).items()
                if data.dataspec.has_column(name)
                and data.dataspec.column_by_name(name).type != t
            ]
            if not mismatched:
                return data
            cols = dict(data.data)
        elif isinstance(data, str):
            cols = read_path_columns(data)
        elif frame_io.is_polars_frame(data):
            # Before the generic DataFrame branch: polars has .to_dict and
            # .columns too, but its Series differ in corners.
            cols = frame_io.polars_to_columns(data)
        elif isinstance(data, dict):
            cols = {k: column_array(v) for k, v in data.items()}
        elif hasattr(data, "to_dict") and hasattr(data, "columns"):
            cols = {c: data[c].to_numpy() for c in data.columns}
        elif grain_io.is_grain(data):
            cols = grain_io.to_columns(data)
        elif frame_io.is_xarray_dataset(data):
            cols = frame_io.xarray_to_columns(data)
        else:
            raise TypeError(f"Unsupported dataset type: {type(data)}")
        if dataspec is None:
            dataspec = infer_dataspec(
                cols, label=label, max_vocab_count=max_vocab_count,
                min_vocab_frequency=min_vocab_frequency,
                column_types=column_types,
                detect_numerical_as_discretized=(
                    detect_numerical_as_discretized),
                discretized_max_bins=discretized_max_bins,
            )
        return Dataset(cols, dataspec)

    def encoded_label(self, name: str, task: Task) -> np.ndarray:
        """Classification: int32 class index in [0, C), the dictionary
        order minus the OOV slot (class 0 is the most frequent).
        Regression: float32 values."""
        col = self.dataspec.column_by_name(name)
        if task == Task.CLASSIFICATION:
            if col.type != ColumnType.CATEGORICAL:
                raise ValueError(
                    f"Classification label {name!r} must be CATEGORICAL in "
                    f"the dataspec (got {col.type.value})"
                )
            idx = self.encoded_categorical(name)
            if (idx == 0).any():
                raise ValueError(
                    f"Label column {name!r} has values outside the training "
                    "dictionary (missing or unseen classes)"
                )
            return (idx - 1).astype(np.int32)
        return self.data[name].astype(np.float32)

    def label_classes(self, name: str) -> List[str]:
        col = self.dataspec.column_by_name(name)
        if col.type == ColumnType.CATEGORICAL:
            return col.vocabulary[1:]
        return [str(v) for v in np.unique(self.data[name]).tolist()]

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

    def encoded_categorical_set(self, name: str,
                                width_words: int) -> np.ndarray:
        """Packed multi-hot membership u32 [n, width_words] (the JAX
        package's encoded_categorical_set): bit v of row e is set when
        the row's set holds dictionary item v; unknown items and items
        past 32 * width_words set bit 0 (OOV); a missing cell encodes as
        the empty set (categorical_set_missing_mask tells them apart)."""
        col = self.dataspec.column_by_name(name)
        if col.vocabulary is None:
            raise ValueError(f"Column {name!r} has no vocabulary")
        n = len(self.data[name])
        rows: List[int] = []
        tokens: List[str] = []
        for e, v in enumerate(self.data[name].tolist()):
            items = tokenize_set_value(v)
            if items:
                rows.extend([e] * len(items))
                tokens.extend(items)
        out = np.zeros((n, width_words), np.uint32)
        if not tokens:
            return out
        vocab = np.asarray(col.vocabulary, dtype=object).astype(str)
        order = np.argsort(vocab)
        svocab = vocab[order]
        tok = np.asarray(tokens, dtype=object).astype(str)
        pos = np.minimum(np.searchsorted(svocab, tok), len(svocab) - 1)
        idx = np.where(svocab[pos] == tok, order[pos], 0)
        idx = np.where(idx >= width_words * 32, 0, idx)
        np.bitwise_or.at(
            out.reshape(-1),
            np.asarray(rows, np.int64) * width_words + (idx >> 5),
            np.uint32(1) << (idx & 31).astype(np.uint32),
        )
        return out

    def categorical_set_missing_mask(self, name: str) -> np.ndarray:
        """bool [n]: the set cell is missing (not merely empty)."""
        return np.array([tokenize_set_value(v) is None
                         for v in self.data[name].tolist()], dtype=bool)

    def vector_sequence_cells(self, name: str) -> List[Optional[np.ndarray]]:
        """The column's cells as float32 [L, D] arrays, None if missing."""
        return [vector_sequence_cell(v) for v in self.data[name].tolist()]

    def encoded_vector_sequence(
        self, name: str, max_len: int = 0, dim: int = 0,
        cells: Optional[List[Optional[np.ndarray]]] = None,
    ) -> tuple:
        """NUMERICAL_VECTOR_SEQUENCE cells -> (values f32 [n, Lmax, D]
        zero-padded, lengths i32 [n], missing bool [n]) (counterpart of
        the JAX package's Dataset.encoded_vector_sequence). Missing cells
        encode as empty with the missing flag set; sequences longer than
        `max_len`, when given, are truncated. `cells` reuses a
        vector_sequence_cells() result."""
        col = self.dataspec.column_by_name(name)
        D = dim or col.vector_length
        if cells is None:
            cells = self.vector_sequence_cells(name)
        n = len(cells)
        lengths = np.array(
            [0 if c is None else c.shape[0] for c in cells], np.int32
        )
        Lmax = max_len or max(int(lengths.max(initial=0)), 1)
        lengths = np.minimum(lengths, Lmax)
        values = np.zeros((n, Lmax, D), np.float32)
        for e, c in enumerate(cells):
            if c is not None and c.size:
                L = min(c.shape[0], Lmax)
                values[e, :L, : c.shape[1]] = c[:L, :D]
        missing = np.array([c is None for c in cells], bool)
        return values, lengths, missing
