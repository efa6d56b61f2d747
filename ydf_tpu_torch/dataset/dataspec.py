"""Column schema ("dataspec") and its inference for numerical, boolean,
categorical, categorical-set, numerical-vector-sequence and hash columns
(counterpart of ydf_tpu/dataset/dataspec.py).

Categorical and categorical-set dictionaries reserve index 0 for
out-of-vocabulary items; missing numericals are imputed with the column
mean. A CATEGORICAL_SET cell is a list, tuple, set or array of items, or
a string split on " ;," (tokenize_set_value); None, NaN or a missing
string is missing, and an empty set is a value. A
NUMERICAL_VECTOR_SEQUENCE cell is a [num_vectors, dim] array (a list of
numeric vectors, or one vector); None or NaN is missing, and an empty
sequence is a value, distinct from missing. A HASH column (a ranking
task's query-group key by default) keeps no dictionary, only its value
and missing counts, and is never a feature.
"""

from __future__ import annotations

import dataclasses
import enum
import math
import re
from typing import Any, Dict, List, Optional

import numpy as np


class ColumnType(enum.Enum):
    """Semantic column types. Reference: ydf/dataset/data_spec.proto:61-85."""

    UNKNOWN = "UNKNOWN"
    NUMERICAL = "NUMERICAL"
    CATEGORICAL = "CATEGORICAL"
    BOOLEAN = "BOOLEAN"
    CATEGORICAL_SET = "CATEGORICAL_SET"
    DISCRETIZED_NUMERICAL = "DISCRETIZED_NUMERICAL"
    HASH = "HASH"
    NUMERICAL_VECTOR_SEQUENCE = "NUMERICAL_VECTOR_SEQUENCE"


@dataclasses.dataclass
class Column:
    """Schema + statistics of one column."""

    name: str
    type: ColumnType
    mean: float = 0.0  # also the global-imputation value for missing
    min_value: float = 0.0
    max_value: float = 0.0
    num_values: int = 0
    num_missing: int = 0
    # vocabulary[0] is the out-of-vocabulary item.
    vocabulary: Optional[List[str]] = None
    vocab_counts: Optional[List[int]] = None
    discretized_boundaries: Optional[List[float]] = None
    vector_length: int = 0
    min_num_vectors: int = 0
    max_num_vectors: int = 0

    @property
    def vocab_size(self) -> int:
        return len(self.vocabulary) if self.vocabulary is not None else 0

    @staticmethod
    def from_json(d: Dict[str, Any]) -> "Column":
        d = dict(d)
        d["type"] = ColumnType(d["type"])
        return Column(**d)

    def to_json(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["type"] = self.type.value
        return d


@dataclasses.dataclass
class DataSpecification:
    """Ordered set of columns. Reference: ydf/dataset/data_spec.proto:49."""

    columns: List[Column]
    created_num_rows: int = 0

    def column_by_name(self, name: str) -> Column:
        for c in self.columns:
            if c.name == name:
                return c
        raise KeyError(f"No column named {name!r} in dataspec")

    def has_column(self, name: str) -> bool:
        return any(c.name == name for c in self.columns)

    def to_json(self) -> Dict[str, Any]:
        return {
            "columns": [c.to_json() for c in self.columns],
            "created_num_rows": self.created_num_rows,
        }

    @staticmethod
    def from_json(d: Dict[str, Any]) -> "DataSpecification":
        return DataSpecification(
            columns=[Column.from_json(c) for c in d["columns"]],
            created_num_rows=d.get("created_num_rows", 0),
        )

    def __str__(self) -> str:
        """The column summary of `model.describe()`, the JAX package's
        text."""
        lines = [f"Number of columns: {len(self.columns)}", ""]
        by_type: Dict[str, List[str]] = {}
        for c in self.columns:
            by_type.setdefault(c.type.value, []).append(c.name)
        for t, names in sorted(by_type.items()):
            lines.append(f"{t}: {len(names)}")
        lines.append("")
        for i, c in enumerate(self.columns):
            extra = ""
            if c.type == ColumnType.NUMERICAL:
                extra = (f" mean:{c.mean:.6g} min:{c.min_value:.6g} "
                         f"max:{c.max_value:.6g}")
            elif c.type in (ColumnType.CATEGORICAL,
                            ColumnType.CATEGORICAL_SET):
                extra = f" vocab-size:{c.vocab_size}"
            elif c.type == ColumnType.DISCRETIZED_NUMERICAL:
                nb = len(c.discretized_boundaries or []) + 1
                extra = f" mean:{c.mean:.6g} bins:{nb}"
            if c.num_missing:
                extra += f" num-missing:{c.num_missing}"
            lines.append(f'  {i}: "{c.name}" {c.type.value}{extra}')
        return "\n".join(lines)


MISSING_STRINGS = {"", "NA", "N/A", "nan", "NaN", "null", "None"}
# Out-of-vocabulary item, vocabulary index 0.
OOV_ITEM = "<OOD>"


def is_missing_item(v: Any) -> bool:
    """Is one raw categorical cell missing?"""
    if v is None or (isinstance(v, float) and math.isnan(v)):
        return True
    return isinstance(v, str) and v in MISSING_STRINGS


def _is_numeric_dtype(arr: np.ndarray) -> bool:
    return np.issubdtype(arr.dtype, np.number) or arr.dtype == np.bool_


def infer_column(
    name: str,
    values: np.ndarray,
    max_vocab_count: int = 2000,
    min_vocab_frequency: int = 5,
    force_type: Optional[ColumnType] = None,
    discretized_max_bins: int = 255,
) -> Column:
    """One column's type and statistics (counterpart of
    ydf_tpu/dataset/dataspec.py:infer_column) for the types the port
    takes: NUMERICAL and BOOLEAN columns (mean, min, max, counts),
    DISCRETIZED_NUMERICAL ones (the same, and at most
    discretized_max_bins - 1 stored boundaries; only when forced),
    CATEGORICAL and CATEGORICAL_SET ones (frequency-sorted dictionary of
    values or items, OOV at index 0) and NUMERICAL_VECTOR_SEQUENCE ones
    (vector length, min and max sequence length, value and missing
    counts) and HASH ones (value and missing counts; only when forced).
    An object column of nested cells
    is a NUMERICAL_VECTOR_SEQUENCE when one of its first 100 cells is a
    sequence of numeric vectors, else a CATEGORICAL_SET. Other types
    raise NotImplementedError."""
    values = np.asarray(values)
    if values.ndim != 1:
        raise ValueError(
            f"Column {name!r} must be 1-D, got shape {values.shape}"
        )
    ctype = force_type
    if ctype is None:
        if values.dtype == np.bool_:
            ctype = ColumnType.BOOLEAN
        elif _is_numeric_dtype(values):
            ctype = ColumnType.NUMERICAL
        elif values.dtype == object and len(values) and any(
            isinstance(v, (list, tuple, np.ndarray, set, frozenset))
            for v in values[: min(len(values), 100)].tolist()
        ):
            # Nested sequences of numeric vectors: NUMERICAL_VECTOR_SEQUENCE;
            # flat item collections: CATEGORICAL_SET.
            ctype = ColumnType.CATEGORICAL_SET
            for v in values[: min(len(values), 100)].tolist():
                if _is_vector_sequence_cell(v):
                    ctype = ColumnType.NUMERICAL_VECTOR_SEQUENCE
                    break
        else:
            ctype = ColumnType.CATEGORICAL

    if ctype in (ColumnType.NUMERICAL, ColumnType.BOOLEAN,
                 ColumnType.DISCRETIZED_NUMERICAL):
        if values.dtype.kind in "iub":
            n_missing, ok = 0, values
        else:
            fvals = (values if values.dtype.kind == "f"
                     else values.astype(np.float64))
            missing = np.isnan(fvals)
            n_missing = int(missing.sum())
            ok = fvals if n_missing == 0 else fvals[~missing]
        if ok.size == 0:
            return Column(name=name, type=ctype, num_missing=n_missing)
        boundaries = None
        if ctype == ColumnType.DISCRETIZED_NUMERICAL:
            boundaries = discretized_boundaries(ok, discretized_max_bins)
        return Column(
            name=name, type=ctype,
            mean=float(ok.mean(dtype=np.float64)),
            min_value=float(ok.min()), max_value=float(ok.max()),
            num_values=int(ok.size), num_missing=n_missing,
            discretized_boundaries=boundaries,
        )

    if ctype == ColumnType.CATEGORICAL:
        if _is_numeric_dtype(values):
            fv = values.astype(np.float64)
            missing = np.isnan(fv)
            uniqf, counts = np.unique(fv[~missing], return_counts=True)
            uniq = np.array(
                [str(int(v)) if v.is_integer() else str(v)
                 for v in uniqf.tolist()],
                dtype=object,
            )
        else:
            missing = np.array([is_missing_item(v) for v in values.tolist()],
                               dtype=bool)
            uniq, counts = np.unique(values[~missing].astype(str),
                                     return_counts=True)
        # Decreasing frequency, lexicographic ties (the reference order).
        order = np.lexsort((uniq, -counts))
        uniq, counts = uniq[order], counts[order]
        keep = counts >= max(min_vocab_frequency, 1)
        kept, kept_counts = uniq[keep], counts[keep]
        if max_vocab_count > 0 and len(kept) > max_vocab_count:
            kept = kept[:max_vocab_count]
            kept_counts = kept_counts[:max_vocab_count]
        return Column(
            name=name, type=ctype,
            vocabulary=[OOV_ITEM] + [str(x) for x in kept],
            vocab_counts=[int(counts.sum() - kept_counts.sum())]
            + [int(c) for c in kept_counts],
            num_values=int(counts.sum()), num_missing=int(missing.sum()),
        )
    if ctype == ColumnType.HASH:
        # No dictionary and no statistics beyond counts: a HASH column
        # only keys groups (a ranking task's queries).
        if _is_numeric_dtype(values):
            missing = np.isnan(values.astype(np.float64))
        else:
            missing = np.array([is_missing_item(v) for v in values.tolist()],
                               dtype=bool)
        return Column(name=name, type=ctype,
                      num_values=int(len(values) - missing.sum()),
                      num_missing=int(missing.sum()))
    if ctype == ColumnType.NUMERICAL_VECTOR_SEQUENCE:
        vector_length = num_missing = count_values = max_nv = 0
        min_nv = None
        for v in values.tolist():
            seq = vector_sequence_cell(v)
            if seq is None:
                num_missing += 1
                continue
            if seq.size:
                if vector_length == 0:
                    vector_length = seq.shape[1]
                elif seq.shape[1] != vector_length:
                    raise ValueError(
                        f"Column {name!r}: inconsistent vector lengths "
                        f"{vector_length} vs {seq.shape[1]}"
                    )
            count_values += int(seq.size)
            min_nv = (seq.shape[0] if min_nv is None
                      else min(min_nv, seq.shape[0]))
            max_nv = max(max_nv, seq.shape[0])
        return Column(
            name=name, type=ctype, vector_length=vector_length,
            min_num_vectors=int(min_nv or 0), max_num_vectors=int(max_nv),
            num_values=count_values, num_missing=num_missing,
        )
    if ctype == ColumnType.CATEGORICAL_SET:
        # The dictionary counts item occurrences, with the categorical
        # rules: frequency order, lexicographic ties, OOV at index 0.
        tokens: List[str] = []
        num_missing = 0
        for v in values.tolist():
            items = tokenize_set_value(v)
            if items is None:
                num_missing += 1
            else:
                tokens.extend(items)
        if tokens:
            uniq, counts = np.unique(
                np.array(tokens, dtype=object).astype(str),
                return_counts=True)
            order = np.lexsort((uniq, -counts))
            uniq, counts = uniq[order], counts[order]
        else:
            uniq = np.array([], dtype=str)
            counts = np.array([], dtype=np.int64)
        keep = counts >= max(min_vocab_frequency, 1)
        kept, kept_counts = uniq[keep], counts[keep]
        if max_vocab_count > 0 and len(kept) > max_vocab_count:
            kept = kept[:max_vocab_count]
            kept_counts = kept_counts[:max_vocab_count]
        return Column(
            name=name, type=ctype,
            vocabulary=[OOV_ITEM] + [str(x) for x in kept],
            vocab_counts=[int(counts.sum() - kept_counts.sum())]
            + [int(c) for c in kept_counts],
            num_values=int(len(values) - num_missing),
            num_missing=num_missing,
        )
    raise NotImplementedError(f"Column type {ctype} not yet supported")


def discretized_boundaries(ok: np.ndarray, max_bins: int) -> List[float]:
    """The stored boundaries of a DISCRETIZED_NUMERICAL column (the JAX
    package's _discretized_boundaries), from its non-missing values: with
    at most max_bins distinct values the midpoints between them, else
    the deduplicated quantiles at max_bins - 1 evenly spaced levels
    (numpy's "linear" method), all in float64."""
    ok = np.asarray(ok, dtype=np.float64)
    uniq = np.unique(ok)
    if len(uniq) <= max_bins:
        b = (uniq[:-1] + uniq[1:]) / 2
    else:
        b = np.unique(np.quantile(
            ok, np.linspace(0, 1, max_bins + 1)[1:-1], method="linear"))
    return [float(v) for v in b]


def tokenize_set_value(v: Any) -> Optional[List[str]]:
    """One raw CATEGORICAL_SET cell -> its items as strings, None if
    missing (the JAX package's tokenize_set_value): a list, tuple, set
    or array gives its elements; a string is split on the reference's
    default separators " ;," (a missing string is missing); an empty set
    is a value."""
    if v is None or (isinstance(v, float) and math.isnan(v)):
        return None
    if isinstance(v, (list, tuple, set, frozenset)):
        return [str(x) for x in v]
    if isinstance(v, np.ndarray):
        return [str(x) for x in v.tolist()]
    if isinstance(v, str):
        if v in MISSING_STRINGS:
            return None
        return [t for t in re.split(r"[ ;,]", v) if t]
    return [str(v)]


def _is_vector_sequence_cell(v: Any) -> bool:
    """Is this raw cell a sequence of numeric vectors (not a flat item
    set)?"""
    if isinstance(v, np.ndarray):
        return v.ndim == 2
    if isinstance(v, (list, tuple)) and len(v):
        first = v[0]
        if isinstance(first, np.ndarray):
            return first.ndim == 1 and first.dtype.kind in "fiu"
        return isinstance(first, (list, tuple)) and len(first) > 0 and all(
            isinstance(x, (int, float, np.floating, np.integer))
            for x in first
        )
    return False


def vector_sequence_cell(v: Any) -> Optional[np.ndarray]:
    """One raw NUMERICAL_VECTOR_SEQUENCE cell -> float32 [L, D], None if
    missing. An empty sequence ([] or shape (0, D)) is a value; a single
    vector is a sequence of length 1."""
    if v is None or (isinstance(v, float) and math.isnan(v)):
        return None
    arr = np.asarray(v, dtype=np.float32)
    if arr.size == 0:
        return arr.reshape(0, arr.shape[1] if arr.ndim == 2 else 0)
    if arr.ndim == 1:
        arr = arr[None, :]
    if arr.ndim != 2:
        raise ValueError(
            f"Vector-sequence cell must be [num_vectors, dim], got shape "
            f"{arr.shape}"
        )
    return arr


def infer_dataspec(
    data: Dict[str, np.ndarray],
    label: Optional[str] = None,
    max_vocab_count: int = 2000,
    min_vocab_frequency: int = 5,
    column_types: Optional[Dict[str, ColumnType]] = None,
    detect_numerical_as_discretized: bool = False,
    discretized_max_bins: int = 255,
) -> DataSpecification:
    """The dataspec of a columnar mapping name -> 1-D array (counterpart
    of ydf_tpu/dataset/dataspec.py:infer_dataspec). The label keeps every
    class: no vocabulary cap and a minimum frequency of 1. With
    detect_numerical_as_discretized, every numerical column but the label
    and the user-typed ones is DISCRETIZED_NUMERICAL, with at most
    discretized_max_bins bins."""
    column_types = column_types or {}
    cols, n = [], 0
    for name, values in data.items():
        values = column_array(values)
        n = len(values)
        force = column_types.get(name)
        if name == label:
            cols.append(infer_column(name, values, max_vocab_count=-1,
                                     min_vocab_frequency=1,
                                     force_type=force))
        else:
            if (force is None and detect_numerical_as_discretized
                    and values.dtype != np.bool_
                    and _is_numeric_dtype(values)):
                force = ColumnType.DISCRETIZED_NUMERICAL
            cols.append(infer_column(
                name, values, max_vocab_count=max_vocab_count,
                min_vocab_frequency=min_vocab_frequency, force_type=force,
                discretized_max_bins=discretized_max_bins,
            ))
    return DataSpecification(columns=cols, created_num_rows=n)


def column_array(v: Any) -> np.ndarray:
    """One raw column → 1-D ndarray (ragged values become an object
    array)."""
    try:
        arr = np.asarray(v)
    except ValueError:
        arr = None
    if arr is not None and arr.ndim <= 1:
        return arr
    out = np.empty((len(v),), dtype=object)
    for i, x in enumerate(v):
        out[i] = x
    return out
