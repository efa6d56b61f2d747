"""Column schema ("dataspec"): what loading a model and encoding its
inputs need (counterpart of ydf_tpu/dataset/dataspec.py; inference waits
for the training slice).

Categorical dictionaries reserve index 0 for out-of-vocabulary items;
missing numericals are imputed with the column mean.
"""

from __future__ import annotations

import dataclasses
import enum
import math
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

    @staticmethod
    def from_json(d: Dict[str, Any]) -> "Column":
        d = dict(d)
        d["type"] = ColumnType(d["type"])
        return Column(**d)


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

    @staticmethod
    def from_json(d: Dict[str, Any]) -> "DataSpecification":
        return DataSpecification(
            columns=[Column.from_json(c) for c in d["columns"]],
            created_num_rows=d.get("created_num_rows", 0),
        )


MISSING_STRINGS = {"", "NA", "N/A", "nan", "NaN", "null", "None"}


def is_missing_item(v: Any) -> bool:
    """Is one raw categorical cell missing?"""
    if v is None or (isinstance(v, float) and math.isnan(v)):
        return True
    return isinstance(v, str) and v in MISSING_STRINGS


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
