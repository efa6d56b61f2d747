"""Row-wise example path (the port's copy of ydf_tpu/dataset/example.py;
host numpy, no pandas).

Counterpart of the reference's `dataset/example.proto` +
`example_builder.cc` (a single `proto::Example` per row, used by the
single-example serving paths and the example reader/writer interfaces).
The package is columnar end-to-end, so the row-wise path is a thin,
well-defined conversion layer:

* an Example is a plain `{column_name: value}` dict (missing column =
  missing value, like unset proto fields);
* `examples_to_columns` / `columns_to_examples` convert to/from the
  columnar Dataset layout (missing numericals → NaN, missing
  categoricals → "");
* `Dataset.from_examples` ingests a list of rows against a dataspec;
* `GenericModel.predict_example` scores ONE row (the reference's
  `AbstractModel::Predict(example, &prediction)` single-example
  overload, abstract_model.h:500-516).
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence

import numpy as np

Example = Dict[str, Any]


def examples_to_columns(
    examples: Sequence[Example],
) -> Dict[str, np.ndarray]:
    """Rows → columns. Column set = union over rows; a row missing a
    column contributes a missing cell (NaN for numeric columns, "" for
    string columns — the Dataset encoders' missing conventions)."""
    if not examples:
        return {}
    names: List[str] = []
    seen = set()
    for ex in examples:
        for k in ex:
            if k not in seen:
                seen.add(k)
                names.append(k)
    out: Dict[str, np.ndarray] = {}
    n = len(examples)
    for name in names:
        vals = [ex.get(name) for ex in examples]
        present = [v for v in vals if v is not None]
        numeric = all(
            isinstance(v, (int, float, np.integer, np.floating))
            and not isinstance(v, bool)
            for v in present
        ) and present
        if numeric:
            col = np.full((n,), np.nan, np.float64)
            for i, v in enumerate(vals):
                if v is not None:
                    col[i] = float(v)
            out[name] = col
        else:
            col = np.array(
                ["" if v is None else str(v) for v in vals], object
            )
            out[name] = col
    return out


def columns_to_examples(columns: Dict[str, Any]) -> List[Example]:
    """Columns → rows; missing cells (NaN / "") are dropped from the row
    dict, matching unset proto fields."""
    names = list(columns)
    if not names:
        return []
    arrays = {k: np.asarray(v) for k, v in columns.items()}
    n = len(next(iter(arrays.values())))
    out: List[Example] = []
    for i in range(n):
        row: Example = {}
        for k in names:
            v = arrays[k][i]
            if isinstance(v, (float, np.floating)) and np.isnan(v):
                continue
            if isinstance(v, (str, np.str_)) and v == "":
                continue
            row[k] = v.item() if isinstance(v, np.generic) else v
        out.append(row)
    return out
