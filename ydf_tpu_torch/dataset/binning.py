"""Binner: per-feature binning rules, fit on the training rows (counterpart
of ydf_tpu/dataset/binning.py: boundaries_from_sketch, Binner.fit,
_fit_common, transform).

Numerical, boolean and DISCRETIZED_NUMERICAL columns: missing values
impute to the column mean; bin(v) = #{b : boundary_b <= v}, so
"bin <= t" is "v < boundary_t". A DISCRETIZED_NUMERICAL column's
boundaries are the dataspec's stored ones (cast to f32; two that round
to one f32 leave an empty bin between them, as in the JAX package), so
its cuts export as DiscretizedHigher conditions. Otherwise a column with
at most num_bins - 1 distinct values gets the midpoints between them as
boundaries (exact split search), and other columns deduplicated
quantiles of a fixed-seed 200k-row sample (`fit`) or of the streaming
dataset cache's merged summaries (`fit_from_summaries`). CATEGORICAL columns: bin =
dictionary index (0 = out of vocabulary); indices >= num_bins collapse
to 0, and the dictionary is frequency-sorted, so only the rarest
categories collapse. CATEGORICAL_SET columns are not binned either:
`transform_sets` packs each row's items as multi-hot u32 words, one
width (set_width_words) for every set feature, and a set feature's
feature_num_bins is its whole dictionary, not capped at num_bins.
NUMERICAL_VECTOR_SEQUENCE columns are not binned: the binner records
their names, vector lengths and longest sequence, and `transform_vs`
pads them densely.

Fitting runs on the host in numpy with the JAX package's expressions, so
boundaries are bitwise equal to its own. `transform` bins the numerical
columns on the device, through csrc/binning.cu on a card and through
its plain version on the CPU; categorical codes are looked up on the
host, as the JAX package does, and copied into their rows of the same
feature-major matrix.

Feature order is [numericals..., categoricals..., sets...]; vector
sequences are kept apart (vs_names).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ydf_tpu_torch.dataset.dataspec import ColumnType, DataSpecification
from ydf_tpu_torch.ops.binning import bin_columns

# Columns that bin, encode and serve as numerical features, their raw
# values (the JAX package's list; models/ydf_format.py maps an imported
# model's columns by it).
NUMERICAL_LIKE = (ColumnType.NUMERICAL, ColumnType.BOOLEAN,
                  ColumnType.DISCRETIZED_NUMERICAL)
# Rows above which boundaries come from a fixed-seed sample of this size.
SAMPLE_ROWS = 200_000
SAMPLE_SEED = 0xB1A5
# np.repeat-expansion ceiling of boundaries_from_sketch.
_QUANTILE_EXPAND_CAP = 1 << 21


def boundaries_from_sketch(values: np.ndarray, weights: np.ndarray,
                           num_bins: int,
                           distinct_is_exact: bool) -> np.ndarray:
    """Bin boundaries f32 from a weighted item set (ascending unique
    `values`, positive integer `weights`): the midpoints between the
    values when they are the exact distinct set and fit num_bins - 1
    boundaries; otherwise the deduplicated weighted quantiles of the
    multiset, numpy's "linear" method."""
    max_boundaries = num_bins - 1
    values = np.asarray(values)
    weights = np.asarray(weights, np.int64)
    if values.size == 0:
        return np.zeros((0,), np.float32)
    if distinct_is_exact and len(values) <= max_boundaries:
        return ((values[:-1] + values[1:]) / 2).astype(np.float32)
    total = int(weights.sum())
    qs_pos = np.linspace(0, 1, num_bins + 1)[1:-1]
    v64 = values.astype(np.float64)
    if total <= _QUANTILE_EXPAND_CAP:
        qs = np.quantile(np.repeat(v64, weights), qs_pos, method="linear")
    else:
        cw = np.cumsum(weights)
        h = qs_pos * (total - 1)
        lo = np.floor(h).astype(np.int64)
        g = h - lo
        hi = np.minimum(lo + 1, total - 1)
        a = v64[np.searchsorted(cw, lo, side="right")]
        b = v64[np.searchsorted(cw, hi, side="right")]
        qs = np.where(g < 0.5, a + (b - a) * g, b - (b - a) * (1 - g))
    return np.unique(qs).astype(np.float32)


@dataclasses.dataclass
class Binner:
    feature_names: List[str]
    num_numerical: int  # features [0, num_numerical) are numerical-like
    num_bins: int
    boundaries: np.ndarray       # f32 [F, num_bins-1], +inf padded
    impute_values: np.ndarray    # f32 [F]
    feature_num_bins: np.ndarray  # i32 [F]
    num_set: int = 0
    vs_names: List[str] = dataclasses.field(default_factory=list)
    vs_dims: List[int] = dataclasses.field(default_factory=list)
    vs_max_len: int = 0

    @property
    def num_vs(self) -> int:
        return len(self.vs_names)

    @property
    def vs_dim(self) -> int:
        """Common (max) vector length of the padded encoding."""
        return max(self.vs_dims, default=0)

    @property
    def num_features(self) -> int:
        return len(self.feature_names)

    @property
    def num_scalar(self) -> int:
        """Features carried by the scalar encoding (all but sets)."""
        return self.num_features - self.num_set

    @property
    def num_categorical(self) -> int:
        return self.num_features - self.num_numerical - self.num_set

    @property
    def set_width_words(self) -> int:
        """u32 words a set feature takes in the packed encoding."""
        if self.num_set == 0:
            return 0
        vmax = int(self.feature_num_bins[self.num_scalar:].max())
        return (vmax + 31) // 32

    @staticmethod
    def fit(dataset, features: Sequence[str],
            num_bins: int = 256) -> "Binner":
        """Fits the rules on `dataset` (a ydf_tpu_torch Dataset)."""
        max_boundaries = num_bins - 1
        # One fixed-seed row sample shared by every dense column.
        state: Dict[str, Optional[np.ndarray]] = {"sample_idx": None}

        def column_boundaries(name: str) -> np.ndarray:
            vals = dataset.encoded_numerical(name)
            if len(vals) > SAMPLE_ROWS:
                if state["sample_idx"] is None:
                    state["sample_idx"] = np.random.default_rng(
                        SAMPLE_SEED
                    ).choice(len(vals), SAMPLE_ROWS, replace=False)
                sample = vals[state["sample_idx"]]
            else:
                sample = vals
            # A small pre-sample screens cardinality; the full-column
            # unique sort runs only for a possibly low-cardinality column.
            presample = sample[: 4 * max_boundaries + 4]
            uniq = (np.unique(vals)
                    if len(np.unique(presample)) <= max_boundaries else None)
            if uniq is not None and len(uniq) <= max_boundaries:
                return boundaries_from_sketch(
                    uniq, np.ones(len(uniq), np.int64), num_bins,
                    distinct_is_exact=True,
                )
            su, sc = np.unique(sample, return_counts=True)
            return boundaries_from_sketch(su, sc, num_bins,
                                          distinct_is_exact=False)

        return Binner._fit_common(dataset.dataspec, features, num_bins,
                                  column_boundaries)

    @staticmethod
    def fit_from_summaries(spec: DataSpecification, features: Sequence[str],
                           num_bins: int, summaries: Dict) -> "Binner":
        """Fits the rules from the streaming cache's merged pass-1
        summaries (the JAX package's fit_from_summaries): `summaries`
        maps each numerical feature to a dataset.sketch.NumericSummary,
        whose weighted items give the boundaries."""

        def column_boundaries(name: str) -> np.ndarray:
            s = summaries[name]
            v, w = s.weighted_items()
            return boundaries_from_sketch(
                v, w, num_bins, distinct_is_exact=s.distinct_exact())

        return Binner._fit_common(spec, features, num_bins,
                                  column_boundaries)

    @staticmethod
    def _fit_common(spec: DataSpecification, features: Sequence[str],
                    num_bins: int,
                    column_boundaries: Callable[[str], np.ndarray]
                    ) -> "Binner":
        if not 2 <= num_bins <= 256:
            raise ValueError(
                f"num_bins must be in [2, 256] (uint8 bin matrix), got "
                f"{num_bins}"
            )
        if num_bins % 32 != 0:
            raise ValueError(
                f"num_bins must be a multiple of 32 (packed category "
                f"masks), got {num_bins}"
            )
        def of_type(*types):
            return [f for f in features
                    if spec.column_by_name(f).type in types]

        numericals = of_type(*NUMERICAL_LIKE)
        categoricals = of_type(ColumnType.CATEGORICAL)
        sets = of_type(ColumnType.CATEGORICAL_SET)
        vs = of_type(ColumnType.NUMERICAL_VECTOR_SEQUENCE)
        unsupported = [f for f in features
                       if f not in numericals + categoricals + sets + vs]
        if unsupported:
            raise NotImplementedError(
                f"Unsupported feature columns for binning: "
                f"{sorted(unsupported)}")
        ordered = numericals + categoricals + sets
        F = len(ordered)
        max_boundaries = num_bins - 1
        boundaries = np.full((F, max_boundaries), np.inf, dtype=np.float32)
        impute = np.zeros((F,), dtype=np.float32)
        fnb = np.ones((F,), dtype=np.int32)
        for i, name in enumerate(numericals):
            col = spec.column_by_name(name)
            if (col.type == ColumnType.DISCRETIZED_NUMERICAL
                    and col.discretized_boundaries is not None):
                b = np.asarray(col.discretized_boundaries, np.float32)
                if len(b) > max_boundaries:
                    # More stored boundaries than the bin budget: an even
                    # subsample keeps the value range covered.
                    idx = np.linspace(0, len(b) - 1, max_boundaries)
                    b = b[np.round(idx).astype(int)]
            else:
                b = column_boundaries(name)
            boundaries[i, : len(b)] = b
            impute[i] = np.float32(col.mean)
            fnb[i] = len(b) + 1
        for j, name in enumerate(categoricals):
            fnb[len(numericals) + j] = min(
                spec.column_by_name(name).vocab_size, num_bins)
        for j, name in enumerate(sets):
            # The whole dictionary: a node's set mask widens to it, only
            # the cut positions stop at num_bins.
            fnb[len(numericals) + len(categoricals) + j] = max(
                spec.column_by_name(name).vocab_size, 1)
        return Binner(
            feature_names=ordered, num_numerical=len(numericals),
            num_bins=num_bins, boundaries=boundaries, impute_values=impute,
            feature_num_bins=fnb, num_set=len(sets), vs_names=vs,
            vs_dims=[spec.column_by_name(f).vector_length for f in vs],
            vs_max_len=max(
                (max(spec.column_by_name(f).max_num_vectors, 1) for f in vs),
                default=0,
            ),
        )

    def transform(self, dataset, device) -> torch.Tensor:
        """The bin matrix u8 [n, F] on `device`, the [n, F] view of a
        contiguous feature-major [F, n] (`.t()` gives that back, the
        training layout): the numerical values f32 [Fn, n] are copied to
        the device once and binned by the binning kernel (ops/binning.py);
        the categorical codes are looked up on the host and fill the rows
        after them. Set features are packed apart (transform_sets)."""
        Fn, n = self.num_numerical, dataset.num_rows
        values = np.empty((Fn, n), np.float32)
        for i, name in enumerate(self.feature_names[:Fn]):
            values[i] = dataset.encoded_numerical(name, impute=False)
        bins = bin_columns(
            torch.from_numpy(values).to(device),
            torch.from_numpy(self.boundaries[:Fn]).to(device),
            torch.from_numpy(self.feature_num_bins[:Fn] - 1).to(device),
            torch.from_numpy(self.impute_values[:Fn]).to(device),
        )
        if self.num_categorical == 0:
            return bins
        codes = np.empty((self.num_categorical, n), np.uint8)
        for j, name in enumerate(self.feature_names[Fn:self.num_scalar]):
            idx = dataset.encoded_categorical(name)
            codes[j] = np.where(idx >= self.num_bins, 0, idx)
        return torch.cat([bins.t(), torch.from_numpy(codes).to(device)]).t()

    def transform_sets(self, dataset) -> Optional[np.ndarray]:
        """Packed multi-hot set features u32 [n, num_set, W] numpy, W =
        set_width_words (the JAX package's transform_sets), or None
        without set features; a column absent from `dataset` is all
        empty."""
        if self.num_set == 0:
            return None
        W = self.set_width_words
        out = np.zeros((dataset.num_rows, self.num_set, W), np.uint32)
        for j, name in enumerate(self.feature_names[self.num_scalar:]):
            if dataset.dataspec.has_column(name) and name in dataset.data:
                out[:, j, :] = dataset.encoded_categorical_set(name, W)
        return out

    def transform_vs(self, dataset):
        """Dense padded vector sequences, or None without VS features
        (counterpart of the JAX package's Binner.transform_vs): (values
        f32 [n, Fv, L, D], lengths i32 [n, Fv], missing bool [n, Fv])
        numpy, L the larger of the training-time longest sequence and
        this batch's, D the largest vector length. Missing cells encode
        as empty sequences; a column absent from `dataset` is missing."""
        if self.num_vs == 0:
            return None
        n = dataset.num_rows
        cells = {}
        batch_max = 0
        for name in self.vs_names:
            if dataset.dataspec.has_column(name) and name in dataset.data:
                cells[name] = dataset.vector_sequence_cells(name)
                batch_max = max([batch_max] + [
                    c.shape[0] for c in cells[name] if c is not None])
        L, D = max(self.vs_max_len, batch_max), self.vs_dim
        values = np.zeros((n, self.num_vs, L, D), np.float32)
        lengths = np.zeros((n, self.num_vs), np.int32)
        missing = np.zeros((n, self.num_vs), bool)
        for j, name in enumerate(self.vs_names):
            if name in cells:
                v, ln, m = dataset.encoded_vector_sequence(
                    name, max_len=L, dim=D, cells=cells[name])
                values[:, j], lengths[:, j], missing[:, j] = v, ln, m
            else:
                missing[:, j] = True
        return values, lengths, missing

    def to_json(self) -> Dict:
        return {
            "feature_names": self.feature_names,
            "num_numerical": self.num_numerical,
            "num_bins": self.num_bins,
            "boundaries": self.boundaries.tolist(),
            "impute_values": self.impute_values.tolist(),
            "feature_num_bins": self.feature_num_bins.tolist(),
            "num_set": self.num_set,
            "vs_names": self.vs_names,
            "vs_dims": self.vs_dims,
            "vs_max_len": self.vs_max_len,
        }

    @staticmethod
    def from_json(d: Dict) -> "Binner":
        """A Binner from its JSON form, the JAX package's
        `Binner.to_json()` included."""
        return Binner(
            feature_names=list(d["feature_names"]),
            num_numerical=int(d["num_numerical"]),
            num_bins=int(d["num_bins"]),
            boundaries=np.array(d["boundaries"], dtype=np.float32),
            impute_values=np.array(d["impute_values"], dtype=np.float32),
            feature_num_bins=np.array(d["feature_num_bins"], dtype=np.int32),
            num_set=int(d.get("num_set", 0)),
            vs_names=list(d.get("vs_names", [])),
            vs_dims=[int(x) for x in d.get("vs_dims", [])],
            vs_max_len=int(d.get("vs_max_len", 0)),
        )
