"""Shared train() plumbing (counterpart of ydf_tpu/learners/generic.py:
_infer_dataset, _select_feature_names, _prepare): dataset ingestion and
dataspec inference, feature selection, binning and label encoding.

Scope of the training slices: in-memory data (a dict of arrays, a pandas
DataFrame or a ydf_tpu_torch Dataset) and an optional validation set of
the same kinds, no dataset cache. The one learner, gradient boosted
trees, takes numerical, boolean, categorical and
NUMERICAL_VECTOR_SEQUENCE features.
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ydf_tpu_torch.config import Task, resolve_num_bins
from ydf_tpu_torch.dataset.binning import Binner
from ydf_tpu_torch.dataset.dataset import Dataset, InputData
from ydf_tpu_torch.dataset.dataspec import ColumnType
from ydf_tpu_torch.models.io import resolve_device

# Feature types the JAX package trains on (a column of one of these types
# that the port does not take raises in Binner.fit, never silently
# dropped).
JAX_FEATURE_TYPES = (
    ColumnType.NUMERICAL, ColumnType.CATEGORICAL, ColumnType.BOOLEAN,
    ColumnType.DISCRETIZED_NUMERICAL, ColumnType.CATEGORICAL_SET,
    ColumnType.NUMERICAL_VECTOR_SEQUENCE,
)


class GenericLearner:
    def __init__(
        self,
        label: Optional[str],
        task: Task,
        features: Optional[Sequence[str]] = None,
        weights: Optional[str] = None,
        max_vocab_count: int = 2000,
        min_vocab_frequency: int = 5,
        num_bins="auto",
        random_seed: int = 123456,
        column_types: Optional[Dict[str, ColumnType]] = None,
        device=None,
    ):
        self.label = label
        self.task = task
        self.features = list(features) if features is not None else None
        self.weights = weights
        self.max_vocab_count = max_vocab_count
        self.min_vocab_frequency = min_vocab_frequency
        self.num_bins = num_bins
        self.random_seed = random_seed
        self.column_types = dict(column_types) if column_types else {}
        self.device = resolve_device(device)
        #: Host-clock seconds of the last train()'s stages.
        self.last_timings: Dict[str, float] = {}

    def _infer_dataset(self, data: InputData) -> Dataset:
        """Dataset with this learner's type policy: classification labels
        are always dictionary-encoded, user column_types apply."""
        column_types = dict(self.column_types)
        if self.label is not None and self.task == Task.CLASSIFICATION:
            column_types[self.label] = ColumnType.CATEGORICAL
        return Dataset.from_data(
            data, label=self.label, max_vocab_count=self.max_vocab_count,
            min_vocab_frequency=self.min_vocab_frequency,
            column_types=column_types,
        )

    def _select_feature_names(self, ds: Dataset) -> list:
        """Explicit `features=` wins; otherwise every trainable column
        but the label and weights."""
        if self.features is not None:
            return list(self.features)
        exclude = {self.label, self.weights} - {None}
        return [c.name for c in ds.dataspec.columns
                if c.name not in exclude and c.type in JAX_FEATURE_TYPES]

    def _prepare(self, data: InputData,
                 valid: Optional[InputData] = None) -> Dict:
        """Dataset, fitted binner, feature-major bins u8 [F, n]
        ("bins_t") on the learner's device,
        the padded vector sequences (Binner.transform_vs, numpy; None
        without such features), encoded labels and weights (numpy).
        With `valid`, the same for it under the training dataspec and
        binner ("valid_dataset", "valid_bins_t", "valid_vs",
        "valid_labels", "valid_weights")."""
        t0 = time.perf_counter()
        ds = self._infer_dataset(data)
        features = self._select_feature_names(ds)
        # Auto-sized bins still hold every categorical dictionary
        # (indices >= num_bins collapse to out-of-vocabulary).
        max_vocab = max(
            (ds.dataspec.column_by_name(f).vocab_size for f in features
             if ds.dataspec.column_by_name(f).type
             == ColumnType.CATEGORICAL),
            default=0,
        )
        t1 = time.perf_counter()
        binner = Binner.fit(ds, features, num_bins=resolve_num_bins(
            self.num_bins, ds.num_rows, min_cat_vocab=max_vocab))
        t2 = time.perf_counter()
        bins_t = binner.transform(ds, self.device).t()  # no copy
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t3 = time.perf_counter()
        vs = binner.transform_vs(ds)
        t4 = time.perf_counter()
        out = {"dataset": ds, "binner": binner, "bins_t": bins_t,
               "vs": vs}
        out.update(self._encode_targets(ds))
        if self.task == Task.CLASSIFICATION and self.label is not None:
            out["classes"] = ds.label_classes(self.label)
        t5 = time.perf_counter()
        if valid is not None:
            vds = Dataset.from_data(valid, dataspec=ds.dataspec)
            out["valid_dataset"] = vds
            out["valid_bins_t"] = binner.transform(vds, self.device).t()
            out["valid_vs"] = binner.transform_vs(vds)
            out.update({f"valid_{k}": v
                        for k, v in self._encode_targets(vds).items()})
        self.last_timings = {
            "ingest_s": t1 - t0 + t5 - t4,
            "bin_fit_s": t2 - t1,
            "bin_transform_s": t3 - t2,
            "vs_encode_s": t4 - t3,
            "valid_encode_s": time.perf_counter() - t5,
        }
        return out

    def _encode_targets(self, ds: Dataset) -> Dict[str, np.ndarray]:
        """Encoded labels (when the learner has one) and sample weights
        (ones without a weights column), numpy."""
        out = {}
        if self.label is not None:
            out["labels"] = ds.encoded_label(self.label, self.task)
        out["sample_weights"] = (
            ds.data[self.weights].astype(np.float32)
            if self.weights is not None
            else np.ones((ds.num_rows,), np.float32)
        )
        return out
