"""Shared train() plumbing (counterpart of ydf_tpu/learners/generic.py:
_infer_dataset, _select_feature_names, _prepare): dataset ingestion and
dataspec inference, feature selection, binning and label encoding.

The training data is anything Dataset.from_data takes (a dict of
arrays, a DataFrame, a typed path such as "csv:/data/train-*.csv", ...)
or an on-disk DatasetCache (dataset/cache.py: its memmapped bins go to
the device once, feature-major); the optional validation set is
in-memory data or a path. The learners take numerical, boolean,
discretized-numerical, categorical and categorical-set features (the
isolation forest no sets), gradient boosted trees also
NUMERICAL_VECTOR_SEQUENCE ones; discretize_numerical_columns=True makes
the inferred numerical features DISCRETIZED_NUMERICAL, binned on their
stored boundaries. A learner that splits its input before training
(CART's holdout) pins the full data's dataspec in `_forced_dataspec`; an
unsupervised one (the isolation forest) has no label.
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ydf_tpu_torch.config import Task, resolve_num_bins
from ydf_tpu_torch.dataset.binning import Binner
from ydf_tpu_torch.dataset.dataset import (
    Dataset, InputData, track_bin_matrix)
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


def unported(what: str, item) -> NotImplementedError:
    """The error of a feature of the JAX package the port lacks."""
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP Queue 1 item {item})"
    )


class GenericLearner:
    #: Column types a learner trains on when `features=` is not given.
    _feature_types = JAX_FEATURE_TYPES
    #: A dataspec to key the training data under instead of inferring
    #: one (set by a learner around an internal split; None infers).
    _forced_dataspec = None

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
        discretize_numerical_columns: bool = False,
        num_discretized_numerical_bins: int = 255,
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
        self.discretize_numerical_columns = discretize_numerical_columns
        self.num_discretized_numerical_bins = num_discretized_numerical_bins
        self.device = resolve_device(device)
        #: Host-clock seconds of the last train()'s stages.
        self.last_timings: Dict[str, float] = {}

    # ---- the reference PYDF learner's accessors ---------------------- #

    def learner_name(self) -> str:
        """e.g. "GradientBoostedTreesLearner"."""
        return type(self).__name__

    @classmethod
    def hyperparameter_spec(cls):
        """{name: HyperParameter} of every constructor parameter
        (learners/hyperparameters.py)."""
        from ydf_tpu_torch.learners.hyperparameters import (
            hyperparameter_spec,
        )

        return hyperparameter_spec(cls)

    def hyperparameters(self) -> Dict[str, object]:
        """The current values of the spec's parameters, by name."""
        return {name: getattr(self, name)
                for name in type(self).hyperparameter_spec()
                if hasattr(self, name)}

    def validate_hyperparameters(self) -> None:
        """Checks the current values against the spec: catches an invalid
        value set after construction."""
        from ydf_tpu_torch.learners.hyperparameters import check_value

        spec = type(self).hyperparameter_spec()
        for name, value in self.hyperparameters().items():
            check_value(spec[name], value, type(self).__name__)

    def extract_input_feature_names(self, data: InputData) -> list:
        """The feature columns this learner would train on for `data`:
        dataspec inference and the label / weights / group / treatment
        exclusions, no binning."""
        return self._select_feature_names(self._infer_dataset(data))

    def _infer_dataset(self, data: InputData) -> Dataset:
        """Dataset with this learner's type policy: classification and
        categorical-uplift labels and an uplift treatment column are
        always dictionary-encoded, a ranking group column is HASH unless
        the user types it, user column_types apply; keyed under
        `_forced_dataspec` when it is set."""
        column_types = dict(self.column_types)
        group_col = getattr(self, "ranking_group", None)
        if group_col:
            column_types.setdefault(group_col, ColumnType.HASH)
        treat_col = getattr(self, "uplift_treatment", None)
        if treat_col:
            # Code 1 is the most frequent value (control), code 2 the
            # treated one.
            column_types[treat_col] = ColumnType.CATEGORICAL
        if self.label is not None and self.task in (
                Task.CLASSIFICATION, Task.CATEGORICAL_UPLIFT):
            column_types[self.label] = ColumnType.CATEGORICAL
        return Dataset.from_data(
            data, label=self.label, dataspec=self._forced_dataspec,
            max_vocab_count=self.max_vocab_count,
            min_vocab_frequency=self.min_vocab_frequency,
            column_types=column_types,
            detect_numerical_as_discretized=self.discretize_numerical_columns,
            discretized_max_bins=self.num_discretized_numerical_bins,
        )

    def _select_feature_names(self, ds: Dataset) -> list:
        """Explicit `features=` wins; otherwise every column of one of
        the learner's `_feature_types` but the label, the weights and a
        task's group, treatment, event and entry-age columns."""
        if self.features is not None:
            return list(self.features)
        exclude = {
            self.label, self.weights,
            getattr(self, "ranking_group", None),
            getattr(self, "uplift_treatment", None),
            getattr(self, "label_event_observed", None),
            getattr(self, "label_entry_age", None),
        } - {None}
        return [c.name for c in ds.dataspec.columns
                if c.name not in exclude and c.type in self._feature_types]

    def _prepare(self, data: InputData,
                 valid: Optional[InputData] = None,
                 bins: bool = True) -> Dict:
        """Dataset, fitted binner, feature-major bins u8 [F, n]
        ("bins_t") on the learner's device, the packed set features
        ("set_bits": u32 bit patterns as i32 [n, Fs, W] on the device,
        None without set features; Binner.transform_sets),
        the padded vector sequences (Binner.transform_vs, numpy; None
        without such features), encoded labels and weights (numpy).
        With `valid`, the same for it under the training dataspec and
        binner ("valid_dataset", "valid_bins_t", "valid_vs",
        "valid_labels", "valid_weights"). A DatasetCache goes through
        _prepare_from_cache (bins=False leaves its bins on the disk)."""
        from ydf_tpu_torch.dataset.cache import DatasetCache

        if isinstance(data, DatasetCache):
            return self._prepare_from_cache(data, valid, bins)
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
        bins_t = track_bin_matrix(
            binner.transform(ds, self.device).t())  # no copy
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t3 = time.perf_counter()
        vs = binner.transform_vs(ds)
        t4 = time.perf_counter()
        out = {"dataset": ds, "binner": binner, "bins_t": bins_t,
               "vs": vs, "set_bits": self._set_bits(binner, ds)}
        out.update(self._encode_targets(ds))
        if self.label is not None and self._label_task() == \
                Task.CLASSIFICATION:
            out["classes"] = ds.label_classes(self.label)
        t5 = time.perf_counter()
        if valid is not None:
            vds = Dataset.from_data(valid, dataspec=ds.dataspec)
            out["valid_dataset"] = vds
            out["valid_bins_t"] = binner.transform(vds, self.device).t()
            out["valid_vs"] = binner.transform_vs(vds)
            out["valid_set_bits"] = self._set_bits(binner, vds)
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

    def _prepare_from_cache(self, cache, valid: Optional[InputData] = None,
                            bins: bool = True) -> Dict:
        """_prepare's result for an on-disk DatasetCache (the JAX
        package's _prepare_from_cache): its binner and dataspec, the
        memmapped u8 bins copied to the device once and made
        feature-major there (with bins=False, "bins_t" is None and the
        bins stay on the disk: distributed training's workers read
        them), the stored labels and weights, a Dataset of the label and
        the stored task columns, the cache itself ("cache"), and the
        stored raw numericals ("raw_numerical", numpy) for oblique
        splits. The cache must have been built for the learner's label,
        weights and task columns."""
        t0 = time.perf_counter()
        if self.label != cache.label:
            raise ValueError(
                f"Cache was built for label {cache.label!r}, learner wants "
                f"{self.label!r}")
        if cache.weights != self.weights:
            # Either way round the training rows and an explicit valid=
            # set would be weighted inconsistently.
            raise ValueError(
                f"Learner weights column {self.weights!r} does not match "
                f"the cache's stored weights ({cache.weights!r}); recreate "
                f"the cache with weights={self.weights!r} or construct the "
                f"learner with weights={cache.weights!r}")

        def need(col_attr: str) -> None:
            col = getattr(self, col_attr, None)
            if col and col not in cache.extra_columns:
                raise ValueError(
                    f"task {self.task} needs column {col!r} stored in the "
                    f"cache; recreate it with create_dataset_cache(..., "
                    f"{col_attr}={col!r})")

        if self.task == Task.RANKING:
            need("ranking_group")
        elif self.task == Task.SURVIVAL_ANALYSIS:
            need("label_event_observed")
            need("label_entry_age")
        elif self.task in (Task.CATEGORICAL_UPLIFT, Task.NUMERICAL_UPLIFT):
            need("uplift_treatment")
        raw = None
        if getattr(self, "split_axis", "AXIS_ALIGNED") != "AXIS_ALIGNED":
            raw = cache.raw_numerical
            if raw is None and cache.binner.num_numerical > 0:
                raise ValueError(
                    "SPARSE_OBLIQUE needs raw feature values; recreate the "
                    "cache with store_raw_numerical=True")
            raw = None if raw is None else np.asarray(raw, np.float32)
        labels = np.array(cache.labels)  # off the memmap, writable
        data = {cache.label: labels}
        for col in cache.extra_columns:
            data[col] = cache.extra_column(col)
        w = cache.sample_weights
        t1 = time.perf_counter()
        bins_t = None
        if bins:
            bins_t = track_bin_matrix(torch.from_numpy(np.array(
                cache.bins)).to(self.device).t().contiguous())
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        t2 = time.perf_counter()
        out = {
            "cache": cache, "dataset": Dataset(data, cache.dataspec),
            "binner": cache.binner, "bins_t": bins_t, "vs": None,
            "set_bits": None, "raw_numerical": raw, "labels": labels,
            "sample_weights": (np.array(w, np.float32) if w is not None
                               else np.ones((cache.num_rows,), np.float32)),
        }
        if self.task in (Task.CLASSIFICATION, Task.CATEGORICAL_UPLIFT):
            classes = cache.label_classes()
            if classes is None:
                raise ValueError(
                    "Cache label is numerical; train with a regression task")
            out["classes"] = classes
        t3 = time.perf_counter()
        if valid is not None:
            vds = Dataset.from_data(valid, dataspec=cache.dataspec)
            out["valid_dataset"] = vds
            out["valid_bins_t"] = cache.binner.transform(vds,
                                                         self.device).t()
            out["valid_vs"] = out["valid_set_bits"] = None
            out.update({f"valid_{k}": v
                        for k, v in self._encode_targets(vds).items()})
        self.last_timings = {
            "ingest_s": t1 - t0,
            "bins_to_device_s": t2 - t1,
            "valid_encode_s": time.perf_counter() - t3,
        }
        return out

    def raw_numerical(self, prep: Dict, which: str = "") -> np.ndarray:
        """The imputed numerical features f32 [n, Fn] of the training rows
        (which="") or of the validation rows (which="valid_"): a cache's
        stored matrix, else encoded from the dataset."""
        from ydf_tpu_torch.ops import oblique

        if not which and prep.get("raw_numerical") is not None:
            return prep["raw_numerical"]
        return oblique.raw_numerical(prep[f"{which}dataset"], prep["binner"])

    def _set_bits(self, binner: Binner, ds: Dataset
                  ) -> Optional[torch.Tensor]:
        """binner.transform_sets(ds) on the learner's device, the u32
        words as i32 bit patterns (one copy), or None."""
        sets = binner.transform_sets(ds)
        if sets is None:
            return None
        return torch.from_numpy(sets.view(np.int32)).to(self.device)

    def _need(self, col_attr: str, ds: Dataset) -> None:
        """The task's column named by `col_attr` must be in the data
        (the JAX package's _need, which checks a dataset cache's stored
        columns)."""
        col = getattr(self, col_attr, None)
        if col and col not in ds.data:
            raise ValueError(
                f"task {self.task} needs column {col!r} in the data "
                f"({col_attr}={col!r})")

    def _label_task(self) -> Task:
        """How the label is encoded: a CATEGORICAL_UPLIFT outcome as a
        classification label, a NUMERICAL_UPLIFT one as a regression
        value."""
        return {Task.CATEGORICAL_UPLIFT: Task.CLASSIFICATION,
                Task.NUMERICAL_UPLIFT: Task.REGRESSION}.get(self.task,
                                                            self.task)

    def _encode_targets(self, ds: Dataset) -> Dict[str, np.ndarray]:
        """Encoded labels (when the learner has one: class indices, or
        f32 values for regression, ranking relevance, survival departure
        ages and numerical uplift outcomes) and sample weights (ones
        without a weights column), numpy."""
        out = {}
        if self.label is not None:
            out["labels"] = ds.encoded_label(self.label, self._label_task())
        out["sample_weights"] = (
            ds.data[self.weights].astype(np.float32)
            if self.weights is not None
            else np.ones((ds.num_rows,), np.float32)
        )
        return out
