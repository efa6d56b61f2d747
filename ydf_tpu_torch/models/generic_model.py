"""GenericModel: serving surface shared by the port's models
(counterpart of ydf_tpu/models/generic_model.py: _encode_inputs,
_raw_scores, _fast_engine, list_compatible_engines, force_engine,
evaluate and save).

Raw columns are encoded on the host in numpy, exactly as the JAX package
encodes them, then moved to the model's device; the engines take and
return tensors there. A model with NUMERICAL_VECTOR_SEQUENCE features is
served by the routed engine (ops/routing.py), which scores each tree's
anchors through csrc/vector_sequence.cu; the QuickScorer and bank
engines refuse it, as the JAX package's do. Telemetry spans are not ported (ROADMAP Queue 1
item 17).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ydf_tpu_torch.config import Task
from ydf_tpu_torch.dataset.binning import Binner
from ydf_tpu_torch.dataset.dataset import Dataset, InputData
from ydf_tpu_torch.dataset.dataspec import DataSpecification
from ydf_tpu_torch.metrics.metrics import Evaluation, evaluate_predictions
from ydf_tpu_torch.models.forest import Forest
from ydf_tpu_torch.ops.routing import forest_predict_values


class GenericModel:
    model_type = "GENERIC"

    def __init__(
        self,
        task: Task,
        label: Optional[str],
        classes: Optional[List[str]],
        dataspec: DataSpecification,
        binner: Binner,
        forest: Forest,
        max_depth: int,
        extra_metadata: Optional[Dict[str, Any]] = None,
        native_missing: bool = False,
    ):
        self.task = task
        self.label = label
        self.classes = classes
        self.dataspec = dataspec
        self.binner = binner
        self.forest = forest
        self.max_depth = max_depth
        self.extra_metadata = extra_metadata or {}
        # True: missing values reach routing as NaN / -1 and follow each
        # node's na_left direction (models imported from YDF format).
        # False: global imputation at encode time.
        self.native_missing = native_missing
        self._forced_engine: Optional[str] = None
        self._engine_cache: dict = {}

    @property
    def device(self) -> torch.device:
        return self.forest.device

    # ------------------------------------------------------------------ #
    # Serving
    # ------------------------------------------------------------------ #

    def _encode_inputs(self, ds: Dataset):
        """Raw features → (x_num f32 [n, Fn] imputed, x_cat i32 [n, Fc])
        numpy arrays. Vector sequences are encoded apart
        (Binner.transform_vs)."""
        b = self.binner
        if b.num_set > 0:
            raise NotImplementedError(
                "categorical-set features are not ported yet "
                "(ROADMAP Queue 1 item 9)"
            )
        n = ds.num_rows
        x_num = np.zeros((n, b.num_numerical), np.float32)
        x_cat = np.zeros((n, b.num_categorical), np.int32)
        for i, name in enumerate(b.feature_names[: b.num_scalar]):
            present = ds.dataspec.has_column(name) and name in ds.data
            if i < b.num_numerical:
                if present:
                    x_num[:, i] = ds.encoded_numerical(
                        name, impute=not self.native_missing
                    )
                else:
                    # Whole column absent = every value missing.
                    x_num[:, i] = (
                        np.nan if self.native_missing else b.impute_values[i]
                    )
            else:
                j = i - b.num_numerical
                if present:
                    idx = ds.encoded_categorical(
                        name, missing_code=-1 if self.native_missing else 0
                    )
                    x_cat[:, j] = np.where(idx >= b.num_bins, 0, idx)
                elif self.native_missing:
                    x_cat[:, j] = -1
        return x_num, x_cat

    def list_compatible_engines(self) -> List[str]:
        """Names of the compatible serving engines, highest rank first."""
        from ydf_tpu_torch.serving.registry import compatible_engines

        return [f.name for f in compatible_engines(self)]

    def force_engine(self, name: Optional[str]) -> None:
        """Pins predict() to one engine by name; None restores automatic
        (highest-ranked compatible) selection. Raises for unknown or
        incompatible names."""
        from ydf_tpu_torch.serving.registry import best_engine

        if name is not None:
            best_engine(self, forced=name)  # validates
        self._forced_engine = name

    def _fast_engine(self):
        """The selected engine for the CURRENT forest, or None when the
        generic routed engine is selected. Cached per (forced name,
        forest): multi-output predict swaps self.forest per dimension."""
        from ydf_tpu_torch.serving.registry import best_engine

        key = (self._forced_engine, id(self.forest.feature))
        hit = self._engine_cache.get(key)
        # Entries pin the keyed tensor (id() is unique only among live
        # objects) and are verified by identity before use.
        if hit is None or hit[0] is not self.forest.feature:
            if len(self._engine_cache) > 8:
                self._engine_cache.clear()
            factory = best_engine(self, forced=self._forced_engine)
            eng = None if factory.name == "Routed" else factory.build(self)
            self._engine_cache[key] = (self.forest.feature, eng)
        return self._engine_cache[key][1]

    def _raw_scores(self, data: InputData, combine: str) -> np.ndarray:
        """Raw (margin) scores f32 [n, V] as numpy."""
        ds = Dataset.from_data(data, dataspec=self.dataspec)
        x_num, x_cat = self._encode_inputs(ds)
        vs = self.binner.transform_vs(ds)
        dev = self.device
        xn = torch.from_numpy(x_num).to(dev)
        xc = torch.from_numpy(x_cat).to(dev)
        if combine == "sum" and not self.native_missing and vs is None:
            eng = self._fast_engine()
            if eng is not None:
                return eng(xn, xc).cpu().numpy()[:, None]
        vs_kwargs = {}
        if vs is not None:
            vs_kwargs = dict(
                x_vs_vals=torch.from_numpy(vs[0]).to(dev),
                x_vs_len=torch.from_numpy(vs[1]).to(dev),
                vs_missing=(torch.from_numpy(vs[2]).to(dev)
                            if self.native_missing else None),
            )
        out = forest_predict_values(
            self.forest, xn, xc,
            num_numerical=self.binner.num_numerical,
            max_depth=self.max_depth, combine=combine, **vs_kwargs,
        )
        return out.cpu().numpy()

    # ------------------------------------------------------------------ #
    # Evaluation and persistence
    # ------------------------------------------------------------------ #

    def evaluate(self, data: InputData, weights: Optional[str] = None,
                 confidence_intervals: bool = False,
                 num_bootstrap: int = 2000) -> Evaluation:
        """Metrics of predict(data) against the label column of `data`
        (classification and regression; metrics/metrics.py), each row
        weighted by the column `weights` when given."""
        if self.task not in (Task.CLASSIFICATION, Task.REGRESSION):
            raise NotImplementedError(
                f"evaluating a {self.task.value} model is not ported yet "
                "(ROADMAP Queue 1 items 11 and 20)"
            )
        ds = Dataset.from_data(data, dataspec=self.dataspec)
        preds = self.predict(ds)
        w = ds.data[weights].astype(np.float32) if weights else None
        return evaluate_predictions(
            self.task, ds.encoded_label(self.label, self.task), preds,
            classes=self.classes, weights=w,
            confidence_intervals=confidence_intervals,
            num_bootstrap=num_bootstrap,
        )

    def save(self, path: str) -> None:
        """Writes the JAX package's model directory (models/io.py)."""
        from ydf_tpu_torch.models.io import save_model

        save_model(self, path)

    def _metadata(self) -> Dict[str, Any]:
        """Subclass-specific JSON metadata."""
        return {}
