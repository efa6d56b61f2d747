"""GenericModel: serving surface shared by the port's models
(counterpart of ydf_tpu/models/generic_model.py: _encode_inputs,
_raw_scores, _fast_engine, list_compatible_engines, force_engine,
evaluate and save).

Raw columns are encoded on the host in numpy, exactly as the JAX package
encodes them, then moved to the model's device; the engines take and
return tensors there. A model with NUMERICAL_VECTOR_SEQUENCE or
CATEGORICAL_SET features is served by the routed engine
(ops/routing.py), which scores each tree's anchors through
csrc/vector_sequence.cu and intersects the packed sets with the nodes'
masks; the QuickScorer and bank engines refuse such models, as the JAX
package's do. Telemetry spans are not ported (ROADMAP Queue 1 item 17).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ydf_tpu_torch.config import UPLIFT_TASKS, Task
from ydf_tpu_torch.dataset.binning import Binner
from ydf_tpu_torch.dataset.dataset import Dataset, InputData
from ydf_tpu_torch.dataset.dataspec import DataSpecification
from ydf_tpu_torch.metrics.metrics import Evaluation, evaluate_predictions
from ydf_tpu_torch.models.forest import Forest
from ydf_tpu_torch.ops.routing import forest_predict_values


class GenericModel:
    model_type = "GENERIC"
    #: How predict combines the trees' leaf values: "sum" (served by the
    #: bank and QuickScorer kernels too) or "mean" (the routed engine).
    combine = "sum"

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
        numpy arrays. Set features (_encode_sets) and vector sequences
        (Binner.transform_vs) are encoded apart."""
        b = self.binner
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

    def _encode_sets(self, ds: Dataset) -> Optional[np.ndarray]:
        """Packed set features u32 [n, Fs, W] numpy, W the forest's mask
        width (the JAX package's x_set of _encode_inputs), or None
        without set features."""
        b = self.binner
        if b.num_set == 0:
            return None
        W = int(self.forest.cat_mask.shape[-1])
        x_set = np.zeros((ds.num_rows, b.num_set, W), np.uint32)
        for j, name in enumerate(b.feature_names[b.num_scalar:]):
            if ds.dataspec.has_column(name) and name in ds.data:
                x_set[:, j, :] = ds.encoded_categorical_set(name, W)
        return x_set

    def _encode_set_missing(self, ds: Dataset) -> Optional[np.ndarray]:
        """bool [n, Fs]: missing set cells (an absent column is missing),
        or None without set features."""
        b = self.binner
        if b.num_set == 0:
            return None
        out = np.ones((ds.num_rows, b.num_set), bool)
        for j, name in enumerate(b.feature_names[b.num_scalar:]):
            if ds.dataspec.has_column(name) and name in ds.data:
                out[:, j] = ds.categorical_set_missing_mask(name)
        return out

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

    def _encode(self, data: InputData) -> Dict[str, torch.Tensor]:
        """The rows' features on the model's device: x_num f32 [n, Fn],
        x_cat i32 [n, Fc] and, with vector-sequence features, their
        values and lengths, with set features their packed rows x_set
        (and missing flags for a model that routes missing values
        natively); host encode, one copy."""
        ds = Dataset.from_data(data, dataspec=self.dataspec)
        x_num, x_cat = self._encode_inputs(ds)
        x_set = self._encode_sets(ds)
        vs = self.binner.transform_vs(ds)
        dev = self.device
        enc = {"x_num": torch.from_numpy(x_num).to(dev),
               "x_cat": torch.from_numpy(x_cat).to(dev)}
        if x_set is not None:
            enc["x_set"] = torch.from_numpy(x_set.view(np.int32)).to(dev)
            if self.native_missing:
                enc["set_missing"] = torch.from_numpy(
                    self._encode_set_missing(ds)).to(dev)
        if vs is not None:
            enc.update(x_vs_vals=torch.from_numpy(vs[0]).to(dev),
                       x_vs_len=torch.from_numpy(vs[1]).to(dev))
            if self.native_missing:
                enc["vs_missing"] = torch.from_numpy(vs[2]).to(dev)
        return enc

    def _scores(self, enc: Dict[str, torch.Tensor],
                combine: str) -> np.ndarray:
        """Raw (margin) scores f32 [n, V] as numpy, of the current forest
        on encoded rows (_encode)."""
        xn, xc = enc["x_num"], enc["x_cat"]
        vs = "x_vs_vals" in enc
        # Set models serve on the routed engine, as in the JAX package.
        if (combine == "sum" and not self.native_missing and not vs
                and "x_set" not in enc):
            eng = self._fast_engine()
            if eng is not None:
                return eng(xn, xc).cpu().numpy()[:, None]
        vs_kwargs = {}
        if vs:
            vs_kwargs = dict(
                x_vs_vals=enc["x_vs_vals"], x_vs_len=enc["x_vs_len"],
                vs_missing=enc.get("vs_missing"),
            )
        out = forest_predict_values(
            self.forest, xn, xc,
            num_numerical=self.binner.num_numerical,
            max_depth=self.max_depth, combine=combine,
            x_set=enc.get("x_set"), set_missing=enc.get("set_missing"),
            **vs_kwargs,
        )
        return out.cpu().numpy()

    def _raw_scores(self, data: InputData, combine: str) -> np.ndarray:
        """Raw (margin) scores f32 [n, V] as numpy."""
        return self._scores(self._encode(data), combine)

    # ------------------------------------------------------------------ #
    # Evaluation and persistence
    # ------------------------------------------------------------------ #

    def evaluate(self, data: InputData, weights: Optional[str] = None,
                 confidence_intervals: bool = False,
                 num_bootstrap: int = 2000) -> Evaluation:
        """Metrics of predict(data) against the label column of `data`
        (metrics/metrics.py), each row weighted by the column `weights`
        when given. Ranking reads the query groups and NDCG truncation,
        survival analysis the event column, the uplift tasks the
        treatment column, that `extra_metadata` names; rows with a
        missing or unseen treatment are left out."""
        ds = Dataset.from_data(data, dataspec=self.dataspec)
        preds = self.predict(ds)
        w = ds.data[weights].astype(np.float32) if weights else None
        if self.task in UPLIFT_TASKS:
            tcol = self.extra_metadata.get("uplift_treatment")
            if not tcol:
                raise ValueError(
                    "Uplift model lacks uplift_treatment metadata")
            tcodes = ds.encoded_categorical(tcol)
            keep = tcodes >= 1
            treatments = (tcodes[keep] == 2).astype(np.int64)
            if self.task == Task.CATEGORICAL_UPLIFT:
                labels = (ds.encoded_categorical(self.label)[keep]
                          == 2).astype(np.int64)
            else:
                labels = np.asarray(ds.data[self.label], np.float64)[keep]
            return evaluate_predictions(
                self.task, labels, np.asarray(preds)[keep],
                weights=None if w is None else w[keep],
                treatments=treatments)
        if self.task == Task.SURVIVAL_ANALYSIS:
            from ydf_tpu_torch.learners.gbt import bool_column

            ecol = self.extra_metadata.get("label_event_observed")
            if not ecol:
                raise ValueError(
                    "Survival model lacks label_event_observed metadata")
            return evaluate_predictions(
                self.task, np.asarray(ds.data[self.label], np.float64),
                preds, weights=w,
                events=bool_column(np.asarray(ds.data[ecol])))
        groups = None
        ndcg_truncation = 5
        if self.task == Task.RANKING:
            gcol = self.extra_metadata.get("ranking_group")
            groups = ds.data[gcol] if gcol else None
            ndcg_truncation = int(self.extra_metadata.get("ndcg_truncation",
                                                          5))
        return evaluate_predictions(
            self.task, ds.encoded_label(self.label, self.task), preds,
            classes=self.classes, weights=w, groups=groups,
            ndcg_truncation=ndcg_truncation,
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
