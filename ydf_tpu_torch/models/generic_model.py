"""GenericModel: the surface shared by the port's models (counterpart
of ydf_tpu/models/generic_model.py: serving, introspection, describe,
predict_leaves / distance, predict_class / predict_example,
self_evaluation, benchmark, evaluate, save / save_ydf / serialize,
predict_tf_examples). Every data argument takes what Dataset.from_data
takes, typed paths ("csv:", "tfrecord:", "avro:") included.

Raw columns are encoded on the host in numpy, exactly as the JAX package
encodes them, then moved to the model's device; the engines take and
return tensors there. A model with NUMERICAL_VECTOR_SEQUENCE or
CATEGORICAL_SET features is served by the routed engine
(ops/routing.py), which scores each tree's anchors through
csrc/vector_sequence.cu and intersects the packed sets with the nodes'
masks; the QuickScorer and bank engines refuse such models, as the JAX
package's do, and so do they a model that routes missing values
natively (one imported from the YDF format). Serving records telemetry
spans and latency histograms (utils/telemetry.py) in _raw_scores. Not
ported: the tree accessors, the variable importances but the structure
ones, the html model card and the exports to other frameworks (items 20
and 21).
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ydf_tpu_torch.config import UPLIFT_TASKS, Task
from ydf_tpu_torch.dataset.binning import Binner
from ydf_tpu_torch.dataset.dataset import Dataset, InputData
from ydf_tpu_torch.dataset.dataspec import DataSpecification
from ydf_tpu_torch.metrics.metrics import Evaluation, evaluate_predictions
from ydf_tpu_torch.models.forest import Forest
from ydf_tpu_torch.ops.routing import (
    forest_leaves,
    forest_predict_values,
    leaf_proximity,
)
from ydf_tpu_torch.utils import telemetry


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
    # Introspection (the reference PYDF model's accessors)
    # ------------------------------------------------------------------ #

    def input_feature_names(self) -> List[str]:
        return list(self.binner.feature_names)

    def num_trees(self) -> int:
        return int(self.forest.num_trees)

    def num_nodes(self) -> int:
        return int(self.forest.num_nodes.sum())

    def name(self) -> str:
        """Model type name, e.g. "RANDOM_FOREST"."""
        return self.model_type

    def data_spec(self) -> DataSpecification:
        return self.dataspec

    def label_classes(self) -> List[str]:
        """The classification label's dictionary."""
        if not self.classes:
            raise ValueError(
                "label_classes is only defined for classification models")
        return list(self.classes)

    def _column_indices(self) -> Dict[str, int]:
        return {c.name: i for i, c in enumerate(self.dataspec.columns)}

    def label_col_idx(self) -> int:
        return self._column_indices().get(self.label, -1)

    def input_features_col_idxs(self) -> List[int]:
        return [f[2] for f in self.input_features()]

    def input_features(self) -> List[tuple]:
        """[(name, column type, column index)] of the input features."""
        by_name = self._column_indices()
        cols = self.dataspec.columns
        return [(n, cols[by_name[n]].type.value, by_name[n])
                for n in self.input_feature_names()]

    def describe(self, output_format: str = "text") -> str:
        """Model card, the JAX package's text line for line: structure
        statistics, input features with their types, structure variable
        importances, training logs and self-evaluation when present, the
        dataspec. The html form is not ported (ROADMAP Queue 1 item
        20)."""
        if output_format != "text":
            raise NotImplementedError(
                f"describe(output_format={output_format!r}): only the text "
                "form is ported (ROADMAP Queue 1 item 20)")
        from ydf_tpu_torch.analysis.importance import structure_importances

        f = self.forest.to_numpy()
        nn = f["num_nodes"]
        leaf_counts = [int(f["is_leaf"][t, : nn[t]].sum())
                       for t in range(len(nn))]
        feats = self.input_feature_names()
        lines = [
            f'Type: "{self.model_type}"',
            f"Task: {self.task.value}",
            f'Label: "{self.label}"',
        ]
        if self.classes:
            lines.append(f"Classes: {self.classes}")
        lines += ["", f"Input features ({len(feats)}):"]
        for name in feats:
            col = self.dataspec.column_by_name(name)
            extra = (f" vocab={col.vocab_size}" if col.vocabulary is not None
                     else f" mean={col.mean:.4g}")
            lines.append(f"  {name}: {col.type.value}{extra}")
        for name in self.binner.vs_names:
            col = self.dataspec.column_by_name(name)
            lines.append(f"  {name}: {col.type.value} dim={col.vector_length}")
        lines += [
            "",
            f"Number of trees: {self.num_trees()}",
            f"Total number of nodes: {self.num_nodes()}",
            f"Number of leaves: {sum(leaf_counts)}",
            (f"Nodes per tree: min {int(nn.min())} / mean "
             f"{float(nn.mean()):.1f} / max {int(nn.max())}")
            if len(nn) else "",
            f"Maximum depth: {self.max_depth}",
        ]
        si = structure_importances(self)
        top = si.get("NUM_NODES") or next(iter(si.values()), [])
        if top:
            lines += ["", "Variable importances (NUM_NODES):"]
            for d in top[:10]:
                lines.append(f"  {d['feature']:>25}: {d['importance']:.5g}")
        logs = getattr(self, "training_logs", None)
        if logs and logs.get("train_loss"):
            tl = logs["train_loss"]
            lines += [
                "",
                f"Training: {len(tl)} iterations, final train loss "
                f"{tl[-1]:.5f}"
                + (f", final valid loss {logs['valid_loss'][-1]:.5f}"
                   if logs.get("valid_loss") else ""),
            ]
        oob = getattr(self, "oob_evaluation", None)
        if oob:
            m = ", ".join(f"{k}={v:.4f}"
                          for k, v in list(oob["metrics"].items())[:4])
            lines += ["", f"Self-evaluation (OOB): {m}"]
        lines += ["", "Dataspec:", str(self.dataspec)]
        return "\n".join(lines)

    def self_evaluation(self):
        """The training run's own evaluation: a random forest's
        out-of-bag one, a GBT's last kept validation loss (its logs keep
        the kept iterations only), else None."""
        oob = getattr(self, "oob_evaluation", None)
        if oob is not None:
            return oob
        logs = getattr(self, "training_logs", None)
        if logs and logs.get("valid_loss") is not None:
            vl = np.asarray(logs["valid_loss"])
            if vl.size:
                return {"source": "gbt_validation",
                        "metrics": {"loss": float(vl[-1])}}
        return None

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
        return self._serve(enc, combine)[0]

    def _serve(self, enc: Dict[str, torch.Tensor], combine: str):
        """(_scores, the name of the engine that computed them)."""
        xn, xc = enc["x_num"], enc["x_cat"]
        vs = "x_vs_vals" in enc
        # Set models serve on the routed engine, as in the JAX package.
        if (combine == "sum" and not self.native_missing and not vs
                and "x_set" not in enc):
            eng = self._fast_engine()
            if eng is not None:
                name = type(eng).__name__
                if not telemetry.ENABLED:
                    return eng(xn, xc).cpu().numpy()[:, None], name
                t0 = time.perf_counter_ns()
                out = eng(xn, xc).cpu().numpy()[:, None]
                telemetry.histogram(
                    "ydf_serve_kernel_latency_ns", engine=name,
                    batch_pow2=telemetry.pow2_bucket(max(len(out), 1)),
                ).observe_ns(time.perf_counter_ns() - t0)
                return out, name
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
        return out.cpu().numpy(), "Routed"

    def _raw_scores(self, data: InputData, combine: str) -> np.ndarray:
        """Raw (margin) scores f32 [n, V] as numpy, under the spans
        serve.predict -> serve.encode, serve.kernel; with telemetry on,
        the whole call's latency goes to ydf_serve_latency_ns by engine
        and power-of-two batch, and ydf_serve_requests_total counts it
        (the JAX package's _note_serve)."""
        with telemetry.span("serve.predict") as sp:
            t0_ns = time.perf_counter_ns() if telemetry.ENABLED else 0
            with telemetry.span("serve.encode"):
                enc = self._encode(data)
            with telemetry.span("serve.kernel"):
                out, engine = self._serve(enc, combine)
            if telemetry.ENABLED:
                batch = int(enc["x_num"].shape[0])
                telemetry.histogram(
                    "ydf_serve_latency_ns", engine=engine,
                    batch_pow2=telemetry.pow2_bucket(max(batch, 1)),
                ).observe_ns(time.perf_counter_ns() - t0_ns)
                telemetry.counter("ydf_serve_requests_total",
                                  engine=engine).inc()
                sp.set(engine=engine, batch=batch)
            return out

    def predict_class(self, data: InputData) -> np.ndarray:
        """The most likely class name of every row (classification)."""
        if not self.classes:
            raise ValueError(
                "predict_class is only defined for classification models")
        p = np.asarray(self.predict(data))
        classes = np.asarray(self.classes)
        if p.ndim == 1:  # binary: the probability of classes[1]
            return classes[(p >= 0.5).astype(np.int64)]
        return classes[np.argmax(p, axis=1)]

    def predict_tf_examples(self, serialized) -> np.ndarray:
        """Scores a sequence of serialized tf.Example protos (the JAX
        package's predict_tf_examples, over the port's wire codec)."""
        from ydf_tpu_torch.dataset.tfrecord import tf_examples_to_columns

        return self.predict(Dataset.from_data(
            tf_examples_to_columns(serialized), dataspec=self.dataspec))

    def predict_example(self, example: dict):
        """Scores one {column: value} row (dataset/example.py); a column
        the row lacks is a missing value."""
        return self.predict(Dataset.from_examples([example],
                                                  dataspec=self.dataspec))[0]

    def _leaves(self, data: InputData) -> torch.Tensor:
        """Leaf ids int32 [n, T] on the model's device."""
        enc = self._encode(data)
        return forest_leaves(
            self.forest, enc["x_num"], enc["x_cat"],
            num_numerical=self.binner.num_numerical,
            max_depth=self.max_depth, x_vs_vals=enc.get("x_vs_vals"),
            x_vs_len=enc.get("x_vs_len"), vs_missing=enc.get("vs_missing"),
            x_set=enc.get("x_set"), set_missing=enc.get("set_missing"),
        )

    def predict_leaves(self, data: InputData) -> np.ndarray:
        """The leaf node id of every row in every tree: int32 [n, T]
        (the reference's PredictLeaves)."""
        return self._leaves(data).cpu().numpy()

    def distance(self, data1: InputData,
                 data2: Optional[InputData] = None) -> np.ndarray:
        """Pairwise distance f32 [n1, n2]: 1 - the fraction of trees that
        route the pair to the same leaf (Breiman proximity;
        ops/routing.py:leaf_proximity); data2=None compares data1 with
        itself."""
        l1 = self._leaves(data1)
        l2 = l1 if data2 is None else self._leaves(data2)
        return 1.0 - leaf_proximity(l1, l2).cpu().numpy()

    def benchmark(self, data: InputData, num_runs: int = 10,
                  engines: bool = False) -> dict:
        """Inference speed on `data`: the best wall time of `num_runs`
        predicts after one warm-up (kernel builds excluded), per-example
        p50 / p99 and the growth of the process's peak RSS over the runs.
        engines=True also times each serving engine whose envelope takes
        the model on the encoded inputs (encoding excluded): `routed`
        (ops/routing.py), `quickscorer`, `binned_quickscorer` (on the
        binner's bins) and the bank under its registry name,
        `BankScorer`."""
        import time

        from ydf_tpu_torch.utils.telemetry import (
            LatencyHistogram,
            peak_rss_bytes,
        )

        if num_runs < 1:
            raise ValueError("num_runs must be >= 1")
        ds = Dataset.from_data(data, dataspec=self.dataspec)
        self.predict(ds)  # warm-up: kernel builds and engine tables
        rss0 = peak_rss_bytes()
        times = []
        hist = LatencyHistogram()
        for _ in range(num_runs):
            t0 = time.perf_counter()
            self.predict(ds)
            dt = time.perf_counter() - t0
            times.append(dt)
            hist.observe_s(dt)
        best = min(times)
        n = max(ds.num_rows, 1)
        out = {
            "num_examples": ds.num_rows,
            "num_runs": num_runs,
            "best_wall_s": best,
            "ns_per_example": 1e9 * best / n,
            "p50_ns_per_example": hist.percentile_ns(50) / n,
            "p99_ns_per_example": hist.percentile_ns(99) / n,
            "peak_rss_delta_bytes": max(peak_rss_bytes() - rss0, 0),
        }
        if not engines:
            return out
        from ydf_tpu_torch.serving import bank_scorer, quickscorer, registry

        dev = self.device

        def _time_engine(fn):
            fn()  # warm-up
            ts = []
            for _ in range(num_runs):
                t0 = time.perf_counter()
                fn()
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                ts.append(time.perf_counter() - t0)
            return 1e9 * min(ts) / n

        enc = self._encode(ds)
        xn, xc = enc["x_num"], enc["x_cat"]
        eng = {"routed": _time_engine(lambda: forest_predict_values(
            self.forest, xn, xc, num_numerical=self.binner.num_numerical,
            max_depth=self.max_depth, combine="sum", x_set=enc.get("x_set"),
            x_vs_vals=enc.get("x_vs_vals"), x_vs_len=enc.get("x_vs_len")))}
        if getattr(self, "num_trees_per_iter", 1) == 1:
            if registry._qs_compatible(self):
                qs = quickscorer.build_quickscorer(self)
                eng["quickscorer"] = _time_engine(lambda: qs(xn, xc))
                bq = quickscorer.build_binned_quickscorer(self)
                if bq is not None:
                    bins = self.binner.transform(ds, dev)
                    eng["binned_quickscorer"] = _time_engine(
                        lambda: bq(bins))
            if bank_scorer.in_envelope(self):
                bank = bank_scorer.build_bank_scorer(self)
                eng["BankScorer"] = _time_engine(lambda: bank(xn, xc))
        out["engines_ns_per_example"] = eng
        return out

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

    def save_ydf(self, path: str) -> None:
        """Writes the model as a reference YDF model directory
        (models/ydf_format.py), the bytes the JAX package's save_ydf
        writes."""
        from ydf_tpu_torch.models.ydf_format import export_ydf_model

        export_ydf_model(self, path)

    def serialize(self) -> bytes:
        """The model as bytes, a tar of the saved directory; restore with
        deserialize_model of either package."""
        import io
        import tarfile
        import tempfile

        with tempfile.TemporaryDirectory() as tmp:
            self.save(tmp)
            buf = io.BytesIO()
            with tarfile.open(fileobj=buf, mode="w") as tar:
                tar.add(tmp, arcname="model")
            return buf.getvalue()

    def _metadata(self) -> Dict[str, Any]:
        """Subclass-specific JSON metadata."""
        return {}
