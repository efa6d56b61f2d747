"""Evaluation metrics (counterpart of ydf_tpu/metrics/metrics.py:
Evaluation, evaluate_predictions and the functions it calls), numpy on
the host over full prediction arrays, with the JAX package's
expressions, so an evaluation of the same predictions equals its own.

  * classification: accuracy, loss, the confusion matrix; binary also
    ROC-AUC and PR-AUC (exact rank statistics), precision, recall, F1
    and the ROC curve points;
  * regression: RMSE, MAE, R², and MSLE/RMSLE on non-negative labels;
  * confidence intervals: Wilson (accuracy), Hanley-McNeil (AUC) and a
    percentile bootstrap over examples for every other scalar metric.

Ranking, uplift, survival and anomaly-detection metrics and the HTML
report are not ported (ROADMAP Queue 1 items 11 and 20).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from ydf_tpu_torch.config import Task

_EPS = 1e-12


@dataclasses.dataclass
class Evaluation:
    """Evaluation report; printable like the reference's text report
    (`ydf/metric/report.cc`)."""

    task: str
    num_examples: int
    metrics: Dict[str, float]
    confusion: Optional[np.ndarray] = None
    classes: Optional[List[str]] = None
    # metric name -> (lo, hi) 95% interval, when requested.
    confidence_intervals: Optional[Dict[str, tuple]] = None
    # (fpr, tpr, thresholds) arrays for binary classification.
    roc_curve: Optional[tuple] = None

    def __getattr__(self, name):
        m = object.__getattribute__(self, "metrics")
        if name in m:
            return m[name]
        raise AttributeError(name)

    def __str__(self) -> str:
        lines = [f"Evaluation ({self.task}, {self.num_examples} examples)"]
        for k, v in self.metrics.items():
            ci = (self.confidence_intervals or {}).get(k)
            tail = f"  CI95 [{ci[0]:.6g}, {ci[1]:.6g}]" if ci else ""
            lines.append(f"  {k}: {v:.6g}{tail}")
        if self.confusion is not None and self.classes is not None:
            lines.append("  confusion (rows=label, cols=prediction):")
            header = "    " + " ".join(f"{c:>10}" for c in self.classes)
            lines.append(header)
            for i, row in enumerate(self.confusion):
                lines.append(
                    f"    {self.classes[i]:>4} "
                    + " ".join(f"{int(v):>10}" for v in row)
                )
        return "\n".join(lines)

    def to_html(self) -> str:
        raise NotImplementedError(
            "the HTML evaluation report is not ported yet (ROADMAP Queue 1 "
            "item 20)"
        )


def roc_auc(labels: np.ndarray, scores: np.ndarray) -> float:
    """Exact ROC-AUC via the rank statistic (ties get average rank)."""
    labels = np.asarray(labels).astype(np.int64)
    scores = np.asarray(scores).astype(np.float64)
    n_pos = int(labels.sum())
    n_neg = len(labels) - n_pos
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    order = np.argsort(scores, kind="mergesort")
    sorted_scores = scores[order]
    # average ranks for ties, vectorized: one segment per distinct score
    starts = np.r_[0, np.flatnonzero(np.diff(sorted_scores) != 0) + 1]
    ends = np.r_[starts[1:], len(sorted_scores)]
    seg_rank = (starts + 1 + ends) / 2.0  # mean of ranks start+1..end
    ranks = np.empty(len(scores), dtype=np.float64)
    ranks[order] = np.repeat(seg_rank, ends - starts)
    sum_pos = ranks[labels == 1].sum()
    return float((sum_pos - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg))


def pr_auc(labels: np.ndarray, scores: np.ndarray) -> float:
    labels = np.asarray(labels).astype(np.int64)
    order = np.argsort(-np.asarray(scores, dtype=np.float64), kind="mergesort")
    y = labels[order]
    tp = np.cumsum(y)
    n_pos = tp[-1] if len(tp) else 0
    if n_pos == 0:
        return float("nan")
    precision = tp / np.arange(1, len(y) + 1)
    recall = tp / n_pos
    # step-wise interpolation (trapezoid over recall)
    return float(np.sum(np.diff(np.concatenate([[0.0], recall])) * precision))


def roc_curve_points(labels: np.ndarray, scores: np.ndarray):
    """(fpr, tpr, thresholds), one point per distinct score, descending
    threshold — the reference's ROC representation (`metric.h:98`)."""
    labels = np.asarray(labels).astype(np.int64)
    scores = np.asarray(scores, dtype=np.float64)
    order = np.argsort(-scores, kind="mergesort")
    y = labels[order]
    s = scores[order]
    distinct = np.r_[np.diff(s) != 0, True]
    tp = np.cumsum(y)[distinct]
    fp = np.cumsum(1 - y)[distinct]
    n_pos = max(int(labels.sum()), 1)
    n_neg = max(len(labels) - int(labels.sum()), 1)
    fpr = np.r_[0.0, fp / n_neg]
    tpr = np.r_[0.0, tp / n_pos]
    thr = np.r_[np.inf, s[distinct]]
    return fpr, tpr, thr


def wilson_interval(p: float, n: float, z: float = 1.959964) -> tuple:
    """Closed-form 95% CI for a proportion (accuracy) — the reference's
    closed-form CI family (`metric.h:160-169`)."""
    if n == 0 or not np.isfinite(p):
        return (float("nan"), float("nan"))
    denom = 1 + z * z / n
    center = (p + z * z / (2 * n)) / denom
    half = z * np.sqrt(p * (1 - p) / n + z * z / (4 * n * n)) / denom
    return (float(center - half), float(center + half))


def hanley_mcneil_interval(auc: float, n_pos: int, n_neg: int,
                           z: float = 1.959964) -> tuple:
    """Closed-form AUC CI (Hanley & McNeil 1982)."""
    if not np.isfinite(auc) or n_pos == 0 or n_neg == 0:
        return (float("nan"), float("nan"))
    q1 = auc / (2 - auc)
    q2 = 2 * auc * auc / (1 + auc)
    var = (
        auc * (1 - auc)
        + (n_pos - 1) * (q1 - auc * auc)
        + (n_neg - 1) * (q2 - auc * auc)
    ) / (n_pos * n_neg)
    half = z * np.sqrt(max(var, 0.0))
    return (float(auc - half), float(auc + half))


def bootstrap_intervals(
    metric_fn,
    n: int,
    num_bootstrap: int = 2000,
    seed: int = 1234,
    alpha: float = 0.05,
) -> Dict[str, tuple]:
    """Percentile bootstrap over example resamples (`metric.h:170-177`).
    metric_fn(row_indices) -> dict of scalar metrics."""
    rng = np.random.default_rng(seed)
    samples: Dict[str, list] = {}
    for _ in range(num_bootstrap):
        idx = rng.integers(0, n, size=n)
        for k, v in metric_fn(idx).items():
            samples.setdefault(k, []).append(v)
    out = {}
    for k, vs in samples.items():
        vs = np.asarray(vs, dtype=np.float64)
        vs = vs[np.isfinite(vs)]
        if len(vs) == 0:
            out[k] = (float("nan"), float("nan"))
        else:
            out[k] = (
                float(np.quantile(vs, alpha / 2)),
                float(np.quantile(vs, 1 - alpha / 2)),
            )
    return out


def evaluate_predictions(
    task,
    labels: np.ndarray,
    predictions: np.ndarray,
    classes: Optional[List[str]] = None,
    weights: Optional[np.ndarray] = None,
    confidence_intervals: bool = False,
    num_bootstrap: int = 2000,
    seed: int = 1234,
) -> Evaluation:
    """The metrics of `predictions` (binary classification: P(class 1)
    [n], or probabilities [n, C]; regression: values) against the
    encoded `labels` (class indices, or values), each example weighted
    by `weights` (default 1). Intervals, when asked for: a bootstrap of
    `num_bootstrap` resamples drawn from `seed`, overridden by the
    closed forms where they exist."""
    labels = np.asarray(labels)
    predictions = np.asarray(predictions)
    n = len(labels)
    w = np.ones(n) if weights is None else np.asarray(weights, np.float64)

    if task == Task.CLASSIFICATION:
        if predictions.ndim == 1:  # binary: P(class 1)
            proba = np.stack([1 - predictions, predictions], axis=1)
        else:
            proba = predictions
        C = proba.shape[1]

        def cls_metrics(idx, rank_metrics=True):
            pb, lb, ww = proba[idx], labels[idx].astype(int), w[idx]
            pred_cls = np.argmax(pb, axis=1)
            m = {
                "accuracy": float(np.sum(ww * (pred_cls == lb)) / ww.sum()),
                "loss": float(
                    -np.sum(
                        ww
                        * np.log(
                            np.clip(pb[np.arange(len(lb)), lb], _EPS, 1.0)
                        )
                    )
                    / ww.sum()
                ),
            }
            if C == 2:
                if rank_metrics:
                    # auc is skipped inside the bootstrap (its closed-form
                    # interval overrides the bootstrap one anyway).
                    m["auc"] = roc_auc(lb, pb[:, 1])
                m["pr_auc"] = pr_auc(lb, pb[:, 1])
                tp = float(np.sum(ww * ((pred_cls == 1) & (lb == 1))))
                fp = float(np.sum(ww * ((pred_cls == 1) & (lb == 0))))
                fn = float(np.sum(ww * ((pred_cls == 0) & (lb == 1))))
                m["precision"] = tp / max(tp + fp, _EPS)
                m["recall"] = tp / max(tp + fn, _EPS)
                m["f1"] = 2 * tp / max(2 * tp + fp + fn, _EPS)
            return m

        metrics = cls_metrics(np.arange(n))
        pred_cls = np.argmax(proba, axis=1)
        conf = np.zeros((C, C), dtype=np.int64)
        np.add.at(conf, (labels.astype(int), pred_cls), 1)
        roc = roc_curve_points(labels, proba[:, 1]) if C == 2 else None
        cis = None
        if confidence_intervals:
            cis = bootstrap_intervals(
                lambda idx: cls_metrics(idx, rank_metrics=False),
                n, num_bootstrap=num_bootstrap, seed=seed,
            )
            # Closed-form intervals override the bootstrap where they exist
            # (the reference reports both families; metric.h:160-169).
            # Weighted data: use the effective sample size (Kish).
            n_eff = float(w.sum() ** 2 / np.sum(w**2))
            cis["accuracy"] = wilson_interval(metrics["accuracy"], n_eff)
            if C == 2:
                pos_frac = float(w[labels == 1].sum() / w.sum())
                cis["auc"] = hanley_mcneil_interval(
                    metrics["auc"],
                    max(int(n_eff * pos_frac), 1),
                    max(int(n_eff * (1 - pos_frac)), 1),
                )
        return Evaluation(
            task=task.value, num_examples=n, metrics=metrics,
            confusion=conf, classes=classes, confidence_intervals=cis,
            roc_curve=roc,
        )

    if task == Task.REGRESSION:
        preds1 = predictions.reshape(-1)

        def reg_metrics(idx):
            err = preds1[idx] - labels[idx]
            ww = w[idx]
            rmse = float(np.sqrt(np.sum(ww * err**2) / ww.sum()))
            mae = float(np.sum(ww * np.abs(err)) / ww.sum())
            var = float(
                np.sum(ww * (labels[idx] - np.average(labels[idx], weights=ww)) ** 2)
                / ww.sum()
            )
            out = {
                "rmse": rmse,
                "mae": mae,
                "r2": 1.0 - (rmse**2 / var) if var > 0 else float("nan"),
            }
            if np.all(labels[idx] >= 0):
                # MSLE/RMSLE (reference metric.cc:1030: negative predictions
                # clamp to 0; negative labels are an error — here the
                # metrics are simply omitted).
                lerr = np.log1p(np.maximum(preds1[idx], 0.0)) - np.log1p(
                    labels[idx]
                )
                out["msle"] = float(np.sum(ww * lerr**2) / ww.sum())
                out["rmsle"] = float(np.sqrt(out["msle"]))
            return out

        metrics = reg_metrics(np.arange(n))
        cis = (
            bootstrap_intervals(
                reg_metrics, n, num_bootstrap=num_bootstrap, seed=seed
            )
            if confidence_intervals
            else None
        )
        return Evaluation(
            task=task.value, num_examples=n, metrics=metrics,
            confidence_intervals=cis,
        )

    raise NotImplementedError(
        f"evaluation for task {task.value} is not ported yet (ROADMAP "
        "Queue 1 items 11 and 20)"
    )
