"""Evaluation metrics (counterpart of ydf_tpu/metrics/metrics.py:
Evaluation, evaluate_predictions and the functions it calls), numpy on
the host over full prediction arrays, with the JAX package's
expressions, so an evaluation of the same predictions equals its own.

  * classification: accuracy, loss, the confusion matrix; binary also
    ROC-AUC and PR-AUC (exact rank statistics), precision, recall, F1
    and the ROC curve points;
  * regression: RMSE, MAE, R², and MSLE/RMSLE on non-negative labels;
  * ranking: NDCG@k, MRR and MAP@k over query groups;
  * survival analysis: Harrell's concordance index;
  * confidence intervals: Wilson (accuracy), Hanley-McNeil (AUC) and a
    percentile bootstrap over examples for every other scalar metric.

  * anomaly detection: the ROC AUC of the scores when labels are given;
  * the uplift tasks: the Qini and the area under the uplift curve
    (qini_curve).

The HTML report is not ported (ROADMAP Queue 1 item 20).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from ydf_tpu_torch.config import UPLIFT_TASKS, Task

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


def mrr(labels, scores, groups) -> float:
    """Mean reciprocal rank over groups: 1/rank of the first relevant item
    (reference ranking_mrr.cc; relevant = label >= 1)."""
    labels = np.asarray(labels, dtype=np.float64)
    scores = np.asarray(scores, dtype=np.float64)
    groups = np.asarray(groups)
    total, count = 0.0, 0
    for gid in np.unique(groups):
        m = groups == gid
        rel = labels[m] >= 1.0
        if not rel.any():
            continue
        order = np.argsort(-scores[m], kind="mergesort")
        first = int(np.argmax(rel[order])) + 1
        total += 1.0 / first
        count += 1
    return float(total / max(count, 1))


def mean_average_precision(labels, scores, groups, k: int = 5) -> float:
    """Mean AP@k over query groups (reference ranking_ap.cc APCalculator:
    relevant = label > 0.5; AP = mean over relevant ranks r<=k of
    precision@r; groups with no relevant item in the top-k score 0)."""
    labels = np.asarray(labels, dtype=np.float64)
    scores = np.asarray(scores, dtype=np.float64)
    groups = np.asarray(groups)
    total, count = 0.0, 0
    for gid in np.unique(groups):
        m = groups == gid
        rel = labels[m] > 0.5
        order = np.argsort(-scores[m], kind="mergesort")
        kk = min(k, len(order))
        hits = rel[order[:kk]]
        num_rel = np.cumsum(hits)
        ap_terms = np.where(hits, num_rel / np.arange(1, kk + 1), 0.0)
        total += float(ap_terms.sum() / num_rel[-1]) if num_rel[-1] > 0 else 0.0
        count += 1
    return float(total / max(count, 1))


def concordance_index(
    times, risk_scores, events, weights=None, max_pairs_rows: int = 8000,
    seed: int = 7,
) -> float:
    """Harrell's C-index: among comparable pairs (i observed an event
    before j's departure), the fraction where the higher-risk prediction
    belongs to i (ties count half). Subsamples rows beyond
    `max_pairs_rows` to bound the O(n²) pair matrix."""
    times = np.asarray(times, np.float64)
    risk = np.asarray(risk_scores, np.float64)
    events = np.asarray(events).astype(bool)
    n = len(times)
    w = np.ones(n) if weights is None else np.asarray(weights, np.float64)
    if n > max_pairs_rows:
        idx = np.random.RandomState(seed).choice(n, max_pairs_rows, False)
        times, risk, events, w = times[idx], risk[idx], events[idx], w[idx]
        n = max_pairs_rows
    num = den = 0.0
    # Chunk the i axis so peak memory stays at chunk×n, not n².
    chunk = max(1, (1 << 22) // max(n, 1))
    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)
        comparable = events[lo:hi, None] & (times[lo:hi, None] < times[None, :])
        pair_w = comparable * (w[lo:hi, None] * w[None, :])
        conc = np.where(risk[lo:hi, None] > risk[None, :], 1.0, 0.0)
        conc = np.where(risk[lo:hi, None] == risk[None, :], 0.5, conc)
        num += float((pair_w * conc).sum())
        den += float(pair_w.sum())
    return float(num / den) if den > 0 else float("nan")


def ndcg_at_k(labels, scores, groups, k: int = 5) -> float:
    """Mean NDCG@k over query groups with exponential gains
    (reference ranking_ndcg.cc: gain = 2^rel - 1)."""
    labels = np.asarray(labels, dtype=np.float64)
    scores = np.asarray(scores, dtype=np.float64)
    groups = np.asarray(groups)
    total, count = 0.0, 0
    for gid in np.unique(groups):
        m = groups == gid
        rel = labels[m]
        sc = scores[m]
        if len(rel) == 0:
            continue
        order = np.argsort(-sc, kind="mergesort")
        ideal = np.sort(rel)[::-1]
        kk = min(k, len(rel))
        discounts = 1.0 / np.log2(np.arange(2, kk + 2))
        dcg = np.sum((2.0 ** rel[order[:kk]] - 1) * discounts)
        idcg = np.sum((2.0 ** ideal[:kk] - 1) * discounts)
        if idcg > 0:
            total += dcg / idcg
            count += 1
    return float(total / max(count, 1))


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


def qini_curve(uplift_pred, outcome, treatment, weights=None) -> dict:
    """The Qini curve of uplift predictions and the areas under it (the
    JAX package's qini_curve, after the reference's metric/uplift.cc):
    rows by decreasing predicted uplift (a stable sort), the cumulative
    treated positives minus the control positives scaled to the treated
    weight, per unit of total weight, over the cumulative weight
    fraction. outcome: 1 positive; treatment: 1 treated, 0 control.
    Returns {"qini": the area above the random line, "auuc": the area,
    "curve_fraction", "curve_uplift"}."""
    n = len(uplift_pred)
    w = np.ones(n) if weights is None else np.asarray(weights, np.float64)
    order = np.argsort(-np.asarray(uplift_pred, np.float64), kind="mergesort")
    y = np.asarray(outcome, np.float64)[order]
    t = np.asarray(treatment, np.float64)[order]
    ww = w[order]
    cum_w = np.cumsum(ww)
    yt = np.cumsum(ww * y * t)
    yc = np.cumsum(ww * y * (1 - t))
    nt = np.cumsum(ww * t)
    nc = np.cumsum(ww * (1 - t))
    q = yt - yc * nt / np.maximum(nc, _EPS)
    frac = cum_w / cum_w[-1]
    qn = q / cum_w[-1]
    auuc = float(_trapezoid(qn, frac))
    return {
        "qini": float(auuc - 0.5 * qn[-1]),
        "auuc": auuc,
        "curve_fraction": frac,
        "curve_uplift": qn,
    }


def _trapezoid(y: np.ndarray, x: np.ndarray) -> float:
    """np.trapezoid (numpy 2), or the same sum as np.trapz (numpy 1)."""
    fn = getattr(np, "trapezoid", None) or np.trapz
    return fn(y, x)


def evaluate_predictions(
    task,
    labels: np.ndarray,
    predictions: np.ndarray,
    classes: Optional[List[str]] = None,
    weights: Optional[np.ndarray] = None,
    groups: Optional[np.ndarray] = None,
    ndcg_truncation: int = 5,
    confidence_intervals: bool = False,
    num_bootstrap: int = 2000,
    seed: int = 1234,
    treatments: Optional[np.ndarray] = None,
    events: Optional[np.ndarray] = None,
) -> Evaluation:
    """The metrics of `predictions` (binary classification: P(class 1)
    [n], or probabilities [n, C]; regression, ranking and survival: raw
    values) against the encoded `labels` (class indices, values,
    relevances or departure ages), each example weighted by `weights`
    (default 1); ranking reads each row's query `groups`, survival its
    `events`, the uplift tasks its `treatments` (1 treated, 0 control;
    the labels are 0/1 outcomes or values, the predictions uplifts).
    Intervals, when asked for: a bootstrap of `num_bootstrap` resamples
    drawn from `seed` (over query groups for ranking), overridden by the
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

    if task == Task.RANKING:
        assert groups is not None, "Ranking evaluation needs group ids"
        preds1 = predictions.reshape(-1)
        key = f"ndcg@{ndcg_truncation}"
        metrics = {
            key: ndcg_at_k(labels, preds1, groups, ndcg_truncation),
            "mrr": mrr(labels, preds1, groups),
            f"map@{ndcg_truncation}": mean_average_precision(
                labels, preds1, groups, ndcg_truncation
            ),
        }
        cis = None
        if confidence_intervals:
            # Resample query groups, not rows (groups are the i.i.d. unit).
            uniq = np.unique(np.asarray(groups))
            rows_of = {g: np.flatnonzero(np.asarray(groups) == g) for g in uniq}

            def rank_metrics(idx_groups):
                gs = uniq[np.asarray(idx_groups) % len(uniq)]
                rows = np.concatenate([rows_of[g] for g in gs])
                # Re-label each drawn group uniquely so a group sampled
                # twice counts twice instead of merging into one
                # double-sized group.
                gids = np.repeat(
                    np.arange(len(gs)), [len(rows_of[g]) for g in gs]
                )
                return {
                    key: ndcg_at_k(
                        labels[rows], preds1[rows], gids, ndcg_truncation
                    ),
                    "mrr": mrr(labels[rows], preds1[rows], gids),
                }

            cis = bootstrap_intervals(
                rank_metrics, len(uniq), num_bootstrap=min(num_bootstrap, 500),
                seed=seed,
            )
        return Evaluation(
            task=task.value, num_examples=n, metrics=metrics,
            confidence_intervals=cis,
        )

    if task == Task.SURVIVAL_ANALYSIS:
        if events is None:
            raise ValueError(
                "Task.SURVIVAL_ANALYSIS evaluation requires events="
            )
        return Evaluation(
            task=task.value,
            num_examples=n,
            metrics={
                "concordance": concordance_index(
                    labels, predictions.reshape(-1), events, w
                )
            },
        )

    if task in UPLIFT_TASKS:
        assert treatments is not None, "Uplift evaluation needs treatments"
        r = qini_curve(predictions.reshape(-1), labels, treatments, w)
        return Evaluation(
            task=task.value, num_examples=n,
            metrics={"qini": r["qini"], "auuc": r["auuc"]},
        )

    if task == Task.ANOMALY_DETECTION:
        # The ROC AUC of the scores when the labels take two values.
        metrics = {}
        if len(np.unique(labels)) == 2:
            metrics["auc"] = roc_auc(labels, predictions.reshape(-1))
        return Evaluation(task=task.value, num_examples=n, metrics=metrics)

    raise NotImplementedError(f"Evaluation for task {task}")
