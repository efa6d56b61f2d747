"""Mergeable pass-1 summaries of the streaming dataset cache
(counterpart of ydf_tpu/dataset/sketch.py, copied expression for
expression so that the port's caches equal the JAX package's byte for
byte).

Two summary modes, one class (`NumericSummary`):

  * **exact**: the full weighted multiset, stored as (ascending unique
    float64 values, int64 counts) and merged by multiset union. Merge is
    commutative and associative, so any chunking of the rows gives
    bit-identical merged state. Rank error: 0.
  * **sketch**: a deterministic KLL-style compactor. The summary stays
    an exact multiset up to `EXACT_CAP` (256) distinct values (so the
    midpoint boundaries of a column with at most num_bins - 1 distinct
    values stay exact), then spills into levels of sorted arrays where
    level l carries weight 2^l per item and holds at most `k` items. A
    full level compacts: every other item (the start parity alternating
    per level) promotes with doubled weight, and the compaction adds at
    most 2^l to the worst-case absolute rank error, accounted exactly
    (`err_units`, `rank_error_bound()`). Merge concatenates levels and
    re-compacts: deterministic for a fixed order of chunks and merges.

The scalar statistics are order-independent in both modes: count and
missing are integers, min/max canonicalize +-0.0, and the sum is an
exact dyadic rational (big-int mantissa x 2^exponent), whose `mean()`
converts through `Fraction` (correctly rounded). The mean imputes
missing values, so it picks bins: no float accumulation here.

`IngestPartial` bundles the whole pass-1 state (column order, row
count, per-column numeric summaries and categorical value counts) as
one mergeable unit with a wire form.
"""

from __future__ import annotations

import math
from fractions import Fraction
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

__all__ = [
    "NumericSummary",
    "IngestPartial",
    "dyadic_sum",
    "dyadic_add",
    "dyadic_to_float",
]

# 2^53 — float64 mantissas scaled by this are exact integers.
_MANT_SCALE = float(1 << 53)
# int64-safe partial-sum run length: 512 mantissas of < 2^53 < 2^62.
_SUM_RUN = 512


def _dyadic_norm(m: int, e: int) -> Tuple[int, int]:
    if m == 0:
        return (0, 0)
    tz = (m & -m).bit_length() - 1
    return (m >> tz, e + tz)


def dyadic_sum(vals: np.ndarray) -> Tuple[int, int]:
    """EXACT sum of finite float64 values as a normalized dyadic
    rational (mantissa, exponent): sum == mantissa * 2**exponent.
    Vectorized: per-exponent int64 partial sums (runs of ≤ 512 keep
    int64 exact), combined with big-int arithmetic — O(n) numpy work
    plus O(n/512) Python-int additions. Being a plain integer sum, it
    is commutative/associative: any chunking of the rows produces the
    identical result, unlike float accumulation."""
    vals = np.asarray(vals, np.float64)
    if vals.size == 0:
        return (0, 0)
    m, e = np.frexp(vals)
    mi = (m * _MANT_SCALE).astype(np.int64)  # exact: ≤ 53-bit mantissa
    ee = e.astype(np.int64) - 53
    order = np.argsort(ee, kind="stable")
    mi = mi[order]
    ee = ee[order]
    change = np.flatnonzero(np.diff(ee)) + 1
    bounds = np.concatenate(
        (np.zeros(1, np.int64), change, np.asarray([len(ee)], np.int64))
    )
    starts: List[int] = []
    for a, b in zip(bounds[:-1].tolist(), bounds[1:].tolist()):
        starts.extend(range(a, b, _SUM_RUN))
    part = np.add.reduceat(mi, starts)
    pexp = ee[np.asarray(starts, np.int64)]
    e_min = int(pexp.min())
    total = 0
    for p, ex in zip(part.tolist(), pexp.tolist()):
        total += p << (ex - e_min)
    return _dyadic_norm(total, e_min)


def dyadic_add(a: Tuple[int, int], b: Tuple[int, int]) -> Tuple[int, int]:
    (m1, e1), (m2, e2) = a, b
    if m1 == 0:
        return _dyadic_norm(m2, e2)
    if m2 == 0:
        return _dyadic_norm(m1, e1)
    e = min(e1, e2)
    return _dyadic_norm((m1 << (e1 - e)) + (m2 << (e2 - e)), e)


def dyadic_to_float(d: Tuple[int, int], div: int = 1) -> float:
    """Correctly-rounded float of (mantissa * 2**exponent) / div."""
    m, e = d
    if m == 0:
        return 0.0
    if e >= 0:
        return float(Fraction(m << e, div))
    return float(Fraction(m, div << (-e)))


class NumericSummary:
    """Mergeable summary of one numerical column (module docstring)."""

    #: Exact-multiset capacity of sketch mode before spilling to the
    #: compactor. 256 > the 255-boundary maximum, so the midpoint
    #: (exact-split-equivalence) path always sees true distinct values.
    EXACT_CAP = 256

    __slots__ = (
        "mode", "k", "count", "missing", "min", "max", "sum_d",
        "sum_nonfinite", "values", "counts", "spilled", "levels",
        "parity", "err_units",
    )

    def __init__(self, mode: str = "exact", k: int = 4096):
        if mode not in ("exact", "sketch"):
            raise ValueError(
                f"summary mode {mode!r} is not one of ('exact', 'sketch')"
            )
        k = int(k)
        if k < 8 or k % 2:
            raise ValueError(f"sketch k must be an even int >= 8, got {k}")
        self.mode = mode
        self.k = k
        self.count = 0
        self.missing = 0
        self.min = math.inf
        self.max = -math.inf
        self.sum_d: Tuple[int, int] = (0, 0)
        self.sum_nonfinite = 0.0  # ±inf contributions, kept out of sum_d
        self.values = np.zeros((0,), np.float64)  # ascending unique
        self.counts = np.zeros((0,), np.int64)
        self.spilled = False
        self.levels: List[np.ndarray] = []
        self.parity: List[int] = []
        self.err_units = 0  # worst-case absolute rank error, exact

    # ---- ingest ------------------------------------------------------ #

    def update(self, vals: np.ndarray) -> None:
        vals = np.asarray(vals, np.float64)
        miss = np.isnan(vals)
        self.missing += int(miss.sum())
        ok = vals[~miss]
        if ok.size == 0:
            return
        # Canonicalize -0.0 → +0.0 (exact for every other value): the
        # multiset, min/max and boundaries must not depend on which
        # zero representation a chunk happened to carry.
        ok = ok + 0.0
        self.count += int(ok.size)
        mn, mx = float(ok.min()), float(ok.max())
        self.min = min(self.min, mn)
        self.max = max(self.max, mx)
        fin = np.isfinite(ok)
        if not fin.all():
            self.sum_nonfinite = float(
                self.sum_nonfinite + ok[~fin].sum()
            )
            self.sum_d = dyadic_add(self.sum_d, dyadic_sum(ok[fin]))
        else:
            self.sum_d = dyadic_add(self.sum_d, dyadic_sum(ok))
        u, c = np.unique(ok, return_counts=True)
        self._absorb(u, c.astype(np.int64))

    def _absorb(self, u: np.ndarray, c: np.ndarray) -> None:
        if u.size == 0:
            return
        if not self.spilled:
            v = np.concatenate([self.values, u])
            ct = np.concatenate([self.counts, c])
            nv, inv = np.unique(v, return_inverse=True)
            nc = np.zeros(len(nv), np.int64)
            np.add.at(nc, inv, ct)
            self.values, self.counts = nv, nc
            if self.mode == "sketch" and len(nv) > self.EXACT_CAP:
                self._spill()
        else:
            self._push_weighted(u, c)

    def _spill(self) -> None:
        """Exact multiset → compactor levels: each count decomposes
        into its binary digits (count bit b set → the value joins
        level b with weight 2^b). Purely structural — total weight and
        the represented distribution are unchanged (err_units does not
        move here)."""
        self.spilled = True
        v, c = self.values, self.counts
        self.values = np.zeros((0,), np.float64)
        self.counts = np.zeros((0,), np.int64)
        if v.size == 0:
            return
        for b in range(int(c.max()).bit_length()):
            sel = ((c >> b) & 1) == 1
            if sel.any():
                self._level_insert(b, v[sel])
        self._compact_all()

    def _level_insert(self, lvl: int, sorted_vals: np.ndarray) -> None:
        while len(self.levels) <= lvl:
            self.levels.append(np.zeros((0,), np.float64))
            self.parity.append(0)
        self.levels[lvl] = np.sort(
            np.concatenate([self.levels[lvl], sorted_vals])
        )

    def _push_weighted(self, u: np.ndarray, c: np.ndarray) -> None:
        for b in range(int(c.max()).bit_length()):
            sel = ((c >> b) & 1) == 1
            if sel.any():
                self._level_insert(b, u[sel])
        self._compact_all()

    def _compact_all(self) -> None:
        lvl = 0
        while lvl < len(self.levels):
            if len(self.levels[lvl]) >= self.k:
                self._compact(lvl)
            lvl += 1

    def _compact(self, lvl: int) -> None:
        arr = self.levels[lvl]
        m = len(arr)
        tail: Optional[np.ndarray] = None
        if m % 2:
            # Odd survivor stays at this level (deterministically the
            # largest) so total weight is preserved exactly.
            tail, arr, m = arr[-1:], arr[:-1], m - 1
        start = self.parity[lvl]
        self.parity[lvl] ^= 1
        promoted = arr[start::2]
        self.levels[lvl] = (
            tail if tail is not None else np.zeros((0,), np.float64)
        )
        self.err_units += 1 << lvl
        self._level_insert(lvl + 1, promoted)

    # ---- merge ------------------------------------------------------- #

    def merge(self, other: "NumericSummary") -> None:
        """Folds `other` into self. Exact mode is order-independent;
        sketch mode is deterministic for a fixed merge order."""
        if self.mode != other.mode or self.k != other.k:
            raise ValueError(
                f"cannot merge summaries of different configs: "
                f"({self.mode}, k={self.k}) vs "
                f"({other.mode}, k={other.k})"
            )
        self.count += other.count
        self.missing += other.missing
        self.min = min(self.min, other.min)
        self.max = max(self.max, other.max)
        self.sum_d = dyadic_add(self.sum_d, other.sum_d)
        self.sum_nonfinite = float(
            self.sum_nonfinite + other.sum_nonfinite
        )
        self.err_units += other.err_units
        if not other.spilled:
            self._absorb(other.values, other.counts)
        else:
            if not self.spilled:
                self._spill()
            for lvl, arr in enumerate(other.levels):
                if len(arr):
                    self._level_insert(lvl, arr)
            self._compact_all()

    # ---- finalization ------------------------------------------------ #

    def mean(self) -> float:
        """Column mean: exact sum / count, correctly rounded (0.0 for
        an empty column, matching the legacy total/max(count,1))."""
        if self.count == 0:
            return 0.0
        if self.sum_nonfinite != 0.0 or math.isnan(self.sum_nonfinite):
            return (
                dyadic_to_float(self.sum_d) + self.sum_nonfinite
            ) / self.count
        return dyadic_to_float(self.sum_d, self.count)

    def weighted_items(self) -> Tuple[np.ndarray, np.ndarray]:
        """(ascending unique float64 values, int64 weights) of the
        represented multiset — the input of
        Binner.boundaries_from_sketch. Exact mode: the true multiset;
        sketch mode: the compactor's weighted item set."""
        if not self.spilled:
            return self.values, self.counts
        vs, ws = [], []
        for lvl, arr in enumerate(self.levels):
            if len(arr):
                vs.append(arr)
                ws.append(np.full(len(arr), 1 << lvl, np.int64))
        if not vs:
            return (
                np.zeros((0,), np.float64), np.zeros((0,), np.int64)
            )
        v = np.concatenate(vs)
        w = np.concatenate(ws)
        nv, inv = np.unique(v, return_inverse=True)
        nw = np.zeros(len(nv), np.int64)
        np.add.at(nw, inv, w)
        return nv, nw

    def distinct_exact(self) -> bool:
        """True when the summary still holds the TRUE distinct-value
        multiset (always in exact mode; sketch mode until spill) — the
        precondition of the midpoint boundary path."""
        return not self.spilled

    def rank_error_bound(self) -> float:
        """Certified worst-case relative rank error of any quantile
        answered from this summary (0.0 while exact)."""
        return self.err_units / max(self.count, 1)

    def nbytes(self) -> int:
        n = self.values.nbytes + self.counts.nbytes
        for arr in self.levels:
            n += arr.nbytes
        return n + 128

    # ---- wire -------------------------------------------------------- #

    def to_wire(self) -> Dict[str, Any]:
        return {
            "mode": self.mode, "k": self.k, "count": self.count,
            "missing": self.missing, "min": self.min, "max": self.max,
            "sum_m": self.sum_d[0], "sum_e": self.sum_d[1],
            "sum_nonfinite": self.sum_nonfinite,
            "values": self.values, "counts": self.counts,
            "spilled": self.spilled, "levels": list(self.levels),
            "parity": list(self.parity), "err_units": self.err_units,
        }

    @staticmethod
    def from_wire(d: Dict[str, Any]) -> "NumericSummary":
        s = NumericSummary(mode=d["mode"], k=int(d["k"]))
        s.count = int(d["count"])
        s.missing = int(d["missing"])
        s.min = float(d["min"])
        s.max = float(d["max"])
        s.sum_d = _dyadic_norm(int(d["sum_m"]), int(d["sum_e"]))
        s.sum_nonfinite = float(d["sum_nonfinite"])
        s.values = np.asarray(d["values"], np.float64)
        s.counts = np.asarray(d["counts"], np.int64)
        s.spilled = bool(d["spilled"])
        s.levels = [np.asarray(a, np.float64) for a in d["levels"]]
        s.parity = [int(p) for p in d["parity"]]
        s.err_units = int(d["err_units"])
        return s


class IngestPartial:
    """The whole mergeable pass-1 state: column order, row count,
    per-column numeric summaries and categorical value counts. A build
    over several row ranges merges one partial a range in a fixed
    order; the cache build is the one-partial instance."""

    def __init__(self, mode: str = "exact", sketch_k: int = 4096):
        self.mode = mode
        self.sketch_k = int(sketch_k)
        self.col_order: List[str] = []
        self.num_rows = 0
        self.num: Dict[str, NumericSummary] = {}
        self.cat: Dict[str, Dict[str, int]] = {}
        self.cat_missing: Dict[str, int] = {}

    # ---- ingest ------------------------------------------------------ #

    def _count_categorical(self, name: str, vals: np.ndarray) -> None:
        cnt = self.cat.setdefault(name, {})
        if vals.dtype.kind in "fiu":
            # Numbers are keyed as Dataset.encoded_categorical and
            # infer_column key them: an integral value without its ".0"
            # (the JAX package keys vals.astype(str) here, so a float64
            # column of 0/1 from the CSV loader gets classes "0.0" /
            # "1.0" that encoding never finds; ROADMAP Queue 3).
            fv = vals.astype(np.float64)
            miss = np.isnan(fv)
            uniqf, c = np.unique(fv[~miss], return_counts=True)
            keys = np.array([str(int(v)) if v.is_integer() else str(v)
                             for v in uniqf.tolist()], dtype=str)
            order = np.argsort(keys, kind="stable")  # the text branch's
            uniq, c = keys[order].tolist(), c[order]
        else:
            sv = vals.astype(str)
            miss = (sv == "") | (sv == "nan")
            uniq, c = np.unique(sv[~miss], return_counts=True)
            uniq = uniq.tolist()
        self.cat_missing[name] = (
            self.cat_missing.get(name, 0) + int(miss.sum())
        )
        for u, k in zip(uniq, c.tolist()):
            cnt[u] = cnt.get(u, 0) + k

    def observe_chunk(
        self,
        chunk: Dict[str, np.ndarray],
        always_categorical: frozenset = frozenset(),
    ) -> None:
        """One row chunk of pass 1 — identical typing semantics to the
        legacy in-process loop: a numeric-dtype chunk feeds the numeric
        summary unless the column was already demoted to categorical;
        `always_categorical` carries the classification label and the
        uplift treatment (dictionary-encoded regardless of dtype)."""
        if not self.col_order:
            self.col_order = list(chunk.keys())
        self.num_rows += len(next(iter(chunk.values())))
        for name, vals in chunk.items():
            vals = np.asarray(vals)
            numeric_chunk = (
                vals.dtype.kind in "fiub"
                and name not in always_categorical
            )
            if numeric_chunk and name not in self.cat:
                self.num.setdefault(
                    name,
                    NumericSummary(mode=self.mode, k=self.sketch_k),
                ).update(vals.astype(np.float64))
            else:
                self._count_categorical(name, vals)

    def observe_recount(
        self, chunk: Dict[str, np.ndarray], cols: List[str]
    ) -> None:
        """The mixed-type second pass: categorical recount of `cols`
        only (a column numeric on some chunks, object on others)."""
        for name in cols:
            if name in chunk:
                self._count_categorical(name, np.asarray(chunk[name]))

    def mixed_columns(self) -> List[str]:
        """Columns that were inferred numeric on some chunks and
        categorical on others — they need a categorical recount."""
        return [
            n for n in self.col_order
            if n in self.num and n in self.cat
        ]

    def begin_recount(self, cols: List[str]) -> None:
        """Drops the partial stats of mixed `cols` ahead of the
        recount pass."""
        for name in cols:
            self.num.pop(name, None)
            self.cat[name] = {}
            self.cat_missing[name] = 0

    def apply_recount(
        self, recount: "IngestPartial", cols: List[str]
    ) -> None:
        """Adopts a merged recount partial's categorical counts for the
        mixed `cols` (a merge of several ranges' recounts)."""
        for name in cols:
            self.cat[name] = dict(recount.cat.get(name, {}))
            self.cat_missing[name] = recount.cat_missing.get(name, 0)

    # ---- merge ------------------------------------------------------- #

    def merge(self, other: "IngestPartial") -> None:
        if self.mode != other.mode or self.sketch_k != other.sketch_k:
            raise ValueError("cannot merge partials of different modes")
        if not self.col_order:
            self.col_order = list(other.col_order)
        elif other.col_order and other.col_order != self.col_order:
            raise ValueError(
                f"column order mismatch between partials: "
                f"{self.col_order} vs {other.col_order}"
            )
        self.num_rows += other.num_rows
        for name, s in other.num.items():
            if name in self.num:
                self.num[name].merge(s)
            else:
                mine = NumericSummary(mode=self.mode, k=self.sketch_k)
                mine.merge(s)
                self.num[name] = mine
        for name, cnt in other.cat.items():
            mine_c = self.cat.setdefault(name, {})
            for k, v in cnt.items():
                mine_c[k] = mine_c.get(k, 0) + v
        for name, m in other.cat_missing.items():
            self.cat_missing[name] = (
                self.cat_missing.get(name, 0) + m
            )

    def nbytes(self) -> int:
        n = 256
        for s in self.num.values():
            n += s.nbytes()
        for cnt in self.cat.values():
            n += sum(len(k) + 16 for k in cnt)
        return n

    # ---- wire -------------------------------------------------------- #

    def to_wire(self) -> Dict[str, Any]:
        return {
            "mode": self.mode, "sketch_k": self.sketch_k,
            "col_order": list(self.col_order),
            "num_rows": self.num_rows,
            "num": {n: s.to_wire() for n, s in self.num.items()},
            "cat": {n: dict(c) for n, c in self.cat.items()},
            "cat_missing": dict(self.cat_missing),
        }

    @staticmethod
    def from_wire(d: Dict[str, Any]) -> "IngestPartial":
        p = IngestPartial(mode=d["mode"], sketch_k=int(d["sketch_k"]))
        p.col_order = list(d["col_order"])
        p.num_rows = int(d["num_rows"])
        p.num = {
            n: NumericSummary.from_wire(s) for n, s in d["num"].items()
        }
        p.cat = {n: dict(c) for n, c in d["cat"].items()}
        p.cat_missing = dict(d["cat_missing"])
        return p
