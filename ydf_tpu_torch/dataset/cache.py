"""Out-of-core dataset cache: stream -> binned on disk -> train
(counterpart of ydf_tpu/dataset/cache.py).

A two-pass, chunked build that never holds the raw dataset whole:

  Pass 1  streams the input chunk by chunk into mergeable summaries
          (dataset/sketch.py: exact dyadic sums, exact or KLL-sketched
          quantile summaries, categorical value counts), then fits the
          dataspec and the Binner from them. Exact mode gives the same
          bytes for any chunking.
  Pass 2  bins every chunk through `Binner.transform` on the device (one
          launch of csrc/binning.cu a chunk on a card), makes the bins
          row-major there and copies them into the memmapped `bins.npy`,
          with the labels, weights, task columns, raw numericals and the
          feature- and row-shard files, all filled chunk-wise in this one
          pass.

The files, their bytes and `cache_meta.json` are the JAX package's, so
either package opens the other's cache. Training memmaps the cache and
copies the u8 bins to the device once.

    cache = create_dataset_cache("csv:/data/part-*.csv", "/cache",
                                 label="income")
    model = GradientBoostedTreesLearner(label="income").train(cache)

CSV files go whole through the port's loader (dataset/native_csv.py) and
are cut into chunks of `chunk_rows`, file by file: the JAX package's
branch without pandas. The build keeps the JAX package's counters,
failpoints and memory-ledger source (utils/telemetry.py,
utils/failpoints.py). Not ported here: the distributed build's planner
and workers (ROADMAP item 18).
"""

from __future__ import annotations

import hashlib
import json
import os
import time
import warnings
import weakref
import zlib
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

from ydf_tpu_torch.config import Task, resolve_num_bins
from ydf_tpu_torch.dataset.binning import Binner
from ydf_tpu_torch.dataset.dataset import (
    Dataset,
    _read_csv,
    _resolve_typed_path,
    _split_typed_path,
)
from ydf_tpu_torch.dataset.dataspec import (
    OOV_ITEM,
    Column,
    ColumnType,
    DataSpecification,
)
from ydf_tpu_torch.dataset.sketch import IngestPartial, NumericSummary
from ydf_tpu_torch.utils import failpoints, telemetry
from ydf_tpu_torch.utils.snapshot import _durable_replace

#: Cache format version, part of every request fingerprint (the JAX
#: package's: v2 is the sketch-based pass 1).
_CACHE_FORMAT = 2

#: Boundary-inference modes of pass 1: "exact" keeps every column's
#: exact weighted multiset (order-independent; memory O(distinct
#: values)), "sketch" the KLL compactor (memory O(sketch_k log n)).
_BOUNDARY_MODES = ("exact", "sketch")


def _iter_chunks(files: List[str], chunk_rows: int
                 ) -> Iterator[Dict[str, np.ndarray]]:
    """Row chunks of at most chunk_rows rows, file by file: each file
    read whole by the CSV loader, then sliced."""
    for f in files:
        cols = _read_csv(f)
        n = len(next(iter(cols.values())))
        for s in range(0, n, chunk_rows):
            yield {k: v[s: s + chunk_rows] for k, v in cols.items()}


def _always_categorical(label: str, task: Task,
                        uplift_treatment: Optional[str]) -> frozenset:
    """Columns dictionary-encoded whatever their dtype: the
    classification label and the uplift treatment."""
    names = set()
    if task == Task.CLASSIFICATION:
        names.add(label)
    if uplift_treatment is not None:
        names.add(uplift_treatment)
    return frozenset(names)


def _column_from_summary(name: str, s: NumericSummary) -> Column:
    return Column(
        name=name, type=ColumnType.NUMERICAL, mean=s.mean(),
        min_value=float(s.min) if s.count else 0.0,
        max_value=float(s.max) if s.count else 0.0,
        num_values=s.count, num_missing=s.missing,
    )


def _spec_from_partial(partial: IngestPartial, label: str,
                       ranking_group: Optional[str],
                       uplift_treatment: Optional[str],
                       max_vocab_count: int,
                       min_vocab_frequency: int) -> DataSpecification:
    """The cache's dataspec from the merged pass-1 partial: numerical
    columns from their summaries, dictionaries frequency-sorted and
    pruned (never the label's, the group's or the treatment's)."""
    no_prune = {label, ranking_group, uplift_treatment} - {None}
    cols: List[Column] = []
    for name in partial.col_order:
        if name in partial.num:
            cols.append(_column_from_summary(name, partial.num[name]))
            continue
        cnt = partial.cat[name]
        minf = 1 if name in no_prune else min_vocab_frequency
        items = sorted(cnt.items(), key=lambda kv: (-kv[1], kv[0]))
        kept = [(k, v) for k, v in items if v >= max(minf, 1)]
        if name not in no_prune and max_vocab_count > 0:
            kept = kept[:max_vocab_count]
        oov = sum(cnt.values()) - sum(v for _, v in kept)
        cols.append(Column(
            name=name, type=ColumnType.CATEGORICAL,
            vocabulary=[OOV_ITEM] + [k for k, _ in kept],
            vocab_counts=[oov] + [v for _, v in kept],
            num_values=sum(cnt.values()),
            num_missing=partial.cat_missing.get(name, 0),
        ))
    return DataSpecification(columns=cols, created_num_rows=partial.num_rows)


def _default_feature_names(spec: DataSpecification, label: str,
                           weights: Optional[str],
                           extra_cols: List[str]) -> List[str]:
    return [c.name for c in spec.columns
            if c.name not in ({label, weights} | set(extra_cols))
            and c.type in (ColumnType.NUMERICAL, ColumnType.BOOLEAN,
                           ColumnType.CATEGORICAL)]


def _fit_binner_from_partial(spec: DataSpecification,
                             feature_names: List[str], num_bins,
                             partial: IngestPartial) -> Binner:
    """The Binner from the merged partial; "auto" bins resolve against
    the true row count with the in-memory rule (the categorical
    dictionaries' floor included)."""
    max_vocab = max(
        (spec.column_by_name(f).vocab_size for f in feature_names
         if spec.column_by_name(f).type == ColumnType.CATEGORICAL),
        default=0,
    )
    nb = resolve_num_bins(num_bins, partial.num_rows, min_cat_vocab=max_vocab)
    summaries = {
        f: partial.num.get(f)
        or NumericSummary(mode=partial.mode, k=partial.sketch_k)
        for f in feature_names
    }
    return Binner.fit_from_summaries(spec, feature_names, nb, summaries)


class CacheCorruptionError(RuntimeError):
    """The cache failed an integrity check (a truncated file, a crc
    mismatch, unreadable metadata). Recreate it:
    `create_dataset_cache(..., reuse=True)` rebuilds it."""


# Every data file's byte size and a crc32 (zlib) per 4 MiB block, in
# cache_meta.json's "integrity" key: verification streams, and a
# mismatch names its block.
_CRC_BLOCK = 4 << 20


def _file_integrity(path: str) -> Dict[str, object]:
    crcs: List[int] = []
    size = 0
    with open(path, "rb") as f:
        while True:
            b = f.read(_CRC_BLOCK)
            if not b:
                break
            size += len(b)
            crcs.append(zlib.crc32(b))
    return {"size": size, "crc32": crcs}


def _verify_file(path: str, rec: Dict[str, object], full: bool) -> None:
    name = os.path.basename(path)
    if not os.path.isfile(path):
        raise CacheCorruptionError(f"cache file {name!r} is missing")
    size = os.path.getsize(path)
    if size != rec["size"]:
        raise CacheCorruptionError(
            f"cache file {name!r} is {size} bytes, expected {rec['size']} "
            "(truncated or partially written)")
    if not full:
        return
    with open(path, "rb") as f:
        for i, want in enumerate(rec["crc32"]):
            if zlib.crc32(f.read(_CRC_BLOCK)) != want:
                raise CacheCorruptionError(
                    f"cache file {name!r} fails its checksum at block {i} "
                    f"(byte offset {i * _CRC_BLOCK}): the cache is "
                    "corrupt; recreate it (create_dataset_cache with "
                    "reuse=True rebuilds automatically)")


def _write_meta(cache_dir: str, meta: Dict) -> None:
    meta_path = os.path.join(cache_dir, "cache_meta.json")
    tmp = meta_path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(meta, f)
    _durable_replace(tmp, meta_path)


def _try_reuse_cache(cache_dir: str, request_fp: str
                     ) -> Optional["DatasetCache"]:
    """reuse=True: a fully verified cache of the same request is
    returned; anything else gives None, and a corrupt cache's metadata
    is removed first, so a crash mid-rebuild never leaves it half
    valid."""
    meta_path = os.path.join(cache_dir, "cache_meta.json")
    if not os.path.isfile(meta_path):
        return None
    try:
        cache = DatasetCache(cache_dir, verify="full")
    except CacheCorruptionError as e:
        if telemetry.ENABLED:
            telemetry.counter("ydf_cache_rebuild_total").inc()
        warnings.warn(
            f"existing dataset cache in {cache_dir!r} failed integrity "
            f"verification ({e}); rebuilding it", RuntimeWarning,
            stacklevel=3)
        try:
            os.remove(meta_path)
        except OSError:
            pass
        return None
    if cache._meta.get("request_fingerprint") != request_fp:
        return None  # same directory, another request: rebuild
    return cache


_VERIFY_MODES = ("off", "size", "full")


def _resolve_verify(verify: Optional[str]) -> str:
    """Open-time verification: the argument, else YDF_TPU_CACHE_VERIFY
    (the JAX package's variable), else "size"."""
    if verify is None:
        verify = (os.environ.get("YDF_TPU_CACHE_VERIFY", "").strip().lower()
                  or "size")
    if verify not in _VERIFY_MODES:
        raise ValueError(
            f"cache verify mode {verify!r} is not one of "
            f"{list(_VERIFY_MODES)} (from YDF_TPU_CACHE_VERIFY or the "
            "verify= argument)")
    return verify


def shard_col_ranges(num_scalar: int, num_shards: int) -> List[tuple]:
    """Contiguous feature-column ranges [(lo, hi), ...] of a
    num_shards-way feature sharding (np.array_split sizes)."""
    if num_shards < 1:
        raise ValueError(f"feature_shards must be >= 1, got {num_shards}")
    if num_shards > max(num_scalar, 1):
        raise ValueError(
            f"feature_shards={num_shards} exceeds the {num_scalar} scalar "
            "feature columns; each shard needs at least one")
    edges = np.linspace(0, num_scalar, num_shards + 1).astype(np.int64)
    return [(int(edges[k]), int(edges[k + 1])) for k in range(num_shards)]


def row_shard_ranges(num_rows: int, num_shards: int) -> List[tuple]:
    """Contiguous row ranges [(lo, hi), ...] of a num_shards-way row
    sharding."""
    if num_shards < 1:
        raise ValueError(f"row_shards must be >= 1, got {num_shards}")
    if num_shards > max(num_rows, 1):
        raise ValueError(
            f"row_shards={num_shards} exceeds the {num_rows} rows; each "
            "shard needs at least one")
    edges = np.linspace(0, num_rows, num_shards + 1).astype(np.int64)
    return [(int(edges[k]), int(edges[k + 1])) for k in range(num_shards)]


def _shard_file(k: int) -> str:
    return f"bins_shard_{k}.npy"


def _row_shard_file(k: int) -> str:
    return f"bins_rows_{k}.npy"


# Open cache handles for the memory ledger's "dataset_cache" pull source,
# sampled only at ledger snapshots.
_OPEN_CACHES: "weakref.WeakSet" = weakref.WeakSet()


def open_cache_bytes_total() -> int:
    """The on-disk bytes of every open cache (DatasetCache.resident_bytes)."""
    return sum(c.resident_bytes() for c in list(_OPEN_CACHES))


telemetry.register_mem_source("dataset_cache", open_cache_bytes_total)


class DatasetCache:
    """Handle to a cache directory; the learners train from it.

    Opening checks the data files against the integrity records
    (`verify=`: "size" catches truncation, "full" also streams the crc32
    blocks, "off" trusts the files)."""

    def __init__(self, path: str, verify: Optional[str] = None):
        self.path = path
        verify = _resolve_verify(verify)
        meta_path = os.path.join(path, "cache_meta.json")
        if not os.path.isfile(meta_path):
            raise CacheCorruptionError(
                f"{path!r} has no cache_meta.json: not a dataset cache, or "
                "its creation crashed before the metadata publish")
        try:
            with open(meta_path) as f:
                meta = json.load(f)
        except (OSError, ValueError) as e:
            raise CacheCorruptionError(
                f"cache metadata in {path!r} is unreadable "
                f"({type(e).__name__}: {e})") from e
        self.dataspec = DataSpecification.from_json(meta["dataspec"])
        self.binner = Binner.from_json(meta["binner"])
        self.num_rows = int(meta["num_rows"])
        self.label = meta["label"]
        self.weights = meta.get("weights")
        #: Task columns stored beside the bins (ranking groups, uplift
        #: treatment, survival event and entry age).
        self.extra_columns: List[str] = list(meta.get("extra_columns", []))
        #: Feature shards (0 = none): shard k holds bins[:, lo:hi].
        self.feature_shards: int = int(meta.get("feature_shards", 0))
        #: Row shards (0 = none): shard k holds bins[lo:hi, :].
        self.row_shards: int = int(meta.get("row_shards", 0))
        self._meta = meta
        #: Host seconds of the build that made this handle ("pass1_s",
        #: "recount_s", "fit_s", "pass2_s", "bin_s": the device binning
        #: inside pass 2, "publish_s") and its chunks' rows; empty for a
        #: cache opened or reused.
        self.build_timings: Dict[str, object] = {}
        if verify != "off":
            self.verify(full=(verify == "full"))
        _OPEN_CACHES.add(self)  # the memory ledger's "dataset_cache"

    def resident_bytes(self) -> int:
        """On-disk bytes of this cache's data files (the memmapped
        footprint the memory ledger's "dataset_cache" row reports; 0 when
        the directory cannot be read)."""
        total = 0
        try:
            for name in os.listdir(self.path):
                if name.endswith(".npy"):
                    try:
                        total += os.path.getsize(os.path.join(self.path,
                                                              name))
                    except OSError:
                        continue
        except OSError:
            return 0
        return int(total)

    def verify(self, full: bool = True) -> None:
        """Every data file against its integrity record; raises
        CacheCorruptionError at the first mismatch. full=False checks
        sizes only."""
        integrity = self._meta.get("integrity")
        if not integrity:
            return
        if telemetry.ENABLED:
            telemetry.counter("ydf_cache_verify_total",
                              mode="full" if full else "size").inc()
        try:
            for name, rec in integrity["files"].items():
                _verify_file(os.path.join(self.path, name), rec, full)
        except CacheCorruptionError:
            if telemetry.ENABLED:
                telemetry.counter("ydf_cache_corruption_total").inc()
            raise

    def _record(self, name: str) -> Optional[Dict]:
        return (self._meta.get("integrity") or {}).get("files", {}).get(name)

    @property
    def bins(self) -> np.ndarray:
        """u8 [n, F] row-major, memmapped."""
        return np.load(os.path.join(self.path, "bins.npy"), mmap_mode="r")

    def shard_col_range(self, k: int) -> tuple:
        """(lo, hi) feature columns of shard k."""
        return shard_col_ranges(self.binner.num_scalar,
                                self._require_shards())[k]

    def shard_bins(self, k: int, verify: Optional[bool] = None
                   ) -> np.ndarray:
        """u8 [n, Fk] memmap of shard k; verify=True checks the shard's
        crc blocks first."""
        self._require_shards()
        name = _shard_file(k)
        rec = self._record(name)
        if verify and rec is not None:
            _verify_file(os.path.join(self.path, name), rec, full=True)
        return np.load(os.path.join(self.path, name), mmap_mode="r")

    def _require_shards(self) -> int:
        if self.feature_shards < 1:
            raise ValueError(
                f"dataset cache {self.path!r} was created without feature "
                "shards; recreate it with create_dataset_cache(..., "
                "feature_shards=N)")
        return self.feature_shards

    def _require_row_shards(self) -> int:
        if self.row_shards < 1:
            raise ValueError(
                f"dataset cache {self.path!r} was created without row "
                "shards; recreate it with create_dataset_cache(..., "
                "row_shards=N)")
        return self.row_shards

    def row_shard_range(self, k: int) -> tuple:
        """(lo, hi) rows of row shard k."""
        return row_shard_ranges(self.num_rows, self._require_row_shards())[k]

    def load_row_shard_streamed(self, k: int,
                                col_range: Optional[tuple] = None,
                                verify: bool = True) -> np.ndarray:
        """Row shard k read once, sequentially, in crc-block chunks, each
        block's crc32 checked as its bytes are consumed; only the
        columns of `col_range` (lo, hi) are kept. The transient memory
        is one block."""
        self._require_row_shards()
        lo, hi = self.row_shard_range(k)
        n_k = hi - lo
        name = _row_shard_file(k)
        path = os.path.join(self.path, name)
        rec = self._record(name)
        if not os.path.isfile(path):
            raise CacheCorruptionError(f"row shard file {name!r} is missing")
        if rec is not None and os.path.getsize(path) != rec["size"]:
            raise CacheCorruptionError(
                f"row shard file {name!r} is {os.path.getsize(path)} bytes, "
                f"expected {rec['size']} (truncated)")
        F = self.binner.num_scalar
        clo, chi = (0, F) if col_range is None else col_range
        out = np.empty((n_k, chi - clo), np.uint8)
        with open(path, "rb") as f:
            carry = b""
            header_skipped = False
            row = block_idx = 0
            while True:
                block = f.read(_CRC_BLOCK)
                if not block:
                    break
                if verify and rec is not None:
                    crcs = rec["crc32"]
                    if block_idx >= len(crcs) or (
                            zlib.crc32(block) != crcs[block_idx]):
                        raise CacheCorruptionError(
                            f"row shard {name!r} fails its checksum at "
                            f"block {block_idx} (byte offset "
                            f"{block_idx * _CRC_BLOCK}); rebuild it from "
                            "bins.npy (DatasetCache.rebuild_row_shard)")
                block_idx += 1
                buf = carry + block if carry else block
                if not header_skipped:
                    # The npy header (magic, version, little-endian header
                    # length); the first 4 MiB block holds all of it.
                    if len(buf) < 10:
                        carry = buf
                        continue
                    if buf[6] >= 2:
                        data_off = 12 + int.from_bytes(buf[8:12], "little")
                    else:
                        data_off = 10 + int.from_bytes(buf[8:10], "little")
                    buf = buf[data_off:]
                    header_skipped = True
                nrows = min(len(buf) // F, n_k - row)
                if nrows > 0:
                    chunk = np.frombuffer(buf[: nrows * F], np.uint8
                                          ).reshape(nrows, F)
                    out[row: row + nrows] = chunk[:, clo:chi]
                    row += nrows
                carry = buf[nrows * F:]
        if row != n_k:
            raise CacheCorruptionError(
                f"row shard {name!r} yielded {row} rows, expected {n_k}")
        return out

    def _rebuild(self, name: str, shape: tuple, copy) -> None:
        """Rewrites one shard file from the verified bins.npy (the same
        bytes as at creation) and republishes the metadata."""
        rec = self._record("bins.npy")
        if rec is not None:
            _verify_file(os.path.join(self.path, "bins.npy"), rec, full=True)
        path = os.path.join(self.path, name)
        out = np.lib.format.open_memmap(path, mode="w+", dtype=np.uint8,
                                        shape=shape)
        copy(self.bins, out)
        out.flush()
        del out
        integ = self._meta.setdefault("integrity", {"files": {}})
        integ["files"][name] = _file_integrity(path)
        if telemetry.ENABLED:
            telemetry.counter("ydf_cache_shard_rebuilds_total").inc()
        _write_meta(self.path, self._meta)

    def rebuild_row_shard(self, k: int) -> None:
        """Re-slices row shard k from bins.npy."""
        self._require_row_shards()
        lo, hi = self.row_shard_range(k)

        def copy(full, out):
            step = max(1, (64 << 20) // max(full.shape[1], 1))
            for r in range(lo, hi, step):
                out[r - lo: min(r + step, hi) - lo] = full[
                    r: min(r + step, hi)]

        self._rebuild(_row_shard_file(k), (hi - lo, self.binner.num_scalar),
                      copy)

    def rebuild_feature_shard(self, k: int) -> None:
        """Re-slices feature shard k from bins.npy."""
        self._require_shards()
        lo, hi = self.shard_col_range(k)

        def copy(full, out):
            step = max(1, (64 << 20) // max(hi - lo, 1))
            for r in range(0, full.shape[0], step):
                out[r: r + step] = full[r: r + step, lo:hi]

        self._rebuild(_shard_file(k), (self.num_rows, hi - lo), copy)

    @property
    def labels(self) -> np.ndarray:
        return np.load(os.path.join(self.path, "labels.npy"), mmap_mode="r")

    @property
    def sample_weights(self) -> Optional[np.ndarray]:
        p = os.path.join(self.path, "weights.npy")
        return np.load(p, mmap_mode="r") if os.path.exists(p) else None

    @property
    def raw_numerical(self) -> Optional[np.ndarray]:
        """f32 [n, num_numerical] imputed raw feature values (memmapped)
        when the cache was created with store_raw_numerical=True; oblique
        training from a cache needs them."""
        p = os.path.join(self.path, "raw_numerical.npy")
        return np.load(p, mmap_mode="r") if os.path.exists(p) else None

    def extra_column(self, name: str) -> np.ndarray:
        """One stored task column: a categorical one as its values
        (through the dictionary), a numerical one as float64."""
        p = os.path.join(self.path, f"col_{name}.npy")
        if not os.path.exists(p):
            raise KeyError(
                f"Column {name!r} was not stored in the cache; recreate it "
                f"with the column listed (extra columns: "
                f"{self.extra_columns})")
        vals = np.load(p, mmap_mode="r")
        col = self.dataspec.column_by_name(name)
        if col.type == ColumnType.CATEGORICAL:
            return np.asarray(col.vocabulary, object)[np.asarray(vals)]
        return np.asarray(vals)

    def label_classes(self) -> Optional[List[str]]:
        col = self.dataspec.column_by_name(self.label)
        if col.type != ColumnType.CATEGORICAL:
            return None
        return list(col.vocabulary[1:])  # without OOV, as Dataset


class _CacheWriters:
    """Pass 2's write surface: the bins, labels, weights, task-column and
    raw memmaps and every feature- and row-shard file, created up front
    and filled chunk by chunk."""

    def __init__(self, cache_dir: str, spec: DataSpecification,
                 binner: Binner, num_rows: int, label: str,
                 weights: Optional[str], extra_cols: List[str],
                 store_raw: bool, feature_shards: int, row_shards: int,
                 device: torch.device):
        self.spec = spec
        self.binner = binner
        self.num_rows = int(num_rows)
        self.label = label
        self.weights = weights
        self.extra_cols = list(extra_cols)
        self.device = device
        self.F = binner.num_scalar
        #: Host seconds of the device binning (transform, the row-major
        #: copy on the device and the copy back) summed over the chunks.
        self.bin_seconds = 0.0

        def mm(name, dtype, shape):
            return np.lib.format.open_memmap(
                os.path.join(cache_dir, name), mode="w+", dtype=dtype,
                shape=shape)

        self.bins = mm("bins.npy", np.uint8, (self.num_rows, self.F))
        categorical = spec.column_by_name(label).type == ColumnType.CATEGORICAL
        self.label_task = Task.CLASSIFICATION if categorical \
            else Task.REGRESSION
        self.labels = mm("labels.npy",
                         np.int32 if categorical else np.float32,
                         (self.num_rows,))
        self.weights_mm = (mm("weights.npy", np.float32, (self.num_rows,))
                           if weights is not None else None)
        self.extra: Dict[str, np.ndarray] = {}
        for name in self.extra_cols:
            dt = (np.int32 if spec.column_by_name(name).type
                  == ColumnType.CATEGORICAL else np.float64)
            self.extra[name] = mm(f"col_{name}.npy", dt, (self.num_rows,))
        self.raw = None
        if store_raw and binner.num_numerical > 0:
            self.raw = mm("raw_numerical.npy", np.float32,
                          (self.num_rows, binner.num_numerical))
        self.col_ranges = (shard_col_ranges(self.F, int(feature_shards))
                           if feature_shards else [])
        self.row_ranges = (row_shard_ranges(self.num_rows, int(row_shards))
                           if row_shards else [])
        self.shard_mms = [mm(_shard_file(k), np.uint8, (self.num_rows, hi - lo))
                          for k, (lo, hi) in enumerate(self.col_ranges)]
        self.row_mms = [mm(_row_shard_file(k), np.uint8, (hi - lo, self.F))
                        for k, (lo, hi) in enumerate(self.row_ranges)]

    def data_files(self) -> List[str]:
        out = ["bins.npy", "labels.npy"]
        if self.weights_mm is not None:
            out.append("weights.npy")
        out += [f"col_{name}.npy" for name in self.extra_cols]
        if self.raw is not None:
            out.append("raw_numerical.npy")
        out += [_shard_file(k) for k in range(len(self.col_ranges))]
        out += [_row_shard_file(k) for k in range(len(self.row_ranges))]
        return out

    def bin_chunk(self, ds: Dataset) -> np.ndarray:
        """The chunk's u8 bins [k, F] row-major on the host: binned on
        the device (the feature-major result made row-major there), then
        copied back."""
        t0 = time.perf_counter()
        bins = self.binner.transform(ds, self.device).contiguous().cpu()
        self.bin_seconds += time.perf_counter() - t0
        return bins.numpy()

    def write_chunk(self, row: int, chunk: Dict[str, np.ndarray]) -> None:
        """Bins one chunk into rows [row, row + k) of every file (the
        failpoint site cache.write_chunk first)."""
        failpoints.hit("cache.write_chunk")
        ds = Dataset(chunk, self.spec)
        k = ds.num_rows
        cb = self.bin_chunk(ds)
        self.bins[row: row + k] = cb
        self.labels[row: row + k] = np.asarray(
            ds.encoded_label(self.label, self.label_task), self.labels.dtype)
        if self.weights_mm is not None:
            self.weights_mm[row: row + k] = np.asarray(chunk[self.weights],
                                                       np.float32)
        for name, mm in self.extra.items():
            if mm.dtype == np.int32:
                mm[row: row + k] = np.asarray(ds.encoded_categorical(name),
                                              np.int32)
            else:
                mm[row: row + k] = np.asarray(chunk[name], np.float64)
        if self.raw is not None:
            Fn = self.binner.num_numerical
            rb = np.empty((k, Fn), np.float32)
            for i, fname in enumerate(self.binner.feature_names[:Fn]):
                rb[:, i] = (ds.encoded_numerical(fname) if fname in ds.data
                            else self.binner.impute_values[i])
            self.raw[row: row + k] = rb
        for s, (lo, hi) in enumerate(self.col_ranges):
            self.shard_mms[s][row: row + k] = cb[:, lo:hi]
        for s, (lo, hi) in enumerate(self.row_ranges):
            olo, ohi = max(lo, row), min(hi, row + k)
            if olo < ohi:
                self.row_mms[s][olo - lo: ohi - lo] = cb[olo - row: ohi - row]

    def close(self) -> None:
        for mm in ([self.bins, self.labels]
                   + ([self.weights_mm] if self.weights_mm is not None
                      else [])
                   + list(self.extra.values())
                   + ([self.raw] if self.raw is not None else [])
                   + self.shard_mms + self.row_mms):
            mm.flush()
        self.bins = self.labels = self.weights_mm = self.raw = None
        self.extra = {}
        self.shard_mms = []
        self.row_mms = []


def _request_fingerprint(files: List[str], label: str, task: Task, weights,
                         features, num_bins, chunk_rows: int,
                         max_vocab_count: int, min_vocab_frequency: int,
                         ranking_group, uplift_treatment,
                         label_event_observed, label_entry_age,
                         store_raw_numerical: bool, feature_shards: int,
                         row_shards: int, boundaries: str,
                         sketch_k: int) -> str:
    """reuse=True's identity of a build (the JAX package's formula):
    each source file's name, size and mtime, the requested
    configuration, the shard layout and the format version."""
    src = sorted((os.path.basename(p), os.path.getsize(p),
                  os.stat(p).st_mtime_ns) for p in files)
    return hashlib.sha1(repr((
        _CACHE_FORMAT, src, label, task.value, weights, features,
        num_bins, chunk_rows, max_vocab_count, min_vocab_frequency,
        ranking_group, uplift_treatment, label_event_observed,
        label_entry_age, store_raw_numerical,
        ("shards", int(feature_shards), int(row_shards)),
        boundaries, sketch_k if boundaries == "sketch" else None,
    )).encode()).hexdigest()


def _publish_meta(cache_dir: str, spec: DataSpecification, binner: Binner,
                  num_rows: int, label: str, weights: Optional[str],
                  extra_cols: List[str], store_raw: bool,
                  feature_shards: int, row_shards: int, source: str,
                  request_fp: Optional[str], boundaries: str,
                  data_files: List[str]) -> DatasetCache:
    """The integrity records and the metadata, written last (fsync before
    rename): a crash anywhere earlier leaves a cache that fails to open,
    never one that trains on half-written files."""
    meta = {
        "dataspec": spec.to_json(),
        "binner": binner.to_json(),
        "num_rows": num_rows,
        "label": label,
        "weights": weights,
        "extra_columns": extra_cols,
        "store_raw_numerical": bool(store_raw),
        "feature_shards": int(feature_shards),
        "row_shards": int(row_shards),
        "source": source,
        "integrity": {
            "algo": "crc32",
            "block_bytes": _CRC_BLOCK,
            "files": {name: _file_integrity(os.path.join(cache_dir, name))
                      for name in data_files},
        },
        "request_fingerprint": request_fp,
        "boundaries": boundaries,
    }
    if telemetry.ENABLED:
        telemetry.counter("ydf_cache_builds_total").inc()
        telemetry.counter("ydf_cache_bytes_written_total").inc(
            sum(rec["size"] for rec in meta["integrity"]["files"].values()))
    failpoints.hit("cache.finalize")
    _write_meta(cache_dir, meta)
    return DatasetCache(cache_dir)


def create_dataset_cache(
    data_path,
    cache_dir: str,
    label: str,
    task: Task = Task.CLASSIFICATION,
    weights: Optional[str] = None,
    features: Optional[List[str]] = None,
    num_bins="auto",
    chunk_rows: int = 500_000,
    max_vocab_count: int = 2000,
    min_vocab_frequency: int = 5,
    ranking_group: Optional[str] = None,
    uplift_treatment: Optional[str] = None,
    label_event_observed: Optional[str] = None,
    label_entry_age: Optional[str] = None,
    store_raw_numerical: bool = False,
    reuse: bool = False,
    feature_shards: int = 0,
    row_shards: int = 0,
    boundaries: str = "exact",
    sketch_k: int = 4096,
    device=None,
) -> DatasetCache:
    """Builds an on-disk binned cache from (sharded) CSV files, or from
    an in-memory frame (a pandas or polars DataFrame or a dict of
    arrays) streamed chunk by chunk (the JAX package's
    create_dataset_cache). Pass 2 bins on `device` (None: the card;
    "cpu" runs the binning kernel's plain version).

    ranking_group / uplift_treatment / label_event_observed /
    label_entry_age are stored beside the bins for the ranking, uplift
    and survival tasks; store_raw_numerical=True also stores the imputed
    f32 feature matrix, which oblique training needs. reuse=True returns
    an existing cache of the same request (files by name, size and
    mtime; the configuration) that passes a full verification, and
    rebuilds anything else; a frame always rebuilds. feature_shards=N
    and row_shards=N also write N column slices bins_shard_k.npy or N
    row slices bins_rows_k.npy. boundaries="exact" keeps exact
    multisets, "sketch" the KLL compactor of sketch_k items a level."""
    from ydf_tpu_torch.models.io import resolve_device

    dev = resolve_device(device)
    if isinstance(data_path, str):
        fmt, _ = _split_typed_path(data_path)
        if fmt != "csv":
            raise NotImplementedError(
                f"create_dataset_cache streams CSV input only (got {fmt!r}); "
                "convert other formats to CSV first")
        files = _resolve_typed_path(data_path)
    else:
        files = None
    feature_shards = int(feature_shards)
    if feature_shards < 0:
        raise ValueError(f"feature_shards must be >= 0, got {feature_shards}")
    row_shards = int(row_shards)
    if row_shards < 0:
        raise ValueError(f"row_shards must be >= 0, got {row_shards}")
    if boundaries not in _BOUNDARY_MODES:
        raise ValueError(
            f"boundaries mode {boundaries!r} is not one of "
            f"{list(_BOUNDARY_MODES)}")
    os.makedirs(cache_dir, exist_ok=True)

    request_fp = None
    if files is not None:
        request_fp = _request_fingerprint(
            files, label, task, weights, features, num_bins, chunk_rows,
            max_vocab_count, min_vocab_frequency, ranking_group,
            uplift_treatment, label_event_observed, label_entry_age,
            store_raw_numerical, feature_shards, row_shards, boundaries,
            sketch_k)
    if reuse and request_fp is not None:
        existing = _try_reuse_cache(cache_dir, request_fp)
        if existing is not None:
            return existing

    def chunks():
        if files is None:
            from ydf_tpu_torch.dataset.frame_io import iter_frame_chunks

            return iter_frame_chunks(data_path, chunk_rows)
        return _iter_chunks(files, chunk_rows)

    extra_cols = [c for c in (ranking_group, uplift_treatment,
                              label_event_observed, label_entry_age)
                  if c is not None]
    walls: Dict[str, object] = {}

    # Pass 1: the mergeable statistics.
    t0 = time.perf_counter()
    partial = IngestPartial(mode=boundaries, sketch_k=sketch_k)
    always_cat = _always_categorical(label, task, uplift_treatment)
    chunk_sizes = []
    for chunk in chunks():
        partial.observe_chunk(chunk, always_cat)
        chunk_sizes.append(len(next(iter(chunk.values()))))
    walls["pass1_s"] = time.perf_counter() - t0
    # A column numeric in some chunks and text in others (possible across
    # files) is categorical: its statistics are dropped and recounted as
    # text, or pass 2 would read its numbers as missing.
    t0 = time.perf_counter()
    mixed = partial.mixed_columns()
    if mixed:
        partial.begin_recount(mixed)
        for chunk in chunks():
            partial.observe_recount(chunk, mixed)
    walls["recount_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    num_rows = partial.num_rows
    spec = _spec_from_partial(partial, label, ranking_group,
                              uplift_treatment, max_vocab_count,
                              min_vocab_frequency)
    feature_names = features or _default_feature_names(
        spec, label, weights, extra_cols)
    binner = _fit_binner_from_partial(spec, feature_names, num_bins, partial)
    walls["fit_s"] = time.perf_counter() - t0

    # Pass 2: bin each chunk on the device into the memmaps.
    t0 = time.perf_counter()
    writers = _CacheWriters(cache_dir, spec, binner, num_rows, label,
                            weights, extra_cols, store_raw_numerical,
                            feature_shards, row_shards, dev)
    row = 0
    for chunk in chunks():
        writers.write_chunk(row, chunk)
        row += len(next(iter(chunk.values())))
    data_files = writers.data_files()
    writers.close()
    walls["pass2_s"] = time.perf_counter() - t0
    walls["bin_s"] = writers.bin_seconds

    t0 = time.perf_counter()
    cache = _publish_meta(
        cache_dir, spec, binner, num_rows, label, weights, extra_cols,
        store_raw_numerical and binner.num_numerical > 0, feature_shards,
        row_shards,
        data_path if isinstance(data_path, str) else "<in-memory frame>",
        request_fp, boundaries, data_files)
    walls["publish_s"] = time.perf_counter() - t0
    walls["chunk_rows"] = chunk_sizes
    cache.build_timings = walls
    return cache
