"""Reader and writer of the reference YDF serialized-model directory
format (counterpart of ydf_tpu/models/ydf_format.py: load_ydf_model,
export_ydf_model and their helpers, on the port's models).

A YDF model directory (reference `model_library.cc` SaveModel/LoadModel)
contains:
  header.pb                     AbstractModel proto (abstract_model.proto:66)
  data_spec.pb                  DataSpecification (data_spec.proto:49)
  <type>_header.pb              per-model header (e.g. gradient_boosted_trees.proto:24)
  nodes-%05d-of-%05d            sharded node records, preorder per tree
  done                          marker file

Node shards are blob sequences (`utils/blob_sequence.h:125-149`): an 8-byte
file header {magic 'BS', uint16 LE version, uint8 compression, reserved},
then uint32-LE length-prefixed records (gzip-wrapped when compression=1).
Each record is a decision_tree.proto:202 Node. Trees are serialized
depth-first, NEGATIVE child before POSITIVE child
(`model/decision_tree/decision_tree.cc:580-599`); a node is a leaf iff it
has no condition submessage.

Everything here is a clean-room decode of those file-format facts via the
schema-less wire reader in utils/protowire.py — no reference code or
protoc output is used. Field numbers are cited inline.

The decoding and encoding run on the host in numpy with the JAX
package's expressions: an imported model's arrays, and so its
predictions, equal the JAX package's bit for bit, and an export writes
the same bytes. The imported model routes missing values natively
(`native_missing`) and so serves on the routed engine, as in the JAX
package; its forest moves to the requested device once, at the end.
"""

from __future__ import annotations

import gzip
import os
import struct
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from ydf_tpu_torch.config import Task
from ydf_tpu_torch.dataset.binning import NUMERICAL_LIKE, Binner
from ydf_tpu_torch.dataset.dataspec import (
    Column,
    ColumnType,
    DataSpecification,
    OOV_ITEM,
)
from ydf_tpu_torch.models.forest import Forest
from ydf_tpu_torch.utils import protowire as pw

# --------------------------------------------------------------------- #
# Blob sequence
# --------------------------------------------------------------------- #


def read_blob_sequence(path: str) -> Iterator[bytes]:
    """Yields the records of a blob-sequence file."""
    with open(path, "rb") as f:
        data = f.read()
    if len(data) < 8 or data[0:2] != b"BS":
        raise ValueError(f"{path}: not a blob sequence (bad magic)")
    version = struct.unpack_from("<H", data, 2)[0]
    compression = data[4]
    pos = 8
    if version >= 1 and compression == 1:
        data = data[:8] + gzip.decompress(data[8:])
    while pos < len(data):
        (length,) = struct.unpack_from("<I", data, pos)
        pos += 4
        yield data[pos : pos + length]
        pos += length


# --------------------------------------------------------------------- #
# Dataspec
# --------------------------------------------------------------------- #

# data_spec.proto:61-85 ColumnType enum values.
_COLTYPE = {
    0: ColumnType.UNKNOWN,
    1: ColumnType.NUMERICAL,
    4: ColumnType.CATEGORICAL,
    5: ColumnType.CATEGORICAL_SET,
    7: ColumnType.BOOLEAN,
    9: ColumnType.DISCRETIZED_NUMERICAL,
    10: ColumnType.HASH,
    11: ColumnType.NUMERICAL_VECTOR_SEQUENCE,
}


class _YdfColumn:
    """Decoded reference column: our Column + import-only extras."""

    def __init__(self, col: Column, disc_boundaries: Optional[np.ndarray]):
        self.col = col
        self.disc_boundaries = disc_boundaries


def _parse_column(msg: pw.Message) -> _YdfColumn:
    """data_spec.proto:88-126 Column."""
    ctype = _COLTYPE.get(pw.get_int(msg, 1, 0), ColumnType.UNKNOWN)
    name = pw.get_str(msg, 2)
    col = Column(name=name, type=ctype)
    col.num_missing = pw.get_sint(msg, 7, 0)  # count_nas = 7

    num = pw.get_msg(msg, 5)  # numerical = 5 (NumericalSpec, :209-216)
    if num is not None:
        col.mean = pw.get_double(num, 1, 0.0)
        col.min_value = pw.get_float(num, 2, 0.0)
        col.max_value = pw.get_float(num, 3, 0.0)

    disc_boundaries = None
    disc = pw.get_msg(msg, 8)  # discretized_numerical = 8 (:267-279)
    if disc is not None:
        disc_boundaries = pw.get_packed_floats(disc, 1)
        col.discretized_boundaries = [float(v) for v in disc_boundaries]

    cat = pw.get_msg(msg, 6)  # categorical = 6 (CategoricalSpec, :150-208)
    if cat is not None:
        n_unique = pw.get_sint(cat, 2, 0)  # number_of_unique_values = 2
        integerized = pw.get_bool(cat, 5)  # is_already_integerized = 5
        items = pw.get_repeated_msg(cat, 7)  # items map = 7
        if items and not integerized:
            vocab: List[Optional[str]] = [None] * n_unique
            counts = [0] * n_unique
            for entry in items:  # map entry: key = 1, value = 2
                key = pw.get_bytes(entry, 1).decode("utf-8")
                vv = pw.get_msg(entry, 2)  # VocabValue: index = 1, count = 2
                idx = pw.get_sint(vv, 1, 0) if vv else 0
                cnt = pw.get_sint(vv, 2, 0) if vv else 0
                if 0 <= idx < n_unique:
                    vocab[idx] = key
                    counts[idx] = cnt
            col.vocabulary = [
                (v if v is not None else (OOV_ITEM if i == 0 else f"<unk:{i}>"))
                for i, v in enumerate(vocab)
            ]
            col.vocab_counts = counts
        else:
            # Integerized: the raw value IS the index (0 = out-of-dictionary).
            col.vocabulary = [
                OOV_ITEM if i == 0 else str(i) for i in range(max(n_unique, 1))
            ]
            col.vocab_counts = [0] * max(n_unique, 1)

    vseq = pw.get_msg(msg, 13)  # numerical_vector_sequence = 13 (:237-248)
    if vseq is not None:
        col.vector_length = pw.get_sint(vseq, 1, 0)
        col.min_num_vectors = pw.get_sint(vseq, 3, 0)
        col.max_num_vectors = pw.get_sint(vseq, 4, 0)

    booln = pw.get_msg(msg, 9)  # boolean = 9 (BooleanSpec, :232-235)
    if booln is not None:
        ct = pw.get_sint(booln, 1, 0)
        cf = pw.get_sint(booln, 2, 0)
        col.mean = ct / max(ct + cf, 1)

    return _YdfColumn(col, disc_boundaries)


def parse_dataspec(buf: bytes) -> Tuple[DataSpecification, List[_YdfColumn]]:
    msg = pw.decode(buf)
    ycols = [_parse_column(m) for m in pw.get_repeated_msg(msg, 1)]
    spec = DataSpecification(
        columns=[y.col for y in ycols],
        created_num_rows=pw.get_sint(msg, 2, 0),
    )
    return spec, ycols


# --------------------------------------------------------------------- #
# Node records → trees
# --------------------------------------------------------------------- #


class _Node:
    __slots__ = (
        "is_leaf", "attribute", "cond_type", "cond", "na_value",
        "leaf", "neg", "pos", "cover",
    )

    def __init__(self):
        self.is_leaf = True
        self.attribute = -1
        self.cond_type = 0
        self.cond: Optional[pw.Message] = None
        self.na_value = False
        self.leaf: Optional[pw.Message] = None
        self.neg: Optional["_Node"] = None
        self.pos: Optional["_Node"] = None
        self.cover = 0.0


def _parse_node(buf: bytes) -> _Node:
    """decision_tree.proto:202 Node."""
    msg = pw.decode(buf)
    node = _Node()
    cond = pw.get_msg(msg, 3)  # condition = 3 (NodeCondition, :179-199)
    if cond is not None:
        node.is_leaf = False
        node.na_value = pw.get_bool(cond, 1)  # na_value = 1
        node.attribute = pw.get_sint(cond, 2, -1)  # attribute = 2
        # num_training_examples_with_weight = 5 (cover for TreeSHAP).
        node.cover = pw.get_double(cond, 5, 0.0)
        inner = pw.get_msg(cond, 3)  # condition = 3 (Condition, :86-176)
        if inner is None:
            raise ValueError("non-leaf node without condition type")
        # Oneof (decision_tree.proto:164-173): exactly one field set.
        for f in (1, 2, 3, 4, 5, 6, 7, 8):
            if f in inner:
                node.cond_type = f
                node.cond = pw.decode(bytes(inner[f][-1]))
                break
        else:
            raise ValueError("unknown condition type")
    node.leaf = msg  # leaf payload read lazily by the model-specific reader
    if node.is_leaf:
        node.cover = _leaf_cover(msg)
    return node


def _leaf_cover(msg: pw.Message) -> float:
    """Weighted example count of a leaf, from whichever output it carries:
    classifier distribution sum (distribution.proto:35), regressor
    sum_weights / distribution count (decision_tree.proto:39-41), anomaly
    num_examples_without_weight (:81)."""
    cls = pw.get_msg(msg, 1)
    if cls is not None:
        dist = pw.get_msg(cls, 2)
        if dist is not None:
            return pw.get_double(dist, 2, 0.0)
    reg = pw.get_msg(msg, 2)
    if reg is not None:
        sw = pw.get_double(reg, 5, 0.0)
        if sw > 0:
            return sw
        dist = pw.get_msg(reg, 2)
        if dist is not None:
            return pw.get_double(dist, 3, 0.0)
    ad = pw.get_msg(msg, 6)
    if ad is not None:
        return float(pw.get_sint(ad, 1, 0))
    up = pw.get_msg(msg, 5)  # uplift leaf: sum_weights = 1
    if up is not None:
        return pw.get_double(up, 1, 1.0)
    return 1.0


def _read_tree(records: Iterator[bytes]) -> _Node:
    """One tree: preorder, negative child first (decision_tree.cc:580-599)."""
    node = _parse_node(next(records))
    if not node.is_leaf:
        node.neg = _read_tree(records)
        node.pos = _read_tree(records)
    return node


def read_trees(model_dir: str, num_shards: int, num_trees: int,
               prefix: str = "") -> List[_Node]:
    def record_iter():
        for shard in range(num_shards):
            path = os.path.join(
                model_dir,
                f"{prefix}nodes-{shard:05d}-of-{num_shards:05d}",
            )
            yield from read_blob_sequence(path)

    it = record_iter()
    return [_read_tree(it) for _ in range(num_trees)]


# --------------------------------------------------------------------- #
# Trees → Forest arrays
# --------------------------------------------------------------------- #


class _FeatureMap:
    """Maps reference column indices to our [numericals..., categoricals...]
    serving layout (the order the Binner uses)."""

    def __init__(self, spec: DataSpecification, ycols: List[_YdfColumn],
                 input_features: List[int]):
        num_like, cat_like, set_like, vs_like = [], [], [], []
        for ci in input_features:
            t = spec.columns[ci].type
            if t == ColumnType.CATEGORICAL:
                cat_like.append(ci)
            elif t == ColumnType.CATEGORICAL_SET:
                set_like.append(ci)
            elif t == ColumnType.NUMERICAL_VECTOR_SEQUENCE:
                vs_like.append(ci)
            elif t in NUMERICAL_LIKE:
                num_like.append(ci)
            else:
                raise NotImplementedError(
                    f"import of column type {t} is not supported yet"
                )
        self.num_cols = num_like
        self.cat_cols = cat_like
        self.set_cols = set_like
        self.vs_cols = vs_like
        self.col_to_feature: Dict[int, int] = {}
        for i, ci in enumerate(num_like + cat_like + set_like):
            self.col_to_feature[ci] = i
        # Vector-sequence columns live in their own index space (the
        # forest's per-tree anchor block), not in col_to_feature.
        self.col_to_vs: Dict[int, int] = {
            ci: j for j, ci in enumerate(vs_like)
        }
        self.num_numerical = len(num_like)
        self.ycols = ycols
        self.spec = spec

    @property
    def feature_names(self) -> List[str]:
        return [
            self.spec.columns[ci].name
            for ci in self.num_cols + self.cat_cols + self.set_cols
        ]

    @property
    def max_vocab(self) -> int:
        vs = [
            self.spec.columns[ci].vocab_size
            for ci in self.cat_cols + self.set_cols
        ]
        return max(vs, default=1)

    def make_binner(self) -> Binner:
        """A serving-only Binner: imputation values + layout. Imported models
        route on raw values, so bin boundaries are unused (+inf filler)."""
        F = len(self.col_to_feature)
        num_bins = max(256, self.max_vocab + 1)
        impute = np.zeros((F,), np.float32)
        for i, ci in enumerate(self.num_cols):
            impute[i] = self.spec.columns[ci].mean
        fnb = np.full((F,), 2, np.int32)
        for j, ci in enumerate(self.set_cols):
            # Imported set features keep the FULL reference vocabulary
            # (the packed-set encoding width follows the forest's mask).
            fnb[len(self.num_cols) + len(self.cat_cols) + j] = max(
                self.spec.columns[ci].vocab_size, 1
            )
        return Binner(
            feature_names=self.feature_names,
            num_numerical=self.num_numerical,
            num_bins=num_bins,
            boundaries=np.full((F, 1), np.inf, np.float32),
            impute_values=impute,
            feature_num_bins=fnb,
            num_set=len(self.set_cols),
            vs_names=[self.spec.columns[ci].name for ci in self.vs_cols],
            vs_dims=[
                max(self.spec.columns[ci].vector_length, 1)
                for ci in self.vs_cols
            ],
            vs_max_len=max(
                (
                    max(self.spec.columns[ci].max_num_vectors, 1)
                    for ci in self.vs_cols
                ),
                default=0,
            ),
        )


def _bitmap_to_mask(
    bitmap: bytes, width_words: int, invert: bool = True
) -> np.ndarray:
    """ContainsBitmap bytes (bit i = category i matches → POSITIVE branch)
    → our uint32 mask. For CATEGORICAL nodes the stored mask means
    "goes LEFT" (negative child), so the bitmap is complemented; for
    CATEGORICAL_SET nodes (invert=False) the mask IS the positive
    selection (intersect → right)."""
    bits = np.frombuffer(bitmap, dtype=np.uint8)
    words = np.zeros((width_words,), np.uint32)
    as_u32 = np.zeros((width_words * 4,), np.uint8)
    as_u32[: len(bits)] = bits[: width_words * 4]
    words[:] = as_u32.view("<u4")
    return ~words if invert else words


def _elements_to_mask(
    elements: List[int], width_words: int, invert: bool = True
) -> np.ndarray:
    words = np.zeros((width_words,), np.uint32)
    for e in elements:
        if 0 <= e < width_words * 32:
            words[e >> 5] |= np.uint32(1) << np.uint32(e & 31)
    return ~words if invert else words


def trees_to_forest(
    trees: List[_Node],
    fmap: _FeatureMap,
    leaf_fn,
    leaf_dim: int,
) -> Tuple[Forest, int]:
    """Flattens parsed trees into a Forest (preorder node ids; root = 0).

    leaf_fn(node_msg, depth) -> np.ndarray [leaf_dim] leaf value.
    Returns (forest on the CPU, max_depth).
    """
    W = max((fmap.max_vocab + 31) // 32, 1)
    T = len(trees)
    F_total = len(fmap.col_to_feature)
    Fn = fmap.num_numerical

    per_tree = []
    per_tree_proj: List[List[np.ndarray]] = []
    per_tree_vs: List[List[tuple]] = []
    _VS_BASE = 1 << 20  # sentinel block remapped once max_P is known
    max_nodes, max_depth = 1, 1
    for root in trees:
        rows: List[dict] = []
        projs: List[np.ndarray] = []
        vs_list: List[tuple] = []

        def walk(node: _Node, depth: int) -> int:
            idx = len(rows)
            row = dict(
                feature=-1, threshold=np.inf, is_cat=False, is_set=False,
                cat_mask=np.full((W,), 0xFFFFFFFF, np.uint32),
                left=0, right=0, is_leaf=node.is_leaf,
                na_left=not node.na_value,
                leaf_value=np.zeros((leaf_dim,), np.float32),
                cover=max(float(node.cover), 1.0),
            )
            rows.append(row)
            if node.is_leaf:
                row["leaf_value"] = leaf_fn(node.leaf, depth)
                return idx
            ci = node.attribute
            # VS columns have no scalar feature slot; the ct==8 branch
            # assigns their sentinel-block index.
            row["feature"] = fmap.col_to_feature.get(ci, -1)
            ct, c = node.cond_type, node.cond
            if ct == 2:  # Higher: value >= threshold → positive (:93-96)
                row["threshold"] = pw.get_float(c, 1)
            elif ct == 3:  # TrueValue on BOOLEAN (:91)
                row["threshold"] = 0.5
            elif ct == 4:  # ContainsVector (:98-101)
                on_set = (
                    fmap.spec.columns[ci].type == ColumnType.CATEGORICAL_SET
                )
                row["is_set" if on_set else "is_cat"] = True
                row["cat_mask"] = _elements_to_mask(
                    pw.get_packed_varints(c, 1), W, invert=not on_set
                )
            elif ct == 5:  # ContainsBitmap (:104-108)
                on_set = (
                    fmap.spec.columns[ci].type == ColumnType.CATEGORICAL_SET
                )
                row["is_set" if on_set else "is_cat"] = True
                row["cat_mask"] = _bitmap_to_mask(
                    pw.get_bytes(c, 1), W, invert=not on_set
                )
            elif ct == 6:  # DiscretizedHigher (:110-113)
                t = pw.get_sint(c, 1)
                b = fmap.ycols[ci].disc_boundaries
                if b is None or len(b) == 0:
                    raise ValueError("discretized condition without boundaries")
                row["threshold"] = float(b[min(max(t - 1, 0), len(b) - 1)])
            elif ct == 1:  # NA: value is missing → positive (:89)
                # Non-missing always goes left (v < inf / every mask bit
                # set / empty set selection), missing follows na_left=False
                # → right. Categorical/set attributes must route through
                # their own paths so their missing encoding is recognized.
                row["threshold"] = np.inf
                t_col = fmap.spec.columns[ci].type
                row["is_cat"] = t_col == ColumnType.CATEGORICAL
                if t_col == ColumnType.CATEGORICAL_SET:
                    row["is_set"] = True
                    row["cat_mask"] = np.zeros((W,), np.uint32)
                row["na_left"] = False
            elif ct == 7:  # Oblique (:114-131): Σ w_i·x_i >= threshold
                attrs = pw.get_packed_varints(c, 1)
                wts = pw.get_packed_floats(c, 2)
                na_repls = pw.get_packed_floats(c, 4)  # positional, opt.
                wvec = np.zeros((Fn,), np.float32)
                rvec = np.full((Fn,), np.nan, np.float32)
                for j, (a, wv) in enumerate(zip(attrs, wts)):
                    fi = fmap.col_to_feature[a]
                    if fi >= Fn:
                        raise ValueError(
                            "oblique condition on non-numerical column"
                        )
                    wvec[fi] = wv
                    if j < len(na_repls):
                        rvec[fi] = na_repls[j]
                row["feature"] = F_total + len(projs)
                row["threshold"] = pw.get_float(c, 3)
                projs.append((wvec, rvec))
            elif ct == 8:  # NumericalVectorSequence (:133-177)
                fv = fmap.col_to_vs.get(ci)
                if fv is None:
                    raise ValueError(
                        "vector-sequence condition on a non-VS column"
                    )
                closer = pw.get_msg(c, 1)
                projm = pw.get_msg(c, 2)
                if closer is not None:
                    anc_msg = pw.get_msg(closer, 1)
                    anchor = np.asarray(
                        pw.get_packed_floats(anc_msg, 1), np.float32
                    )
                    # closer_than: min|v-a|^2 <= threshold2 ⇔ routed value
                    # -min|v-a|^2 >= -threshold2 (vector_sequence.cc:92-99
                    # negates the same way).
                    row["threshold"] = -pw.get_float(closer, 2)
                    is_closer = True
                elif projm is not None:
                    anc_msg = pw.get_msg(projm, 1)
                    anchor = np.asarray(
                        pw.get_packed_floats(anc_msg, 1), np.float32
                    )
                    row["threshold"] = pw.get_float(projm, 2)
                    is_closer = False
                else:
                    raise ValueError("empty vector-sequence condition")
                row["feature"] = _VS_BASE + len(vs_list)
                vs_list.append((fv, anchor, is_closer))
            else:
                raise NotImplementedError(f"condition type {ct}")
            # Negative child → left, positive child → right (our routing:
            # v < threshold / mask-bit set → left).
            row["left"] = walk(node.neg, depth + 1)
            row["right"] = walk(node.pos, depth + 1)
            return idx

        def depth_of(node: _Node) -> int:
            if node.is_leaf:
                return 0
            return 1 + max(depth_of(node.neg), depth_of(node.pos))

        walk(root, 0)
        per_tree.append(rows)
        per_tree_proj.append(projs)
        per_tree_vs.append(vs_list)
        max_nodes = max(max_nodes, len(rows))
        max_depth = max(max_depth, depth_of(root))

    max_P = max((len(p) for p in per_tree_proj), default=0)
    max_Pv = max((len(v) for v in per_tree_vs), default=0)
    if max_Pv > 0:
        # Anchor width must match the serving-side input padding, which
        # covers EVERY declared VS column (binner.vs_dim) — not just the
        # dims of anchors that happen to appear in trees.
        Dv = max(
            (len(a) for vl in per_tree_vs for (_, a, _c) in vl), default=1
        )
        Dv = max(
            Dv,
            max(
                (
                    fmap.spec.columns[ci].vector_length
                    for ci in fmap.vs_cols
                ),
                default=1,
            ),
        )
        vs_anchor = np.zeros((T, max_Pv, Dv), np.float32)
        vs_feat = np.zeros((T, max_Pv), np.int32)
        vs_is_closer = np.zeros((T, max_Pv), bool)
        for t, vl in enumerate(per_tree_vs):
            for q, (fv, anchor, is_c) in enumerate(vl):
                vs_anchor[t, q, : len(anchor)] = anchor
                vs_feat[t, q] = fv
                vs_is_closer[t, q] = is_c
        # Sentinel block → [F_total + max_P, F_total + max_P + max_Pv).
        for rows in per_tree:
            for row in rows:
                if row["feature"] >= _VS_BASE:
                    row["feature"] = (
                        F_total + max_P + (row["feature"] - _VS_BASE)
                    )
    else:
        vs_anchor = np.zeros((T, 0, 0), np.float32)
        vs_feat = np.zeros((T, 0), np.int32)
        vs_is_closer = np.zeros((T, 0), bool)
    if max_P > 0:
        obl = np.zeros((T, max_P, Fn), np.float32)
        obl_r = np.full((T, max_P, Fn), np.nan, np.float32)
        for t, projs in enumerate(per_tree_proj):
            for pi, (wvec, rvec) in enumerate(projs):
                obl[t, pi] = wvec
                obl_r[t, pi] = rvec
    else:
        obl = np.zeros((T, 0, 0), np.float32)
        obl_r = np.zeros((T, 0, 0), np.float32)

    def stack(field, dtype, shape=()):
        out = np.zeros((T, max_nodes) + shape, dtype)
        if field == "feature":
            out[:] = -1
        if field == "is_leaf":
            out[:] = True
        for t, rows in enumerate(per_tree):
            for i, row in enumerate(rows):
                out[t, i] = row[field]
        return out

    forest = Forest.from_numpy(dict(
        feature=stack("feature", np.int32),
        threshold=stack("threshold", np.float32),
        threshold_bin=np.zeros((T, max_nodes), np.int32),
        is_cat=stack("is_cat", np.bool_),
        is_set=stack("is_set", np.bool_),
        cat_mask=stack("cat_mask", np.uint32, (W,)),
        left=stack("left", np.int32),
        right=stack("right", np.int32),
        is_leaf=stack("is_leaf", np.bool_),
        na_left=stack("na_left", np.bool_),
        leaf_value=stack("leaf_value", np.float32, (leaf_dim,)),
        cover=stack("cover", np.float32),
        oblique_weights=obl,
        oblique_na_repl=obl_r,
        vs_anchor=vs_anchor,
        vs_feat=vs_feat,
        vs_is_closer=vs_is_closer,
        num_nodes=np.array([len(r) for r in per_tree], np.int32),
    ))
    return forest, max(max_depth, 1)


# --------------------------------------------------------------------- #
# Leaf readers (decision_tree.proto:23-82)
# --------------------------------------------------------------------- #


def _leaf_regressor_top_value(leaf_msg: pw.Message, depth: int) -> np.ndarray:
    reg = pw.get_msg(leaf_msg, 2)  # Node.regressor = 2
    v = pw.get_float(reg, 1, 0.0) if reg else 0.0  # top_value = 1
    return np.array([v], np.float32)


def _make_leaf_classifier(num_classes: int):
    def leaf(leaf_msg: pw.Message, depth: int) -> np.ndarray:
        cls = pw.get_msg(leaf_msg, 1)  # Node.classifier = 1
        out = np.zeros((num_classes,), np.float32)
        if cls is None:
            return out
        dist = pw.get_msg(cls, 2)  # distribution = 2 (IntegerDistributionDouble)
        if dist is not None:
            counts = pw.get_packed_doubles(dist, 1)  # counts = 1, index 0 = OOV
            total = counts[1 : num_classes + 1].sum()
            if total > 0:
                out[: len(counts) - 1] = counts[1 : num_classes + 1] / total
                return out
        top = pw.get_sint(cls, 1, 0)  # top_value = 1 (label index, 1-based)
        if 1 <= top <= num_classes:
            out[top - 1] = 1.0
        return out

    return leaf


def _leaf_uplift(leaf_msg: pw.Message, depth: int) -> np.ndarray:
    up = pw.get_msg(leaf_msg, 5)  # Node.uplift = 5 (NodeUpliftOutput, :49)
    if up is None:
        return np.zeros((1,), np.float32)
    eff = pw.get_packed_floats(up, 4)  # treatment_effect = 4
    return np.array([eff[0] if len(eff) else 0.0], np.float32)


def _make_leaf_anomaly():
    from ydf_tpu_torch.models.if_model import average_path_length

    def leaf(leaf_msg: pw.Message, depth: int) -> np.ndarray:
        ad = pw.get_msg(leaf_msg, 6)  # Node.anomaly_detection = 6
        n = pw.get_sint(ad, 1, 0) if ad else 0  # num_examples_without_weight
        return np.array(
            [depth + float(average_path_length(n))], np.float32
        )

    return leaf


# --------------------------------------------------------------------- #
# Model assembly
# --------------------------------------------------------------------- #

# abstract_model.proto:25-62 Task enum.
_TASK = {
    1: Task.CLASSIFICATION,
    2: Task.REGRESSION,
    3: Task.RANKING,
    4: Task.CATEGORICAL_UPLIFT,
    5: Task.NUMERICAL_UPLIFT,
    6: Task.ANOMALY_DETECTION,
    7: Task.SURVIVAL_ANALYSIS,
}

# gradient_boosted_trees.proto:56-81 Loss enum → our loss names.
_GBT_LOSS = {
    0: "DEFAULT",
    1: "BINOMIAL_LOG_LIKELIHOOD",
    2: "SQUARED_ERROR",
    3: "MULTINOMIAL_LOG_LIKELIHOOD",
    5: "XE_NDCG_MART",
    6: "BINARY_FOCAL_LOSS",
    7: "POISSON",
    8: "MEAN_AVERAGE_ERROR",
    9: "LAMBDA_MART_NDCG",
    10: "COX_PROPORTIONAL_HAZARD",
}


def _check_node_format(fmt: str, path: str) -> None:
    """Node container format (e.g. gradient_boosted_trees.proto:42). Only
    the blob-sequence containers are supported; old TFE_RECORDIO models
    get an explicit error instead of a bad-magic failure."""
    if fmt and not fmt.startswith("BLOB_SEQUENCE"):
        raise NotImplementedError(
            f"{path}: node container format {fmt!r} is not supported "
            "(only BLOB_SEQUENCE / BLOB_SEQUENCE_GZIP)"
        )


def _read_file(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def _detect_prefix(path: str, strict: bool = False) -> Optional[str]:
    """Models can share a directory under distinct filename prefixes
    (reference model_library.cc LoadModel's `file_prefix`). Returns the
    prefix ("" for none) or None if no model is present. With strict=True,
    several candidate prefixes raise instead of silently picking one
    (the reference's DetectFilePrefix ambiguity error)."""
    if not os.path.isdir(path):
        return None
    found = []
    for fname in sorted(os.listdir(path)):
        if fname.endswith("data_spec.pb"):
            prefix = fname[: -len("data_spec.pb")]
            if os.path.isfile(os.path.join(path, prefix + "header.pb")):
                found.append(prefix)
    if strict and len(found) > 1:
        raise ValueError(
            f"{path} contains several models (prefixes {found}); pass "
            "prefix= explicitly"
        )
    return found[0] if found else None


def is_ydf_model_dir(path: str) -> bool:
    return _detect_prefix(path) is not None


def load_ydf_model(path: str, prefix: Optional[str] = None, device=None):
    """Loads a model saved by the reference implementation.

    Supports GBT, RF and Isolation Forest with numerical / categorical /
    boolean / discretized-numerical / oblique conditions, including
    prefixed filenames (several models per directory). Returns the
    matching model class of the port on `device` (default: the CUDA
    card), serving through the routed engine.
    """
    from ydf_tpu_torch.models.io import resolve_device

    dev = resolve_device(device)
    if prefix is None:
        prefix = _detect_prefix(path, strict=True)
    if prefix is None:
        raise ValueError(f"{path} is not a YDF model directory")
    join = lambda name: os.path.join(path, prefix + name)
    header = pw.decode(_read_file(join("header.pb")))
    spec, ycols = parse_dataspec(_read_file(join("data_spec.pb")))

    # AbstractModel (abstract_model.proto:66-116)
    name = pw.get_str(header, 1)
    task = _TASK.get(pw.get_int(header, 2, 0), Task.CLASSIFICATION)
    label_col_idx = pw.get_sint(header, 3, -1)
    input_features = pw.get_packed_varints(header, 5)

    uplift_col_idx = pw.get_sint(header, 9, -1)  # uplift_treatment_col_idx
    uplift_treatment = None
    if 0 <= uplift_col_idx < len(spec.columns):
        uplift_treatment = spec.columns[uplift_col_idx].name
    ranking_idx = pw.get_sint(header, 6, -1)  # ranking_group_col_idx
    ranking_group = None
    if 0 <= ranking_idx < len(spec.columns):
        ranking_group = spec.columns[ranking_idx].name

    label = None
    classes = None
    if 0 <= label_col_idx < len(spec.columns):
        label_col = spec.columns[label_col_idx]
        label = label_col.name
        if task == Task.CLASSIFICATION and label_col.vocabulary:
            classes = list(label_col.vocabulary[1:])

    fmap = _FeatureMap(spec, ycols, input_features)
    binner = fmap.make_binner()

    gbt_path = join("gradient_boosted_trees_header.pb")
    rf_path = join("random_forest_header.pb")
    if_path = join("isolation_forest_header.pb")

    if os.path.isfile(gbt_path):
        from ydf_tpu_torch.models.gbt_model import GradientBoostedTreesModel

        # gradient_boosted_trees.proto:24-52 Header.
        gh = pw.decode(_read_file(gbt_path))
        num_shards = pw.get_sint(gh, 1, 1)
        num_trees = pw.get_sint(gh, 2, 0)
        _check_node_format(pw.get_str(gh, 7, ""), path)
        loss_name = _GBT_LOSS.get(pw.get_int(gh, 3, 0), "DEFAULT")
        init_preds = pw.get_packed_floats(gh, 4)
        trees = read_trees(path, num_shards, num_trees, prefix)
        forest, max_depth = trees_to_forest(
            trees, fmap, _leaf_regressor_top_value, 1
        )
        K = max(len(init_preds), 1)
        return GradientBoostedTreesModel(
            task=task, label=label, classes=classes, dataspec=spec,
            binner=binner, forest=forest.to(dev),
            initial_predictions=np.asarray(init_preds, np.float32),
            num_trees_per_iter=K, max_depth=max_depth, loss_name=loss_name,
            native_missing=True,
            extra_metadata={
                "imported_from": "ydf",
                "name": name,
                **(
                    {"ranking_group": ranking_group} if ranking_group else {}
                ),
            },
        )

    if os.path.isfile(rf_path):
        from ydf_tpu_torch.models.rf_model import RandomForestModel

        # random_forest.proto:24-46 Header.
        rh = pw.decode(_read_file(rf_path))
        num_shards = pw.get_sint(rh, 1, 1)
        num_trees = pw.get_sint(rh, 2, 0)
        _check_node_format(pw.get_str(rh, 7, ""), path)
        winner_take_all = pw.get_bool(rh, 3, True)
        trees = read_trees(path, num_shards, num_trees, prefix)
        if task == Task.CLASSIFICATION:
            ncls = len(classes) if classes else 2
            leaf_fn, leaf_dim = _make_leaf_classifier(ncls), ncls
        elif task in (Task.CATEGORICAL_UPLIFT, Task.NUMERICAL_UPLIFT):
            leaf_fn, leaf_dim = _leaf_uplift, 1
        else:
            leaf_fn, leaf_dim = _leaf_regressor_top_value, 1
        forest, max_depth = trees_to_forest(trees, fmap, leaf_fn, leaf_dim)
        return RandomForestModel(
            task=task, label=label, classes=classes, dataspec=spec,
            binner=binner, forest=forest.to(dev), max_depth=max_depth,
            winner_take_all=winner_take_all, native_missing=True,
            extra_metadata={
                "imported_from": "ydf",
                "name": name,
                **(
                    {"uplift_treatment": uplift_treatment}
                    if uplift_treatment
                    else {}
                ),
            },
        )

    if os.path.isfile(if_path):
        from ydf_tpu_torch.models.if_model import IsolationForestModel

        # isolation_forest.proto:27-45 Header.
        ih = pw.decode(_read_file(if_path))
        num_shards = pw.get_sint(ih, 1, 1)
        num_trees = pw.get_sint(ih, 2, 0)
        _check_node_format(pw.get_str(ih, 3, ""), path)
        num_examples_per_tree = pw.get_sint(ih, 4, 256)
        trees = read_trees(path, num_shards, num_trees, prefix)
        forest, max_depth = trees_to_forest(
            trees, fmap, _make_leaf_anomaly(), 1
        )
        return IsolationForestModel(
            task=Task.ANOMALY_DETECTION, label=label, classes=None,
            dataspec=spec, binner=binner, forest=forest.to(dev),
            max_depth=max_depth, num_examples_per_tree=num_examples_per_tree, native_missing=True,
            extra_metadata={"imported_from": "ydf", "name": name},
        )

    raise NotImplementedError(
        f"{path}: no supported model header found (GBT/RF/IF)"
    )


# --------------------------------------------------------------------- #
# Export: write a reference-readable model directory
# --------------------------------------------------------------------- #


def write_blob_sequence(path: str, records) -> None:
    """Writes a version-0 uncompressed blob sequence
    (utils/blob_sequence.h:125-149)."""
    with open(path, "wb") as f:
        f.write(b"BS" + struct.pack("<H", 0) + b"\x00\x00\x00\x00")
        for r in records:
            f.write(struct.pack("<I", len(r)))
            f.write(r)


def _encode_column(col: Column) -> bytes:
    """Column (data_spec.proto:88-126)."""
    type_code = {v: k for k, v in _COLTYPE.items()}[col.type]
    out = pw.put_int(1, type_code) + pw.put_str(2, col.name)
    if col.type in (
        ColumnType.NUMERICAL,
        ColumnType.BOOLEAN,
        ColumnType.DISCRETIZED_NUMERICAL,
    ):
        num = (
            pw.put_double(1, col.mean)
            + pw.put_float(2, col.min_value)
            + pw.put_float(3, col.max_value)
        )
        out += pw.put_msg(5, num)
    if (
        col.type == ColumnType.DISCRETIZED_NUMERICAL
        and col.discretized_boundaries is not None
    ):
        # DiscretizedNumericalSpec (data_spec.proto:267): boundaries = 1,
        # maximum_num_bins = 3.
        disc = pw.put_packed_floats(1, col.discretized_boundaries)
        disc += pw.put_int(3, len(col.discretized_boundaries) + 1)
        out += pw.put_msg(8, disc)
    if (
        col.type in (ColumnType.CATEGORICAL, ColumnType.CATEGORICAL_SET)
        and col.vocabulary is not None
    ):
        items = b""
        counts = col.vocab_counts or [0] * col.vocab_size
        for idx, (key, cnt) in enumerate(zip(col.vocabulary, counts)):
            vv = pw.put_int(1, idx) + pw.put_int(2, int(cnt))
            entry = pw.put_bytes(1, key.encode("utf-8")) + pw.put_msg(2, vv)
            items += pw.put_msg(7, entry)
        cat = pw.put_int(2, col.vocab_size) + items
        out += pw.put_msg(6, cat)
    if col.type == ColumnType.NUMERICAL_VECTOR_SEQUENCE:
        vseq = (
            pw.put_int(1, int(col.vector_length))
            + pw.put_int(3, int(col.min_num_vectors))
            + pw.put_int(4, int(col.max_num_vectors))
        )
        out += pw.put_msg(13, vseq)
    if col.num_missing:
        out += pw.put_int(7, int(col.num_missing))
    return out


def _encode_dataspec(spec: DataSpecification) -> bytes:
    out = b"".join(pw.put_msg(1, _encode_column(c)) for c in spec.columns)
    if spec.created_num_rows:
        out += pw.put_int(2, int(spec.created_num_rows))
    return out


def _encode_node(row: dict, leaf_payload: bytes,
                 forest_np: dict, t: int, nid: int) -> bytes:
    """Node (decision_tree.proto:202) from flattened Forest arrays."""
    if row["is_leaf"]:
        return leaf_payload
    feat = int(row["feature"])
    F_total = row["F_total"]
    P_obl = forest_np["oblique_weights"].shape[1]
    if feat >= F_total + P_obl:
        # Vector-sequence anchor -> Condition.NumericalVectorSequence
        # (:133-177). Routed value v = max_dot or -min_sqdist; our
        # "v >= threshold -> positive" maps to threshold (projected) /
        # threshold2 = -threshold (closer).
        q = feat - F_total - P_obl
        anchor = np.asarray(forest_np["vs_anchor"][t, q], np.float32)
        anchor = anchor[: row.get("vs_dim", len(anchor))]
        anc = pw.put_msg(1, pw.put_packed_floats(1, anchor))
        if bool(forest_np["vs_is_closer"][t, q]):
            inner = pw.put_msg(
                1, anc + pw.put_float(2, -float(row["threshold"]))
            )
        else:
            inner = pw.put_msg(
                2, anc + pw.put_float(2, float(row["threshold"]))
            )
        cond_type = pw.put_msg(8, inner)
        attribute = row["col_idx"]
    elif feat >= F_total:
        # Oblique projection -> Condition.Oblique (:114-131).
        p = feat - F_total
        w_vec = forest_np["oblique_weights"][t, p]
        attrs = np.flatnonzero(w_vec != 0)
        inner = (
            pw.put_packed_varints(1, row["obl_cols"][attrs].tolist())
            + pw.put_packed_floats(2, w_vec[attrs])
            + pw.put_float(3, float(row["threshold"]))
        )
        # na_replacements (field 4, positional with attributes): without
        # them the reference routes ANY partially-missing row by na_value,
        # while this model imputes per attribute.
        repl = row.get("obl_repl")
        if repl is not None:
            vals = repl[attrs]
            if np.isfinite(vals).all():
                inner += pw.put_packed_floats(4, vals)
        cond_type = pw.put_msg(7, inner)
        attribute = int(row["obl_cols"][attrs[0]]) if len(attrs) else 0
    elif row["is_set"]:
        # Set-selection mask IS the positive-branch bitmap (intersect →
        # positive; ContainsBitmap, :104-108) — no complement.
        vocab_size = row["vocab_size"]
        mask_words = forest_np["cat_mask"][t, nid]
        bits = np.unpackbits(
            mask_words.view(np.uint8), bitorder="little"
        )[:vocab_size]
        bitmap = np.packbits(bits, bitorder="little").tobytes()
        cond_type = pw.put_msg(5, pw.put_bytes(1, bitmap))
        attribute = row["col_idx"]
    elif row["is_cat"]:
        # go-LEFT mask -> positive-branch bitmap (complement), sized to
        # the vocabulary (ContainsBitmap, :104-108).
        vocab_size = row["vocab_size"]
        mask_words = forest_np["cat_mask"][t, nid]
        bits = np.unpackbits(
            mask_words.view(np.uint8), bitorder="little"
        )[:vocab_size]
        pos_bits = 1 - bits  # our mask is "goes left" = negative branch
        bitmap = np.packbits(pos_bits, bitorder="little").tobytes()
        cond_type = pw.put_msg(5, pw.put_bytes(1, bitmap))
        attribute = row["col_idx"]
    elif row.get("disc_boundaries") is not None:
        # Split on a DISCRETIZED_NUMERICAL column → DiscretizedHigher
        # (decision_tree.proto:110-113): disc_index >= threshold ⇔
        # v >= boundaries[threshold-1] = our value-space threshold (binner
        # boundaries are a subset of the dataspec's, so the lookup is exact).
        b = np.asarray(row["disc_boundaries"], np.float32)
        k = int(np.searchsorted(b, np.float32(row["threshold"]), side="left"))
        cond_type = pw.put_msg(6, pw.put_int(1, k + 1))
        attribute = row["col_idx"]
    else:
        cond_type = pw.put_msg(2, pw.put_float(1, float(row["threshold"])))
        attribute = row["col_idx"]
    cond = (
        pw.put_bool(1, not bool(row["na_left"]))  # na_value
        + pw.put_int(2, attribute)
        + pw.put_msg(3, cond_type)
        + pw.put_double(5, float(row["cover"]))
    )
    return pw.put_msg(3, cond)


def export_ydf_model(model, path: str) -> None:
    """Writes `model` as a reference-format model directory (the inverse
    of load_ydf_model): header.pb + data_spec.pb + <type>_header.pb +
    blob-sequence node shards + done marker. Covers GBT, RF and IF
    models with numerical/categorical/boolean/oblique conditions."""
    from ydf_tpu_torch.models.gbt_model import GradientBoostedTreesModel
    from ydf_tpu_torch.models.if_model import IsolationForestModel
    from ydf_tpu_torch.models.rf_model import RandomForestModel

    os.makedirs(path, exist_ok=True)
    binner = model.binner
    mask_bits = int(model.forest.cat_mask.shape[-1]) * 32
    for name in binner.feature_names[binner.num_numerical: binner.num_scalar]:
        vs = model.dataspec.column_by_name(name).vocab_size
        if vs > binner.num_bins:
            raise NotImplementedError(
                f"export of categorical column {name!r} with vocabulary "
                f"{vs} > trained mask width {binner.num_bins}"
            )
    for name in binner.feature_names[binner.num_scalar:]:
        vs = model.dataspec.column_by_name(name).vocab_size
        if vs > mask_bits:
            raise NotImplementedError(
                f"export of set column {name!r} with vocabulary {vs} > "
                f"trained mask width {mask_bits}"
            )
    spec_cols = []
    # Dataspec: input features in our serving order + label (+ group /
    # treatment columns).
    col_index: Dict[str, int] = {}
    for name in list(binner.feature_names) + list(
        getattr(binner, "vs_names", [])
    ):
        col = model.dataspec.column_by_name(name)
        spec_cols.append(col)
        col_index[name] = len(spec_cols) - 1
    label_idx = -1
    if model.label is not None:
        spec_cols.append(model.dataspec.column_by_name(model.label))
        label_idx = len(spec_cols) - 1
    ranking_idx = -1
    if model.task == Task.RANKING:
        gcol = model.extra_metadata.get("ranking_group")
        if not gcol:
            raise NotImplementedError(
                "export of a ranking model without ranking_group metadata"
            )
        spec_cols.append(model.dataspec.column_by_name(gcol))
        ranking_idx = len(spec_cols) - 1
    uplift_idx = -1
    if model.task in (Task.CATEGORICAL_UPLIFT, Task.NUMERICAL_UPLIFT):
        tcol = model.extra_metadata.get("uplift_treatment")
        if not tcol:
            raise NotImplementedError(
                "export of an uplift model without uplift_treatment metadata"
            )
        spec_cols.append(model.dataspec.column_by_name(tcol))
        uplift_idx = len(spec_cols) - 1
    out_spec = DataSpecification(
        columns=spec_cols, created_num_rows=model.dataspec.created_num_rows
    )
    with open(os.path.join(path, "data_spec.pb"), "wb") as f:
        f.write(_encode_dataspec(out_spec))

    task_code = {v: k for k, v in _TASK.items()}[model.task]
    # The reference resolves the model class from this name
    # (model_library.cc CreateEmptyModel) — it must be the registered
    # model key, which our model_type strings mirror.
    header = (
        pw.put_str(1, model.model_type)
        + pw.put_int(2, task_code)
        + pw.put_int(3, label_idx)
        + pw.put_packed_varints(
            5,
            [
                col_index[n]
                for n in list(binner.feature_names)
                + list(getattr(binner, "vs_names", []))
            ],
        )
    )
    if ranking_idx >= 0:
        header += pw.put_int(6, ranking_idx)
    if uplift_idx >= 0:
        header += pw.put_int(9, uplift_idx)
    with open(os.path.join(path, "header.pb"), "wb") as f:
        f.write(header)

    # --- nodes ---------------------------------------------------------
    f_np = model.forest.to_numpy()
    T = f_np["feature"].shape[0]
    Fn = binner.num_numerical
    F_total = binner.num_features
    obl_cols = np.array(
        [col_index[n] for n in binner.feature_names[:Fn]], np.int64
    ) if Fn else np.zeros((0,), np.int64)

    is_classification = model.task == Task.CLASSIFICATION
    is_uplift = model.task in (Task.CATEGORICAL_UPLIFT, Task.NUMERICAL_UPLIFT)

    def leaf_payload(t: int, nid: int) -> bytes:
        v = f_np["leaf_value"][t, nid]
        cover = float(max(f_np["cover"][t, nid], 0.0))
        if is_uplift:
            # NodeUpliftOutput (decision_tree.proto:49): treatment_effect
            # carries the leaf's estimated uplift.
            up = pw.put_double(1, cover) + pw.put_packed_floats(
                4, [float(v[0])]
            )
            return pw.put_msg(5, up)
        if isinstance(model, RandomForestModel) and is_classification:
            counts = np.concatenate([[0.0], v * cover])  # index 0 = OOV
            dist = pw.put_packed_doubles(1, counts) + pw.put_double(
                2, float(counts.sum())
            )
            top = int(np.argmax(v)) + 1
            cls = pw.put_int(1, top) + pw.put_msg(2, dist)
            return pw.put_msg(1, cls)
        if isinstance(model, IsolationForestModel):
            ad = pw.put_int(1, int(round(cover)))
            return pw.put_msg(6, ad)
        reg = pw.put_float(1, float(v[0])) + pw.put_double(5, cover)
        return pw.put_msg(2, reg)

    records = []
    import sys

    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 100000))
    for t in range(T):

        def emit(nid: int):
            row = {
                "is_leaf": bool(f_np["is_leaf"][t, nid]),
                "feature": int(f_np["feature"][t, nid]),
                "threshold": float(f_np["threshold"][t, nid]),
                "is_cat": bool(f_np["is_cat"][t, nid]),
                "is_set": bool(f_np["is_set"][t, nid]),
                "na_left": bool(f_np["na_left"][t, nid]),
                "cover": float(f_np["cover"][t, nid]),
                "F_total": F_total,
                "obl_cols": obl_cols,
            }
            feat = row["feature"]
            P_obl = f_np["oblique_weights"].shape[1]
            if not row["is_leaf"] and not model.native_missing:
                # Our learners impute missing values at encode time; the
                # reference routes them per-node by na_value. Bake the
                # equivalent direction in: where the imputed value (or the
                # OOV category) would have gone.
                if feat >= F_total + P_obl:
                    # VS: missing encodes as empty -> score -FLT_MAX ->
                    # below any learned threshold -> negative branch.
                    row["na_left"] = True
                elif feat >= F_total:  # oblique: dot of imputed numericals
                    w_vec = f_np["oblique_weights"][t, feat - F_total]
                    v = float(
                        np.dot(binner.impute_values[:Fn], w_vec)
                    )
                    row["na_left"] = v < row["threshold"]
                elif row["is_set"]:
                    # Native learners encode missing sets as empty →
                    # no intersection → negative branch (left).
                    row["na_left"] = True
                elif row["is_cat"]:
                    row["na_left"] = bool(
                        f_np["cat_mask"][t, nid, 0] & np.uint32(1)
                    )
                else:
                    row["na_left"] = (
                        float(binner.impute_values[feat]) < row["threshold"]
                    )
            if 0 <= feat < F_total:
                name = binner.feature_names[feat]
                row["col_idx"] = col_index[name]
                col = model.dataspec.column_by_name(name)
                row["vocab_size"] = col.vocab_size
                if col.type == ColumnType.DISCRETIZED_NUMERICAL:
                    row["disc_boundaries"] = col.discretized_boundaries
            if feat >= F_total + P_obl:
                fv = int(f_np["vs_feat"][t, feat - F_total - P_obl])
                vs_name = binner.vs_names[fv]
                row["col_idx"] = col_index[vs_name]
                row["vs_dim"] = model.dataspec.column_by_name(
                    vs_name
                ).vector_length or None
            if F_total <= row["feature"] < F_total + P_obl and (
                "oblique_na_repl" in f_np
            ):
                row["obl_repl"] = f_np["oblique_na_repl"][
                    t, row["feature"] - F_total
                ]
                if not model.native_missing:
                    # Native-missing-off models impute: replacements are
                    # the column means.
                    row["obl_repl"] = binner.impute_values[:Fn].astype(
                        np.float32
                    )
            records.append(
                _encode_node(row, leaf_payload(t, nid), f_np, t, nid)
            )
            if not row["is_leaf"]:
                emit(int(f_np["left"][t, nid]))
                emit(int(f_np["right"][t, nid]))

        try:
            emit(0)
        except RecursionError:
            sys.setrecursionlimit(old_limit)
            raise
    sys.setrecursionlimit(old_limit)

    write_blob_sequence(
        os.path.join(path, "nodes-00000-of-00001"), records
    )

    # --- model-type header --------------------------------------------
    if isinstance(model, GradientBoostedTreesModel):
        loss_code = {v: k for k, v in _GBT_LOSS.items()}.get(
            model.loss_name, 0
        )
        gh = (
            pw.put_int(1, 1)  # num_node_shards
            + pw.put_int(2, T)
            + pw.put_int(3, loss_code)
            + pw.put_packed_floats(4, model.initial_predictions)
            + pw.put_int(5, int(model.num_trees_per_iter))
            + pw.put_str(7, "BLOB_SEQUENCE")
        )
        with open(
            os.path.join(path, "gradient_boosted_trees_header.pb"), "wb"
        ) as f:
            f.write(gh)
    elif isinstance(model, IsolationForestModel):
        ih = (
            pw.put_int(1, 1)
            + pw.put_int(2, T)
            + pw.put_str(3, "BLOB_SEQUENCE")
            + pw.put_int(4, int(model.num_examples_per_tree))
        )
        with open(
            os.path.join(path, "isolation_forest_header.pb"), "wb"
        ) as f:
            f.write(ih)
    elif isinstance(model, RandomForestModel):
        rh = (
            pw.put_int(1, 1)
            + pw.put_int(2, T)
            + pw.put_bool(3, model.winner_take_all)
            + pw.put_str(7, "BLOB_SEQUENCE")
        )
        with open(os.path.join(path, "random_forest_header.pb"), "wb") as f:
            f.write(rh)
    else:
        raise NotImplementedError(type(model).__name__)

    with open(os.path.join(path, "done"), "wb") as f:
        f.write(b"")
