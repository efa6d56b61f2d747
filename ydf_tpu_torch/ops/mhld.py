"""MHLD-oblique projections (counterpart of the JAX package's
make_mhld_W, ydf_tpu/learners/gbt.py:1196-1253; the reference's
SolveLDA / FindBestConditionMHLDObliqueTemplate, oblique.cc).

Every boosting iteration of a GBT with split_axis="MHLD_OBLIQUE" turns
the imputed numerical features x [n, Fn] into P projections from linear
discriminant analysis, in three parts:

(a) The scatter matrices (`scatter_sums`, then `finish_scatter`), from
    the label's one-hot over C = max(num_classes, 2) classes and the
    iteration's row weights w: n_c = sum_r onehot * w, mu_c = (onehot *
    w)^T x / n_c, mu = w^T x / sum(w), Sxx = (x * w)^T x, SW = Sxx -
    (mu_c^T n_c) mu_c, SB = ((mu_c - mu)^T n_c) (mu_c - mu), and reg =
    1e-3 trace(SW) / Fn + 1e-6. The two dots over the rows run on the
    training device in the order XLA's CPU gives them inside the JAX
    learner's program (jax 0.9.0 on an 8-core x86 host, the machine that
    wrote the fixtures; read by probing, see `contract_rows`); the
    vector-matrix dot w^T x is one sequential chain of fused multiply-adds
    over the rows, which this module runs on the host
    (csrc/mhld_host.cc, built with g++ at first use): each of its Fn
    results depends on every row in turn, so on the card it would take
    one launch a row as torch operations, or a kernel of its own; on the
    host it needs a row-major copy of x (n * Fn * 4 bytes) and, when the
    row weights change, w in each iteration's host read (n * 4 bytes).
    The sums of n_c and sum(w) are ops/histogram.py:sum_rows_f32; the
    [C]-deep dots and the rest are f32 numpy on the host.
(b) The subset masks (`subset_masks`): projection p takes the
    2 + p mod (smax - 1) features (smax = min(max(m, 2), Fn), m =
    mhld_oblique_max_num_attributes) whose uniform(split(k_proj, P)[p],
    (Fn,)) scores are at least the k-th largest (a value comparison:
    ties take every tied feature), from utils/prng.py's threefry.
(c) The solves (`solve_projections`), one per projection on the host
    with the LAPACK and BLAS that jaxlib's CPU linear algebra calls
    (scipy's, float32): SWp = SW * MM + diag(1 - m) + reg I and SBp = SB *
    MM for the mask m (MM = m m^T), symmetrised as jnp.linalg.cholesky
    symmetrises its input, L = spotrf(SWp), A = L^-1 SBp and M2 =
    (L^-1 A^T)^T (strsm), M2 = 0.5 (M2 + M2^T), the eigenvector of
    ssyevd's largest eigenvalue, w = L^-T v (strsm, upper) times the mask,
    divided by max(|w|, 1e-12) with the norm's squares summed in the
    learner's order (`_norm_chain`); off the mask +0. XLA's CPU runtime
    runs its LAPACK calls with subnormals flushed to zero (MXCSR FTZ and
    DAZ), which changes the eigenvectors of a masked matrix (its zero
    block's eigenvalues pass through subnormals); the solves set the same
    flags (`flush_denormals`).

The LAPACK results equal jnp.linalg's on the host that runs both (the
same library); a card's host may carry another build (ROADMAP Queue 3
logs any drift).

Parity with the JAX learner is claimed only where the orders were
identified: XLA's CPU on 8 threads (ROW_BLOCKS), the row dots at
2,700-18,000 and 450,000 rows, the trace and the norm at Fn = 28
(NORM_GROUPS_28). Elsewhere the port sums in the same fixed order, which
is neither XLA's on that shape nor a plain sum; XLA itself sums
otherwise on a host with another core count. The CPU tests hold this
module against what JAX computed on 8 cores (testdata/train_mhld/
xla_order.npz), not against a live jax.jit.
"""

from __future__ import annotations

import contextlib
import ctypes
import os
import threading
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ydf_tpu_torch.ops.histogram import sum_rows_f32
from ydf_tpu_torch.utils import prng
from ydf_tpu_torch.utils.cuda_build import BUILD_DIR, SRC_DIR

#: XLA's CPU splits a dot's rows into this many blocks (Eigen's
#: contraction sharded by the inner dimension on the 8 threads of the
#: host that wrote the fixtures; another core count splits otherwise).
ROW_BLOCKS = 8
#: The longest fused multiply-add chain inside one block (Eigen's k
#: blocking cap).
MAX_CHAIN = 320
#: Eigen's packet of 8 floats: block sizes round up to it, and the
#: output entries past the last whole packet add differently (`_add4`).
PACKET = 8

HOST_SOURCE = os.path.join(SRC_DIR, "mhld_host.cc")
HOST_LIBRARY = os.path.join(BUILD_DIR, "libydfmhld.so")
#: MXCSR's flush-to-zero and denormals-are-zero bits.
FTZ_DAZ = 0x8040
_LOCK = threading.Lock()
_LIB = None


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def row_spans(n: int) -> List[Tuple[int, int, int]]:
    """(start, end, block) of every fused multiply-add chain of
    XLA's CPU dot over n rows: ROW_BLOCKS blocks of round_up(ceil(n /
    ROW_BLOCKS), PACKET) rows (at least 12 packets), each cut into
    ceil(len / MAX_CHAIN) chains of round_up(ceil(len / chains), PACKET)
    rows, the last chain shorter."""
    bs = min(n, max(12 * PACKET, _round_up(-(-n // ROW_BLOCKS), PACKET)))
    spans = []
    for b, lo in enumerate(range(0, n, bs)):
        hi = min(lo + bs, n)
        kb = hi - lo
        kc = kb if kb <= MAX_CHAIN else _round_up(
            -(-kb // -(-kb // MAX_CHAIN)), PACKET)
        spans += [(s, min(s + kc, hi), b) for s in range(lo, hi, kc)]
    return spans


class RowSpans(NamedTuple):
    """row_spans(n) and its starts and lengths on a device."""

    spans: List[Tuple[int, int, int]]
    starts: torch.Tensor    # int64 [chains]
    lens: torch.Tensor      # int64 [chains]
    longest: int

    @staticmethod
    def of(n: int, device) -> "RowSpans":
        spans = row_spans(n)
        return RowSpans(
            spans, torch.tensor([s for s, _, _ in spans], device=device),
            torch.tensor([e - s for s, e, _ in spans], device=device),
            max(e - s for s, e, _ in spans))


def _f32(x: torch.Tensor) -> torch.Tensor:
    return x.float().double()


def contract_rows(a: torch.Tensor, b: torch.Tensor,
                  spans: Optional["RowSpans"] = None) -> torch.Tensor:
    """a^T b, f32 [M, N], for a f32 [n, M] and b f32 [n, N], in the
    order XLA's CPU computes the dot contracting the rows (jax 0.9.0,
    Eigen's tensor contraction sharded by the inner dimension; found by
    probing jax.jit(lambda a, b: a.T @ b) with terms that cancel, and
    held bitwise at n = 2,700-18,000 and 450,000 rows, M = 2, 3, 28,
    N = 28: at 45,000 rows the chains are cut otherwise, ROADMAP Queue
    3): each chain of `row_spans` is a fused multiply-add chain from 0
    (f64 products, exact, rounded once with the add); a block adds its
    chains in order; blocks 4j .. 4j + 3 add as (b0 + b1) + (b2 + b3),
    except the entries past the last whole packet of the row-major [M,
    N] result, which add b0 + ((b1 + b2) + b3); the groups then add in
    order. All chains advance together, one step a row; `spans`
    (RowSpans of n on the device) saves building the index tensors."""
    n = a.shape[0]
    M, N = a.shape[1], b.shape[1]
    dev = a.device
    if n == 0:
        return torch.zeros((M, N), dtype=torch.float32, device=dev)
    if spans is None:
        spans = RowSpans.of(n, dev)
    ad, bd = a.double(), b.double()
    acc = torch.zeros((len(spans.spans), M, N), dtype=torch.float64,
                      device=dev)
    for t in range(spans.longest):
        idx = (spans.starts + t).clamp_max(n - 1)
        step = _f32(acc + ad[idx][:, :, None] * bd[idx][:, None, :])
        acc = torch.where((spans.lens > t)[:, None, None], step, acc)
    blocks: List[torch.Tensor] = []
    for i, (_, _, blk) in enumerate(spans.spans):
        if blk == len(blocks):
            blocks.append(acc[i])
        else:
            blocks[blk] = _f32(blocks[blk] + acc[i])
    tail = (torch.arange(M * N, device=dev)
            >= (M * N) // PACKET * PACKET).reshape(M, N)

    def add4(d, s0, s1, s2):
        return torch.where(tail, _f32(d + _f32(_f32(s0 + s1) + s2)),
                           _f32(_f32(d + s0) + _f32(s1 + s2)))

    groups = []
    for g in range(0, len(blocks), 4):
        grp = blocks[g:g + 4]
        if len(grp) == 4:
            groups.append(add4(*grp))
        else:
            d = grp[0]
            for x in grp[1:]:
                d = _f32(d + x)
            groups.append(d)
    d, i = groups[0], 1
    while i + 2 < len(groups):
        d = add4(d, groups[i], groups[i + 1], groups[i + 2])
        i += 3
    for x in groups[i:]:
        d = _f32(d + x)
    return d.float()


def host_library():
    """The host helpers' ctypes handle (csrc/mhld_host.cc), built when
    stale."""
    global _LIB
    from ydf_tpu_torch.dataset.native_csv import gxx_build

    with _LOCK:
        if _LIB is None:
            gxx_build(HOST_SOURCE, HOST_LIBRARY, "the MHLD host helpers")
            lib = ctypes.CDLL(HOST_LIBRARY)
            lib.ydf_fma_chain.restype = None
            lib.ydf_fma_chain.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                ctypes.c_int32, ctypes.c_void_p]
            lib.ydf_or_mxcsr.restype = ctypes.c_uint32
            lib.ydf_or_mxcsr.argtypes = [ctypes.c_uint32]
            lib.ydf_set_mxcsr.restype = None
            lib.ydf_set_mxcsr.argtypes = [ctypes.c_uint32]
            _LIB = lib
        return _LIB


@contextlib.contextmanager
def flush_denormals():
    """This thread's MXCSR with FTZ and DAZ set for the block (no other
    bit changes), restored after it."""
    lib = host_library()
    # numpy computes (and caches) its float limits on first use; under
    # FTZ it would warn that the smallest subnormal is zero.
    np.finfo(np.float32), np.finfo(np.float64)
    old = lib.ydf_or_mxcsr(FTZ_DAZ)
    try:
        yield
    finally:
        lib.ydf_set_mxcsr(old)


def fma_chain(w: np.ndarray, x: np.ndarray) -> np.ndarray:
    """w^T x, f32 [F], for w f32 [n] and x f32 [n, F] on the host: XLA's
    CPU vector-matrix dot, one sequential fused multiply-add chain over
    the rows from 0 (held bitwise at 2,700, 18,000 and 450,000 rows)."""
    w = np.ascontiguousarray(w, np.float32)
    x = np.ascontiguousarray(x, np.float32)
    out = np.zeros((x.shape[1],), np.float32)
    host_library().ydf_fma_chain(w.ctypes.data, x.ctypes.data, x.shape[0],
                                 x.shape[1], out.ctypes.data)
    return out


class ScatterSums(NamedTuple):
    """The scatter matrices' sums over the rows (part (a) before the
    host's steps), f32 on the device of the rows."""

    num_c: torch.Tensor   # [C, Fn]: (onehot * w)^T x
    sxx: torch.Tensor     # [Fn, Fn]: (x * w)^T x
    n_c: torch.Tensor     # [C]: the classes' weights
    tot: torch.Tensor     # []: sum(w)


def scatter_sums(x: torch.Tensor, labels: torch.Tensor, w: torch.Tensor,
                 num_classes: int, spans: Optional[RowSpans] = None
                 ) -> ScatterSums:
    """The row sums of part (a) on the device of x (f32 [n, Fn]),
    labels (class ids, f32 [n]) and weights w (f32 [n])."""
    C = max(num_classes, 2)
    cls = torch.arange(C, device=x.device, dtype=labels.dtype)
    cw = torch.where(labels[:, None] == cls[None, :], w[:, None], 0.0)
    return ScatterSums(
        num_c=contract_rows(cw, x, spans),
        sxx=contract_rows(x * w[:, None], x, spans),
        n_c=sum_rows_f32(cw), tot=sum_rows_f32(w[:, None])[0])


def _chain_dot(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """a^T b, f32 [M, N], for a [K, M], b [K, N] with few K: one fused
    multiply-add chain over K from 0 (XLA's CPU dot of the [C]-deep
    products)."""
    acc = np.zeros((a.shape[1], b.shape[1]), np.float64)
    for k in range(a.shape[0]):
        acc = (acc + np.outer(a[k].astype(np.float64),
                              b[k].astype(np.float64))
               ).astype(np.float32).astype(np.float64)
    return acc.astype(np.float32)


def finish_scatter(num_c: np.ndarray, sxx: np.ndarray, n_c: np.ndarray,
                   tot, num: np.ndarray
                   ) -> Tuple[np.ndarray, np.ndarray, np.float32]:
    """(SW, SB, reg) f32 from the row sums (numpy) and num = w^T x, with
    the JAX package's f32 operations in its order."""
    f = np.float32
    Fn = sxx.shape[0]
    mu_c = num_c / np.maximum(n_c, f(1e-12))[:, None]
    mu = num / np.maximum(f(tot), f(1e-12))
    SW = sxx - _chain_dot(mu_c * n_c[:, None], mu_c)
    d = mu_c - mu[None, :]
    SB = _chain_dot(d * n_c[:, None], d)
    # jnp.trace reduces the masked matrix; in the learner's program the
    # first Fn // 8 * 8 diagonal entries go to 8 lanes by index mod 8,
    # each lane in order, the lanes added by halves, then the rest in
    # order (read from its HLO and by probing with cancelling terms;
    # identified at Fn = 28). The constant 1e-3 / Fn is folded in f32
    # and the add of 1e-6 fused with the product.
    main = Fn // 8 * 8
    lanes = [f(0)] * 8
    for i in range(main):
        lanes[i % 8] = f(lanes[i % 8] + SW[i, i])
    while len(lanes) > 1:
        h = len(lanes) // 2
        lanes = [f(lanes[i] + lanes[i + h]) for i in range(h)]
    trace = lanes[0]
    for i in range(main, Fn):
        trace = f(trace + SW[i, i])
    scale = f(f(1e-3) / f(Fn))
    reg = f(np.float64(trace) * np.float64(scale) + np.float64(f(1e-6)))
    return SW.astype(f), SB.astype(f), reg


def subset_sizes(P: int, Fn: int, max_attributes: int) -> np.ndarray:
    """Projection p's feature count, 2 + p mod max(smax - 1, 1)."""
    smax = min(max(max_attributes, 2), Fn)
    return 2 + np.arange(P) % max(smax - 1, 1)


def subset_masks(k_proj: torch.Tensor, P: int, Fn: int,
                 max_attributes: int) -> torch.Tensor:
    """bool [T, P, Fn]: every iteration's feature subsets from its
    k_proj [T, 2] (part (b))."""
    keys = prng.split(k_proj, P)                      # [T, P, 2]
    scores = prng.uniform(keys, (Fn,))                # [T, P, Fn]
    sizes = torch.as_tensor(subset_sizes(P, Fn, max_attributes),
                            device=k_proj.device)
    srt = torch.sort(scores, dim=-1).values
    kth = torch.gather(srt, -1, (Fn - sizes).expand(
        scores.shape[0], P)[..., None])
    return scores >= kth


#: The order in which the learner's program sums the 28 squares of a
#: projection's norm (jax 0.9.0, Fn = 28): four lanes by index mod 4,
#: fed with the groups of four features in this order, then the last
#: four features one by one after the lanes are added (found by scoring
#: every order of the groups against the learner's projections).
NORM_GROUPS_28 = (0, 2, 4, 3, 1, 5)


def _norm_chain(w: np.ndarray) -> np.float32:
    """|w| as the learner's program computes jnp.linalg.norm of a
    projection: at Fn = 28, fused multiply-adds of the squares into four
    lanes (NORM_GROUPS_28), the lanes added by halves, then the last four
    squares fused in order; at other Fn one chain (not identified)."""
    f = np.float32
    wd = w.astype(np.float64)

    def fma_sq(i, acc):
        return f(wd[i] * wd[i] + np.float64(acc))

    if w.shape[0] != 28:
        acc = f(0)
        for i in range(w.shape[0]):
            acc = fma_sq(i, acc)
        return np.sqrt(acc)
    lanes = [f(0)] * 4
    for g in NORM_GROUPS_28:
        for l in range(4):
            lanes[l] = fma_sq(4 * g + l, lanes[l])
    acc = f(f(lanes[0] + lanes[2]) + f(lanes[1] + lanes[3]))
    for i in range(24, 28):
        acc = fma_sq(i, acc)
    return np.sqrt(acc)


def solve_projections(SW: np.ndarray, SB: np.ndarray, reg: np.float32,
                      masks: np.ndarray) -> np.ndarray:
    """W f32 [P, Fn]: one projection per mask row (part (c), module
    docstring), on the host."""
    P, Fn = masks.shape
    out = np.zeros((P, Fn), np.float32)
    with flush_denormals():
        for p in range(P):
            out[p] = solve_steps(SW, SB, reg,
                                 masks[p].astype(np.float32))["W"]
    return out


def solve_steps(SW: np.ndarray, SB: np.ndarray, reg: np.float32,
                mf: np.ndarray) -> dict:
    """Every step of one projection's solve for the mask mf (f32 0/1
    [Fn]): SWp, SBp, L, A, M2, v, wp and W (NaN where a factorization
    fails, as jnp.linalg's); call under flush_denormals."""
    from scipy.linalg import blas, lapack

    f = np.float32
    Fn = mf.shape[0]
    MM = mf[:, None] * mf[None, :]
    out = {"SWp": (SW * MM + np.diag(f(1) - mf)) + reg * np.eye(Fn, dtype=f),
           "SBp": SB * MM}
    nan = np.full((Fn,), np.nan, f)
    # jnp.linalg.cholesky symmetrises its input.
    L, info = lapack.spotrf((out["SWp"] + out["SWp"].T) / f(2), lower=1,
                            clean=1)
    if info != 0:
        return dict(out, W=nan)
    out["L"] = L
    out["A"] = blas.strsm(f(1), L, out["SBp"], lower=1)
    M2 = blas.strsm(f(1), L, np.ascontiguousarray(out["A"].T), lower=1).T
    out["M2"] = M2 = f(0.5) * (M2 + M2.T)
    _, evecs, info = lapack.ssyevd(M2, compute_v=1, lower=1)
    if info != 0:
        return dict(out, W=nan)
    out["v"] = evecs[:, -1]
    wp = blas.strsm(f(1), np.ascontiguousarray(L.T), evecs[:, -1:],
                    lower=0)[:, 0] * mf
    out["wp"] = wp
    # XLA folds the mask's multiply into the division as a select: the
    # features off the mask are +0 whatever the solve left there.
    out["W"] = np.where(mf > 0, wp / np.maximum(_norm_chain(wp), f(1e-12)),
                        f(0))
    return out


class MHLDInputs(NamedTuple):
    """MHLD-oblique splits in the boosting loop (learners/gbt.py): the
    training rows' imputed numerical features (feature-major on the
    training device, row-major on the host for w^T x), their class ids
    and the settings; `make` builds it."""

    x_t: torch.Tensor           # f32 [Fn, n] on the training device
    x_host: np.ndarray          # f32 [n, Fn] on the host
    labels: torch.Tensor        # f32 [n] class ids on the training device
    num_classes: int
    num_projections: int        # P a tree
    max_attributes: int         # mhld_oblique_max_num_attributes
    spans: RowSpans             # the row dots' chains on the device

    @staticmethod
    def make(x_host: np.ndarray, labels: torch.Tensor, num_classes: int,
             num_projections: int, max_attributes: int = 4
             ) -> "MHLDInputs":
        dev = labels.device
        x_host = np.ascontiguousarray(x_host, np.float32)
        return MHLDInputs(
            torch.from_numpy(np.ascontiguousarray(x_host.T)).to(dev),
            x_host, labels, num_classes, num_projections, max_attributes,
            RowSpans.of(x_host.shape[0], dev))

    def masks(self, k_proj: torch.Tensor) -> np.ndarray:
        """bool [T, P, Fn] of every iteration from its k_proj [T, 2] (on
        the host)."""
        return subset_masks(k_proj.cpu(), self.num_projections,
                            self.x_t.shape[0], self.max_attributes).numpy()

    def sums(self, w: torch.Tensor) -> torch.Tensor:
        """The scatter sums at the row weights w (f32 [n], on the
        device) and w itself, packed into one f32 tensor: one host read
        (`scatter`)."""
        s = scatter_sums(self.x_t.t(), self.labels, w, self.num_classes,
                         self.spans)
        return torch.cat([s.num_c.reshape(-1), s.sxx.reshape(-1), s.n_c,
                          s.tot.reshape(1), w])

    def scatter(self, packed: np.ndarray
                ) -> Tuple[np.ndarray, np.ndarray, np.float32]:
        """(SW, SB, reg) from a host copy of `sums`."""
        C = max(self.num_classes, 2)
        Fn = self.x_t.shape[0]
        num_c = packed[:C * Fn].reshape(C, Fn)
        o = C * Fn
        sxx = packed[o:o + Fn * Fn].reshape(Fn, Fn)
        o += Fn * Fn
        n_c, tot, w = packed[o:o + C], packed[o + C], packed[o + C + 1:]
        num = fma_chain(w, self.x_host)
        with flush_denormals():
            return finish_scatter(num_c, sxx, n_c, tot, num)

    def solve(self, scatter, masks: np.ndarray) -> np.ndarray:
        """W f32 [P, Fn] of one iteration from `scatter`'s (SW, SB, reg)
        and its masks [P, Fn]."""
        return solve_projections(*scatter, masks)
