"""Sparse-oblique projections (counterpart of ydf_tpu/ops/oblique.py and
of the per-tree projection step the JAX package's GBT, random forest and
isolation forest learners share).

A tree with sparse-oblique splits gets P extra numerical candidates, the
projections z = x_raw . w_p of the imputed numerical features x_raw on P
random sparse vectors w_p (the reference's SampleProjection,
ydf/learner/decision_tree/oblique.cc): `sample_projection_coefficients`
draws them, `projection_columns` computes and bins them.

The sampler draws, from the tree's key, k_m, k_s = split(key): an
inclusion mask bernoulli(k_m, min(density / max(Fn, 1), 1), (P, Fn)),
with projection p forced onto feature p mod Fn when it drew none, and
coefficients from k_s by weight type: BINARY +-1, POWER_OF_TWO +-2^e
(k_e, k_sign = split(k_s); e = randint(k_e, lo, hi + 1)), INTEGER
randint(k_s, lo, hi + 1), CONTINUOUS uniform(k_s, -1, 1). W = wts * mask,
which jnp computes as a select: a dropped coefficient is +0.0 whatever
its weight's sign. The words depend on the key alone, so a learner draws
every tree's W before its loop.

The projection is XLA's CPU dot `x_raw @ W.T` as jax 0.9.0 computes it
(`xla_dot`): Fn fused multiply-adds spread over `dot_lanes(Fn, P)`
interleaved accumulators, summed pairwise; a tail of Fn mod lanes terms
is summed the same way with half the lanes and added last. The lane
count depends mostly on P (4 up to 24 and from 33 to 48, 2 from 25 to
32, 1 from 49; train_default's P = 28 takes 2), found by trying lane
counts against jax.jit on a grid of (Fn, P) and held bitwise on 14
shapes in tests/test_torch_oblique.py. Serving computes the projection
differently, as the JAX package's routing does (ops/routing.py).

Boundaries: the random forest and GBT take the projection's quantiles at
linspace(1/B, 1 - 1/B, B - 1) (prng.quantile_linear and linspace_f32,
the learners' in-jit forms); the isolation forest spaces B - 1 uniform
cuts over the subsample's range, zmin + max(zmax - zmin, 1e-12) * i / B.
The columns are binned by the binning kernel (ops/binning.py,
csrc/binning.cu on a card): for values without NaN its
#{b : boundary_b <= z} is jnp.searchsorted(side="right").
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ydf_tpu_torch.ops import binning
from ydf_tpu_torch.utils import prng
from ydf_tpu_torch.utils.xla_cpu import fma_f32

WEIGHT_TYPES = ("BINARY", "CONTINUOUS", "POWER_OF_TWO", "INTEGER")
#: The weight ranges the reference's proto defaults give POWER_OF_TWO
#: (exponents) and INTEGER (values) when none is passed.
DEFAULT_RANGES = {"POWER_OF_TWO": (-3, 3), "INTEGER": (-5, 5)}


def check_weight_type(weight_type: str) -> None:
    if weight_type not in WEIGHT_TYPES:
        raise ValueError(
            f"Unknown sparse_oblique_weights {weight_type!r}")


def num_projections(num_numerical: int, exponent: float,
                    max_projections: int) -> int:
    """P = min(max(ceil(Fn ** exponent), 2), max_projections), the
    learners' projection count."""
    P = int(np.ceil(num_numerical ** exponent))
    return min(max(P, 2), max_projections)


def sample_projection_coefficients(
    key: torch.Tensor, P: int, Fn: int, density: float = 2.0,
    weight_type: str = "BINARY",
    weight_range: Optional[Tuple[int, int]] = None,
    monotone_vec: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """W f32 [..., P, Fn] from keys [..., 2] (module docstring).
    weight_range: (min, max) exponent for POWER_OF_TWO, (min, max) value
    for INTEGER; the reference's defaults when None. monotone_vec: f32
    [Fn] monotone directions (+1, -1, 0) on the keys' device: a
    coefficient on a constrained feature takes the constraint's sign
    (|w| * d), so the projection increases with every constrained
    input."""
    check_weight_type(weight_type)
    ks = prng.split(key)
    k_m, k_s = ks[..., 0, :], ks[..., 1, :]
    p_incl = min(density / max(Fn, 1), 1.0)
    mask = prng.bernoulli(k_m, p_incl, (P, Fn))
    forced = (torch.arange(P, device=key.device)[:, None] % Fn
              == torch.arange(Fn, device=key.device)[None, :])
    mask = mask | (~mask.any(dim=-1, keepdim=True) & forced)
    lo, hi = weight_range or DEFAULT_RANGES.get(weight_type, (0, 0))
    if weight_type == "BINARY":
        wts = torch.where(prng.bernoulli(k_s, 0.5, (P, Fn)), 1.0, -1.0)
    elif weight_type == "POWER_OF_TWO":
        kk = prng.split(k_s)
        e = prng.randint(kk[..., 0, :], (P, Fn), lo, hi + 1)
        sign = torch.where(prng.bernoulli(kk[..., 1, :], 0.5, (P, Fn)),
                           1.0, -1.0)
        wts = sign * torch.exp2(e.to(torch.float32))
    elif weight_type == "INTEGER":
        wts = prng.randint(k_s, (P, Fn), lo, hi + 1).to(torch.float32)
    else:  # CONTINUOUS: 2 u - 1 is exact, contracted or not
        wts = prng.uniform(k_s, (P, Fn)) * 2.0 - 1.0
    if monotone_vec is not None:
        wts = torch.where(monotone_vec != 0, wts.abs() * monotone_vec, wts)
    return torch.where(mask, wts, 0.0).to(torch.float32)


class ObliqueInputs(NamedTuple):
    """Sparse-oblique splits: the training rows' imputed numerical
    features on the training device and the sampler's settings
    (ops/oblique.py)."""

    x_t: torch.Tensor           # f32 [Fn, n] feature-major
    num_projections: int        # P a tree
    density: float = 2.0
    weight_type: str = "BINARY"
    weight_range: Optional[tuple] = None
    monotone_vec: Optional[torch.Tensor] = None  # f32 [Fn] on the device

    def weights(self, keys: torch.Tensor) -> torch.Tensor:
        """W f32 [T, P, Fn] of every iteration from its k_proj [T, 2]."""
        return sample_projection_coefficients(
            keys, self.num_projections, self.x_t.shape[0],
            density=self.density, weight_type=self.weight_type,
            weight_range=self.weight_range, monotone_vec=self.monotone_vec)


def dot_lanes(Fn: int, P: int) -> int:
    """Interleaved accumulators of XLA's CPU dot [n, Fn] x [Fn, P]
    (module docstring); under 4 features one chain, and a tail of 1 or 2
    features changes the count at P 17-24 (2) and, below 10 features,
    at P 33-48 (1)."""
    tail = Fn % 4
    if Fn < 4 or P >= 49 or (33 <= P <= 48 and tail in (1, 2)
                             and Fn < 10):
        return 1
    if 25 <= P <= 32 or (17 <= P <= 24 and tail in (1, 2)):
        return 2
    return 4


def _lane_sum(terms, lanes: int):
    """Fused multiply-adds of (x_k, w_k) pairs spread over `lanes`
    accumulators, summed pairwise; the tail beyond a multiple of the
    lanes summed with half as many, added last."""
    terms = list(terms)
    if not terms:
        return None
    main = len(terms) - len(terms) % lanes
    total = None
    if main:
        acc = [None] * lanes
        for k in range(main):
            x, w = terms[k]
            i = k % lanes
            acc[i] = (x * w).to(torch.float32) if acc[i] is None \
                else fma_f32(x, w, acc[i])
        while len(acc) > 1:
            acc = [acc[i] + acc[i + 1] for i in range(0, len(acc), 2)]
        total = acc[0]
    if main < len(terms):
        tail = _lane_sum(terms[main:], max(lanes // 2, 1))
        total = tail if total is None else total + tail
    return total


def xla_dot(x_t: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """z f32 [P, n] = (x @ W.T).T for the feature-major x_t f32 [Fn, n]
    and W f32 [P, Fn], in XLA's CPU order (module docstring). Products
    and sums are formed in f64 and rounded once to f32, the fused
    multiply-add."""
    Fn, n = x_t.shape
    P = W.shape[0]
    if Fn == 0:
        return torch.zeros((P, n), dtype=torch.float32, device=x_t.device)
    xd, wd = x_t.double(), W.double()
    # x * w is exact in f64: the first term of a lane is its product
    # rounded once, fma(x, w, 0).
    z = _lane_sum(((xd[k][None, :], wd[:, k][:, None]) for k in range(Fn)),
                  dot_lanes(Fn, P))
    return z.contiguous()


def _bin(z: torch.Tensor, bounds: torch.Tensor) -> torch.Tensor:
    """u8 [P, n] bins of z f32 [P, n] under bounds f32 [P, B-1]: the
    binning kernel (no NaN reaches it: x_raw is imputed)."""
    P = z.shape[0]
    dev = z.device
    nb = torch.full((P,), bounds.shape[1], dtype=torch.int32, device=dev)
    impute = torch.zeros((P,), dtype=torch.float32, device=dev)
    return binning.bin_columns(z, bounds.contiguous(), nb, impute).t()


def quantile_bounds(z: torch.Tensor, qs: torch.Tensor,
                    loop_of_one: bool = False) -> torch.Tensor:
    """f32 [P, B-1]: each projection's quantiles at qs (the GBT's and
    random forest's jnp.quantile(z, qs, axis=0).T; `loop_of_one`: the
    contraction of a learner loop of one step, prng.quantile_linear)."""
    return prng.quantile_linear(z, qs, dim=1,
                                contract_high=loop_of_one).t().contiguous()


def uniform_bounds(z: torch.Tensor, num_bins: int) -> torch.Tensor:
    """f32 [P, B-1]: B - 1 cuts spread evenly over each projection's
    range, the isolation forest's zmin + max(zmax - zmin, 1e-12) * i / B
    for i in [1, B), the multiply-add fused as XLA compiles it in the
    learner's loop (of any length)."""
    zmin = z.amin(dim=1)
    zmax = z.amax(dim=1)
    qs = torch.arange(1, num_bins, dtype=torch.float32,
                      device=z.device) / float(num_bins)
    span = torch.clamp_min(zmax - zmin, float(np.float32(1e-12)))
    return fma_f32(span[:, None], qs[None, :], zmin[:, None]).contiguous()


def projection_columns(x_t: torch.Tensor, W: torch.Tensor,
                       qs: Optional[torch.Tensor] = None,
                       num_bins: int = 256,
                       bounds: Optional[torch.Tensor] = None,
                       loop_of_one: bool = False
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(bins u8 [P, n], boundaries f32 [P, B-1]) of the projections of
    x_t f32 [Fn, n] (feature-major, imputed) on W f32 [P, Fn]. The
    boundaries are `bounds` when given (validation rows binned under the
    training rows' cuts), else the quantiles at `qs`, else the uniform
    cuts of `num_bins` bins; `loop_of_one` picks the quantiles' rounding
    in the JAX learner's loop of one step (quantile_bounds)."""
    z = xla_dot(x_t, W)
    if bounds is None:
        bounds = (quantile_bounds(z, qs, loop_of_one) if qs is not None
                  else uniform_bounds(z, num_bins))
    return _bin(z, bounds), bounds


def raw_numerical(ds, binner) -> np.ndarray:
    """f32 [n, Fn]: the rows' numerical features, missing values imputed,
    an absent column at its imputation value (the learners' enc_raw)."""
    Fn = binner.num_numerical
    x = np.zeros((ds.num_rows, Fn), np.float32)
    for i, name in enumerate(binner.feature_names[:Fn]):
        if ds.dataspec.has_column(name) and name in ds.data:
            x[:, i] = ds.encoded_numerical(name)
        else:
            x[:, i] = binner.impute_values[i]
    return x


def feature_ids(feature: torch.Tensor, Fn: int, F: int,
                P: int) -> torch.Tensor:
    """Grown feature ids ([numericals, P projections, the rest], the
    grow-time layout) -> the forest's ([numericals, the rest,
    projections]): the projection block moves after the F real
    features."""
    proj = (feature >= Fn) & (feature < Fn + P)
    return torch.where(proj, feature - Fn + F,
                       torch.where(feature >= Fn + P, feature - P, feature))
