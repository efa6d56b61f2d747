"""The run sums of ydf_tpu_torch/ops/segment_sum.py at the shapes a tiled
kernel gets wrong (chip_smoke.SEGMENT_EDGE_SHAPES, laid out on the tile
of segment_sum.tile_entries, the one place the kernel's tile is set).

On the CPU the plain version is held against a Python loop that adds
each run in order from +0 (one f32 rounding an add); on a card
csrc/segment_sum.cu is held against the plain version on the same
tensors, one launch a call. Tolerance: bitwise, a NaN equal to any NaN
(chip_smoke.same_bits; x86 and the card make NaNs of other payloads).
The per-item sums against the JAX package's einsum are in
test_torch_categorical_set.py.

Tests marked `gpu` need a card (run on one with
`python -m pytest --noconftest -m gpu tests/test_torch_*.py`).
"""

import importlib.util
import os
import re

import numpy as np
import pytest
import torch

from ydf_tpu_torch.ops import grower, segment_sum

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


smoke = load_chip_smoke()
SHAPES = smoke.SEGMENT_EDGE_SHAPES
STATS = smoke.SEGMENT_EDGE_STATS


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")


def run_sums_loop(key, vals):
    """Each run's values added in order from +0 in f32, at its head."""
    want = np.zeros_like(vals)
    i = 0
    with np.errstate(all="ignore"):
        while i < len(key):
            j, acc = i, np.zeros(vals.shape[1], np.float32)
            while j < len(key) and key[j] == key[i]:
                acc = acc + vals[j]
                j += 1
            want[i] = acc
            i = j
    return want


@pytest.mark.parametrize("S", STATS)
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_run_sums_at_tile_edges(shape, S):
    """segment_sums on CPU tensors (the plain version) against the
    Python loop, bitwise, with the runs on the kernel's tile edges."""
    key, vals = smoke.segment_edge_case(shape, S, segment_sum.tile_entries(S))
    got = segment_sum.segment_sums(torch.from_numpy(key),
                                   torch.from_numpy(vals))
    assert got.shape == vals.shape
    assert smoke.same_bits(got, run_sums_loop(key, vals))


def test_edge_cases_put_runs_where_they_say():
    """The shapes' runs end on a tile edge, one past it, at the end of the
    chunk the kernel carries a run through, span more than three tiles,
    are all of one, and E is 1, below a tile or an exact multiple of it;
    a run of -0 sums to +0."""
    T = segment_sum.tile_entries(3)
    ends = {}
    for shape in SHAPES:
        key, _ = smoke.segment_edge_case(shape, 3, T)
        head = np.r_[True, key[1:] != key[:-1]]
        ends[shape] = (np.flatnonzero(np.r_[head[1:], True]) + 1, key.size,
                       np.diff(np.r_[np.flatnonzero(head), key.size]))
    assert {T, 2 * T, 3 * T} <= set(ends["tile_edge"][0])
    assert {T + 1, 3 * T + 1} <= set(ends["past_edge"][0])
    assert T + min(segment_sum.CONT, T) in set(ends["chunk_edge"][0])
    assert ends["long_run"][2].max() > 3 * T
    assert (ends["ones"][2] == 1).all() and ends["ones"][1] > T
    assert ends["one"][1] == 1
    assert 1 < ends["small"][1] < T
    assert ends["tile_multiple"][1] == 2 * T
    _, vals = smoke.segment_edge_case("specials", 3, T)
    assert np.isnan(vals).any() and np.isinf(vals).any()
    assert ((vals != 0) & (np.abs(vals) < np.finfo(np.float32).tiny)).any()
    got = segment_sum.segment_sums(
        torch.from_numpy(smoke.segment_edge_case("specials", 3, T)[0]),
        torch.from_numpy(vals))
    assert (np.signbit(vals[:5]).all()
            and not np.signbit(got[0].numpy()).any())


def test_tile_mirrors_the_kernel_source():
    """segment_sum.py's shared-memory mirror holds the constants of
    csrc/segment_sum.cu, and every tile it picks is a multiple of 4 that
    fits (the full TILE up to S = 9)."""
    src = open(os.path.join(REPO, "ydf_tpu_torch", "csrc",
                            "segment_sum.cu")).read()
    assert re.search(r"constexpr int kCont = (\d+);", src).group(1) == str(
        segment_sum.CONT)
    assert eval(re.search(r"constexpr int kSmemLimit = ([\d -]+);",
                          src).group(1)) == segment_sum.SHARED_LIMIT
    assert re.search(r"constexpr int kMaxTile = (\d+);", src).group(1) == str(
        segment_sum.MAX_TILE)
    for S in list(range(1, 65)) + [100, 500, 2000]:
        T = segment_sum.tile_entries(S)
        assert T % 4 == 0 and T >= 4
        assert segment_sum.shared_bytes(T, S) <= segment_sum.SHARED_LIMIT
        assert S > 9 or T == segment_sum.TILE


@pytest.mark.gpu
@pytest.mark.parametrize("S", STATS)
@pytest.mark.parametrize("shape", SHAPES)
def test_kernel_run_sums_at_tile_edges(shape, S):
    """csrc/segment_sum.cu bitwise to the plain version on the card at
    the edge shapes, one launch a call."""
    _need_card()
    key, vals = (torch.from_numpy(a).cuda() for a in smoke.segment_edge_case(
        shape, S, segment_sum.tile_entries(S)))
    before = segment_sum.KERNEL_LAUNCHES
    got = segment_sum.segment_sums(key, vals)
    torch.cuda.synchronize()
    assert segment_sum.KERNEL_LAUNCHES == before + 1
    assert smoke.same_bits(got, segment_sum.segment_sums_plain(key, vals))


@pytest.mark.gpu
@pytest.mark.parametrize("S", [1, 3, 9])
def test_kernel_run_sums_on_unaligned_views(S):
    """Views that start one entry in (not 16-byte aligned) take the
    kernel's scalar copies, with the same sums."""
    _need_card()
    T = segment_sum.tile_entries(S)
    key, vals = (torch.from_numpy(a).cuda() for a in smoke.segment_edge_case(
        "past_edge", S, T))
    key, vals = key[1:], vals[1:]
    got = segment_sum.segment_sums(key, vals)
    torch.cuda.synchronize()
    assert smoke.same_bits(got, segment_sum.segment_sums_plain(key, vals))


def set_rows(n, Fs, Ws, rng):
    """Packed set rows i32 [n, Fs, Ws]: Zipf-like items, 0-20 a row."""
    V = 32 * Ws
    p = 1.0 / np.arange(1, V + 1) ** 1.1
    multi = np.zeros((n, Fs, V), bool)
    for f in range(Fs):
        for i in range(n):
            multi[i, f, rng.choice(V, rng.integers(0, 21), p=p / p.sum())] = 1
    words = (multi.reshape(n, Fs, Ws, 32).astype(np.uint64)
             << np.arange(32, dtype=np.uint64)).sum(-1).astype(np.uint32)
    return torch.from_numpy(words.view(np.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("Ld", [1, 8])
def test_set_item_stats_launch_the_kernel_twice(Ld):
    """grower.set_item_stats on the card: both run sums (the (block,
    slot, item) runs, then each (slot, item)'s blocks) through the
    kernel, two launches, the per-item sums bitwise to the CPU's."""
    _need_card()
    rng = np.random.default_rng(Ld)
    n = 40_000
    sets = set_rows(n, 2, 3, rng)
    slot = torch.from_numpy(rng.integers(0, Ld + 1, n).astype(np.int32))
    stats = torch.from_numpy(np.stack([
        rng.normal(size=n), rng.uniform(0.05, 0.25, n), np.ones(n)],
        1).astype(np.float32))
    want = grower.set_item_stats(grower.set_members(sets), slot, stats, Ld)
    before = segment_sum.KERNEL_LAUNCHES
    got = grower.set_item_stats(grower.set_members(sets.cuda()),
                                slot.cuda(), stats.cuda(), Ld)
    torch.cuda.synchronize()
    assert segment_sum.KERNEL_LAUNCHES == before + 2
    assert smoke.same_bits(got, want)
