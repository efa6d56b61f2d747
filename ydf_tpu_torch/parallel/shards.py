"""A training run's rows laid over a mesh, and the layer histograms
merged across shards and processes (the port's counterpart of what GSPMD
derives for the JAX package from its sharding annotations,
ydf_tpu/parallel/mesh.py).

Layout. The n rows are padded to a multiple of the data shards D (over
every process) and cut into D shards of m rows (parallel/mesh.py:
shard_rows); the bin matrix's columns are cut into the feature axis's
contiguous slices (column_slices). Device (i, j) of the mesh holds the
bins of data shard i and column slice j, u8 [F_j, m]. The padding rows
sit on the trash slot, so no histogram and no routing counts them.

A tree (TreeShards). The learner keeps its per-row state whole on the
mesh's first device (the sums that replay XLA's order run over the full
row order there: the root totals, the losses); a tree's histogram
operand is cut by rows to the shards (views on a single card), and every
layer:
  * each device launches the layer's kernel on its rows and columns in
    the wide mode (csrc/histogram.cu at the root, csrc/histogram_routed.cu
    deeper): the shard's unrounded sum, f64 for float stats, int32 for
    int8;
  * the merge adds the data shards' sums on the first device in shard
    order, then (several processes) gathers every process's sum and adds
    them in rank order, so the result does not depend on a collective's
    ring order; then it puts the column slices back in the grow order
    and rounds once. A float sum equals one device's f64 sum rounded
    once (but for a double-rounding case, as the single kernel's), an
    int8 sum exactly. (On a card the root kernel adds bf16x2 halves in
    f32 partials, so there a bf16x2 merge equals one device's only
    within that rounding; the learners' stats are f32.);
  * the split search (ops/grower.py: sibling subtraction, layer_decide)
    runs once, on the merged histogram, and its decision tables go to
    every device for the next layer's routed launch.
Under feature parallelism a row's direction is read by the device that
owns the split's column (the grow column's owner; the other slices
contribute zeros), added across the row's feature shards, and handed to
the routed kernel as its row-direction table (is_set / set_go_left): the
kernel then routes without reading a column it lacks. After the last
layer the leaf ids of every data shard are gathered on the first device,
in row order.

Per-tree columns (oblique projections, vector-sequence anchors) are
computed whole on the first device and cut the same way: the E extra
columns sit at grow position Fn (after the numericals), and slice j of
them goes to feature shard j.

Cross-device copies are asynchronous (peer copies on the card; none at
all when the shards share a card). Only the gloo merge across processes
stages through the host (mesh.host_staging), counted in HOST_STAGES.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from ydf_tpu_torch.ops import histogram_kernels
from ydf_tpu_torch.ops.histogram_kernels import RouteTables, route_plain
from ydf_tpu_torch.parallel.mesh import (
    Mesh, column_slices, host_staging, shard_rows)
from ydf_tpu_torch.utils import cuda_build

#: Gloo merges (and gathers) that staged a card's tensor through the host.
HOST_STAGES = 0


def _across_ranks(mesh: Mesh, t: torch.Tensor, combine: str) -> torch.Tensor:
    """Every process's `t` (the same shape) gathered, then added in rank
    order ("sum") or concatenated in rank order ("cat")."""
    global HOST_STAGES

    def combined(parts):
        if combine == "cat":
            return torch.cat(parts)
        acc = parts[0]
        for p in parts[1:]:
            acc = acc + p
        return acc

    dist = torch.distributed
    dev = t.device
    if mesh.backend == "nccl":
        out = t.new_empty((mesh.world,) + tuple(t.shape))
        dist.all_gather_into_tensor(out, t.contiguous())
        return combined(list(out.unbind(0)))
    # Gloo takes host tensors: the one place the loop waits on a card
    # (the copy out, the gather, the copy back).
    with host_staging(dev):
        host = t.contiguous().cpu()
        parts = [torch.empty_like(host) for _ in range(mesh.world)]
        dist.all_gather(parts, host)
        out = combined(parts).to(dev)
    if dev.type == "cuda":
        HOST_STAGES += 1
    return out


def owned_directions(bins_t: torch.Tensor, slot: torch.Tensor,
                     route_f: torch.Tensor, go_left: torch.Tensor,
                     owner: torch.Tensor, local: torch.Tensor
                     ) -> torch.Tensor:
    """Under feature parallelism, the go-left bit of every row whose
    slot splits on a column these bins hold, u8 [n] (0 for the other
    rows): bins_t u8 [Fk, n] the held columns, slot i32 [n], route_f i32
    [L+1] and go_left bool [L+1, B] the previous layer's tables, owner
    bool [F] which grow columns are held and local long [F] their row in
    bins_t. Adding every holder's bits gives each row's direction."""
    L1, B = go_left.shape
    s = slot.long().clamp(0, L1 - 1)
    rf = route_f.long()[s]
    b = torch.gather(bins_t, 0, local[rf][None, :])[0].long()
    gl = (b < B) & go_left.reshape(-1)[s * B + b.clamp(max=B - 1)]
    return (owner[rf] & gl).to(torch.uint8)


def direction_tables(tables: RouteTables,
                     directions: torch.Tensor) -> RouteTables:
    """`tables` with every row's direction given, u8 [n]: the routed
    kernel's row-direction table (is_set on every slot), so that it
    routes without reading a split's column. route_plain of these tables
    on bins of no columns ([0, n]) routes the same way without any."""
    return tables._replace(route_f=torch.zeros_like(tables.route_f),
                           is_set=torch.ones_like(tables.is_set),
                           set_go_left=directions)


class MeshRows:
    """The bin matrix of one training run over a mesh (module
    docstring): `bins_t` u8 [F, n] (any device), the first
    `num_numerical` columns numerical; every tree inserts `extra`
    columns at grow position num_numerical (oblique projections, anchor
    columns). The column maps are made here, before any loop."""

    def __init__(self, mesh: Mesh, bins_t: torch.Tensor,
                 num_numerical: Optional[int] = None, extra: int = 0):
        F, n = bins_t.shape
        dp, fp = mesh.devices.shape
        if fp > 1 and F < fp:
            raise ValueError(
                f"{F} feature columns cannot fill a feature axis of {fp}")
        self.mesh, self.n, self.F, self.E = mesh, n, F, extra
        self.Fn = F if num_numerical is None else num_numerical
        self.m, self.spans = shard_rows(mesh, n)
        self.cols = column_slices(F, fp)
        self.ecols = column_slices(extra, fp)
        self.bins = [[self.rows(bins_t[c0:c1], i, dim=1, j=j)
                      for j, (c0, c1) in enumerate(self.cols)]
                     for i in range(dp)]
        # Grow columns of feature shard j, in the grow order [numericals,
        # extra, the rest]: its slice's columns before Fn, its slice of
        # the extra columns, its slice's columns from Fn on.
        at, self.split_at, gcols = self.Fn, [], []
        for (c0, c1), (e0, e1) in zip(self.cols, self.ecols):
            k = min(max(at - c0, 0), c1 - c0)
            self.split_at.append(k)
            gcols.append(list(range(c0, c0 + k))
                         + list(range(at + e0, at + e1))
                         + [c + extra for c in range(c0 + k, c1)])
        self.perm = self.owner = self.local = None
        if fp > 1:
            Ft = F + extra
            flat = [g for cols in gcols for g in cols]
            self.perm = torch.argsort(torch.tensor(flat)).to(
                self.first_device)
            self.owner, self.local = [], []
            for i in range(dp):
                own_row, loc_row = [], []
                for j in range(fp):
                    own = torch.zeros(Ft, dtype=torch.bool)
                    loc = torch.zeros(Ft, dtype=torch.long)
                    own[gcols[j]] = True
                    loc[gcols[j]] = torch.arange(len(gcols[j]))
                    own_row.append(own.to(self.devices[i, j]))
                    loc_row.append(loc.to(self.devices[i, j]))
                self.owner.append(own_row)
                self.local.append(loc_row)
        self._start = {}
        if mesh.world > 1 and mesh.backend == "nccl":
            # The first collective builds NCCL's communicator: here, not
            # inside the loop.
            _across_ranks(mesh, torch.zeros(1, device=self.first_device),
                          "sum")

    @property
    def devices(self):
        return self.mesh.devices

    @property
    def first_device(self) -> torch.device:
        return self.mesh.first_device

    def rows(self, x: torch.Tensor, i: int, dim: int = 0,
             j: int = 0) -> torch.Tensor:
        """Local data shard i's rows of x (whole rows on `dim`), padded
        with zeros to m rows, on device (i, j)."""
        r0, r1 = self.spans[i]
        part = x.narrow(dim, r0, r1 - r0)
        if r1 - r0 < self.m:
            shape = list(part.shape)
            shape[dim] = self.m - (r1 - r0)
            part = torch.cat([part, part.new_zeros(shape)], dim=dim)
        return part.to(self.devices[i, j], non_blocking=True).contiguous()

    def start_state(self, L: int):
        """Each device's first slots (padding rows on the trash slot L)
        and leaf ids, i32 [m]; made once a frontier size, read only."""
        if L not in self._start:
            dp, fp = self.devices.shape
            state = []
            for i in range(dp):
                real = self.spans[i][1] - self.spans[i][0]
                row = []
                for j in range(fp):
                    dev = self.devices[i, j]
                    slot = torch.zeros(self.m, dtype=torch.int32, device=dev)
                    slot[real:].fill_(L)
                    row.append((slot, torch.zeros(self.m, dtype=torch.int32,
                                                  device=dev)))
                state.append(row)
            self._start[L] = state
        return self._start[L]

    def for_tree(self, extra: Optional[torch.Tensor] = None
                 ) -> "TreeShards":
        """One tree's columns: the run's bins with the tree's `extra` u8
        [E, n] (on the first device) inserted after the numericals."""
        if (0 if extra is None else extra.shape[0]) != self.E:
            raise ValueError(f"the mesh rows were laid out for {self.E} "
                             "extra columns a tree")
        return TreeShards(self, extra)


class TreeShards:
    """One tree's sharded rows (module docstring): grow_tree's `shards=`
    argument. `begin` cuts the histogram operand to the shards; `root`,
    `routed` and `route_last` run a layer on every device; `leaf_ids`
    gathers the rows' leaves on the first device."""

    def __init__(self, rows: MeshRows, extra: Optional[torch.Tensor]):
        self.rows = rows
        dp, fp = rows.devices.shape
        self.F = rows.F + rows.E
        self.perm, self.owner, self.local = rows.perm, rows.owner, rows.local
        self.bins = [[None] * fp for _ in range(dp)]
        for j, (e0, e1) in enumerate(rows.ecols):
            k = rows.split_at[j]
            for i in range(dp):
                b = rows.bins[i][j]
                if rows.E:
                    b = torch.cat([b[:k], rows.rows(extra[e0:e1], i, dim=1,
                                                    j=j), b[k:]])
                self.bins[i][j] = b

    # -- a layer --------------------------------------------------------- #

    def begin(self, op: torch.Tensor, L: int, qscale=None) -> None:
        """Cuts the histogram operand op [n, S'] (on the first device) to
        the shards, and sets every row on the root slot (the int8 scale
        `qscale` is applied after the merge, by the grower)."""
        rows = self.rows
        dp, fp = rows.devices.shape
        self.op = [[rows.rows(op, i, j=j) for j in range(fp)]
                   for i in range(dp)]
        self.state = [list(r) for r in rows.start_state(L)]

    def _merge(self, parts) -> torch.Tensor:
        """parts[i][j]: device (i, j)'s wide sum [Ls, F_j, B, S'] -> the
        merged accumulator [Ls, F, B, S'] on the first device, rounded
        once to the accumulator type (f32, or int32 for int8)."""
        mesh = self.rows.mesh
        first = self.rows.first_device
        timer = cuda_build.launch_timer("mesh_merge")
        cols = []
        for j in range(len(parts[0])):
            acc = parts[0][j].to(first, non_blocking=True)
            for i in range(1, len(parts)):
                acc = acc + parts[i][j].to(first, non_blocking=True)
            cols.append(acc)
        merged = cols[0] if len(cols) == 1 else torch.cat(cols, dim=1)
        if mesh.world > 1:
            merged = _across_ranks(mesh, merged, "sum")
        if self.perm is not None:
            merged = merged.index_select(1, self.perm)
        if merged.dtype == torch.float64:
            merged = merged.to(torch.float32)
        cuda_build.launch_done(timer)
        return merged

    def root(self, Ld: int, B: int) -> torch.Tensor:
        """The root layer's merged accumulator [Ld, F, B, S']."""
        dp, fp = self.rows.devices.shape
        parts = [[histogram_kernels.histogram(
            self.bins[i][j], self.state[i][j][0], self.op[i][j], Ld, B,
            wide=True) for j in range(fp)] for i in range(dp)]
        return self._merge(parts)

    def _tables(self, tables: RouteTables, i: int, B: int) -> List:
        """Data shard i's decision tables on each of its devices; under
        feature parallelism with each row's direction read from the
        owner of its split's column."""
        devs = self.rows.devices[i]
        tabs = [RouteTables(*(t.to(d, non_blocking=True) for t in tables))
                for d in devs]
        if self.owner is None:
            return tabs
        dirs = [owned_directions(self.bins[i][j], self.state[i][j][0],
                                 t.route_f, t.go_left, self.owner[i][j],
                                 self.local[i][j])
                for j, t in enumerate(tabs)]
        d = dirs[0]
        for x in dirs[1:]:
            d = d + x.to(d.device, non_blocking=True)
        return [direction_tables(t, d.to(devs[j], non_blocking=True))
                for j, t in enumerate(tabs)]

    def routed(self, tables: RouteTables, Lh: int, B: int) -> torch.Tensor:
        """A deeper layer: the previous layer's `tables` applied to every
        shard's rows, fused with this layer's histogram of Lh hist slots;
        the merged accumulator [Lh, F, B, S']."""
        dp, fp = self.rows.devices.shape
        parts = []
        for i in range(dp):
            tabs = self._tables(tables, i, B)
            row = []
            for j in range(fp):
                slot, leaf = self.state[i][j]
                hist, slot, leaf = histogram_kernels.histogram_routed(
                    self.bins[i][j], slot, leaf, tabs[j], self.op[i][j], Lh,
                    B, wide=True)
                self.state[i][j] = (slot, leaf)
                row.append(hist)
            parts.append(row)
        return self._merge(parts)

    def route_last(self, tables: RouteTables, B: int) -> None:
        """The last layer's standalone route of every shard's rows."""
        dp, fp = self.rows.devices.shape
        for i in range(dp):
            tabs = self._tables(tables, i, B)
            for j in range(fp):
                slot, leaf = self.state[i][j]
                self.state[i][j] = (slot, route_plain(
                    self.bins[i][j], slot, leaf, tabs[j])[1])

    def leaf_ids(self) -> torch.Tensor:
        """Every row's leaf, i32 [n], on the first device in row order."""
        rows = self.rows
        first = rows.first_device
        local = torch.cat([self.state[i][0][1].to(first, non_blocking=True)
                           for i in range(len(self.state))])
        if rows.mesh.world > 1:
            local = _across_ranks(rows.mesh, local, "cat")
        return local[:rows.n]
