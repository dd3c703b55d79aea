"""Multi-device layout on ``torch.distributed`` (counterpart of
``libpointmatcher_tpu.parallel.sharding``).

The JAX package lays arrays out over a ``jax.sharding.Mesh`` and leaves the
collectives to XLA. Here a mesh is a process group, one rank per process:
each rank holds its shard of the data, runs the port's single-device ops
(and through them its kernels) on that shard, and merges the results with
explicit collectives. Every function takes the JAX function's arguments,
the full inputs on every rank (every JAX process holds the same batch), and
returns the replicated result. Each merge is exact: every exact route of
the port keeps the lowest index on ties, and a (least d², then lowest
global id) merge over contiguous shards keeps that rule, so each sharded
op returns the single-device op's result bit for bit.

**Transport.** The caller picks the group's backend in
``torch.distributed.init_process_group``; the port never switches it.
NCCL moves device tensors (it takes one rank per card). Gloo moves CPU
tensors: when a gloo group serves shards that live on a card, each
collective stages its operand through host memory, one copy in and one
copy back to the shard's device. That is a transport, not a fallback:
every kernel still runs on the card, and a collective that fails raises.

**Timeouts.** Every collective runs under its group's timeout: the
default group's from ``init_process_group(timeout=...)``, a mesh's from
:func:`make_mesh`'s ``timeout``, so a rank that hangs fails the others
within that time.
"""

from __future__ import annotations

from dataclasses import dataclass
from datetime import timedelta
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..cloud import PointCloud
from ..device import resolve_device
from ..ops import dispatch, sweep
from ..ops.tilesweep import (CID_ROW, PEN_ROW, TileAssign, gather_candidates,
                             live_columns, tile_nn1_from_candidates)

__all__ = ["Mesh", "ShardedCloud", "make_mesh", "shard_cloud",
           "replicate_cloud", "sharded_knn", "sharded_block_nn1",
           "sharded_tile_nn1", "sharded_nn1_sorted_v2",
           "pad_sweep_tables_for_mesh", "all_reduce", "all_gather",
           "merge_nn1", "merge_knn", "DEFAULT_TIMEOUT"]

#: the collectives' timeout of a mesh made without one
DEFAULT_TIMEOUT = timedelta(seconds=300)

_OPS = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN,
        "max": dist.ReduceOp.MAX}
_NO_ID = np.iinfo(np.int32).max


@dataclass(frozen=True)
class Mesh:
    """A one-axis mesh: the first ``size`` ranks of the default group.

    ``index`` is this rank's place on the axis, −1 on a rank outside the
    mesh (whose ``group`` is None; the drivers refuse it). ``device`` is
    where this rank's shards live."""

    group: Optional[object]
    axis_name: str
    size: int
    index: int
    device: torch.device
    backend: str

    @property
    def member(self) -> bool:
        return self.index >= 0

    @property
    def staged(self) -> bool:
        """True when collectives stage through host memory (gloo serving
        shards on a card)."""
        return self.backend == "gloo" and self.device.type != "cpu"

    def require(self, axis_name: Optional[str] = None) -> None:
        """Raise on a rank outside the mesh, or for another axis name."""
        if not self.member:
            raise ValueError(f"rank {dist.get_rank()} is outside this mesh of "
                             f"{self.size} ranks")
        if axis_name is not None and axis_name != self.axis_name:
            raise ValueError(f"mesh axis is {self.axis_name!r}, not "
                             f"{axis_name!r}")

    def span(self, n: int):
        """This rank's contiguous block of an axis of ``n`` (a multiple of
        the mesh size) → ``(start, stop)``."""
        local = n // self.size
        return self.index * local, (self.index + 1) * local


def make_mesh(n_devices: Optional[int] = None, axis_name: str = "points",
              device=None, timeout: timedelta = DEFAULT_TIMEOUT) -> Mesh:
    """A mesh of the first ``n_devices`` ranks of the default process group
    (all of them by default), from ``torch.distributed.new_group``, which
    every rank of the default group must call. ``device`` follows the
    port's rule: the card unless the caller asks for the CPU. Raises when
    no process group is initialised, and for an NCCL group on the CPU."""
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group: "
                           "call torch.distributed.init_process_group first")
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if not 1 <= n <= world:
        raise ValueError(f"a mesh of {n} ranks in a group of {world}")
    dev = resolve_device(device)
    group = dist.new_group(list(range(n)), timeout=timeout)
    rank = dist.get_rank()
    backend = str(dist.get_backend())
    if backend == "nccl" and dev.type == "cpu":
        raise ValueError("an NCCL group moves device tensors: make the mesh "
                         "on the card, or init the group with gloo")
    return Mesh(group if rank < n else None, axis_name, n,
                rank if rank < n else -1, dev, backend)


# ------------------------------------------------------------- collectives
def _to_transport(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """A private copy of ``t`` where the group's backend moves it."""
    return t.to("cpu", copy=True) if mesh.staged else t.clone()


def all_reduce(mesh: Mesh, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
    """``op`` ("sum", "min", "max") of ``t`` over the mesh → a new tensor
    on ``t``'s device."""
    x = _to_transport(mesh, t.contiguous())
    dist.all_reduce(x, op=_OPS[op], group=mesh.group)
    return x.to(t.device)


def all_gather(mesh: Mesh, t: torch.Tensor):
    """Every rank's ``t`` (the same shape on each) → a list of ``size``
    tensors on ``t``'s device, in rank order."""
    x = _to_transport(mesh, t.contiguous())
    out = [torch.empty_like(x) for _ in range(mesh.size)]
    dist.all_gather(out, x, group=mesh.group)
    return [o.to(t.device) for o in out]


def merge_nn1(mesh: Mesh, d: torch.Tensor, ids: torch.Tensor):
    """Each rank's 1-NN (squared distance, global id) → the least distance
    over the mesh and, among equal distances, the lowest id; (+inf, −1)
    where no rank found one. Two ``all_reduce(MIN)``."""
    gd = all_reduce(mesh, d, "min")
    cand = torch.where((d == gd) & (ids >= 0), ids, torch.full_like(ids, _NO_ID))
    gi = all_reduce(mesh, cand, "min")
    return gd, torch.where(gi == _NO_ID, torch.full_like(gi, -1), gi)


def merge_knn(mesh: Mesh, d: torch.Tensor, ids: torch.Tensor):
    """Each rank's ascending top-k ``[..., k]`` → the mesh's top-k: an
    ``all_gather`` of the distances and one of the ids, then a stable sort by distance of the lists laid side
    by side in rank order, so that among equal distances the lower rank,
    then the earlier slot, comes first; ids −1 where the distance is
    infinite."""
    k = d.shape[-1]
    cat_d = torch.cat(all_gather(mesh, d), dim=-1)
    cat_i = torch.cat(all_gather(mesh, ids), dim=-1)
    sd, pos = torch.sort(cat_d, dim=-1, stable=True)
    bd = sd[..., :k]
    bi = torch.gather(cat_i, -1, pos[..., :k])
    return bd, torch.where(torch.isfinite(bd), bi, torch.full_like(bi, -1))


# ------------------------------------------------------------ sharded clouds
class ShardedCloud(PointCloud):
    """This rank's contiguous rows of a cloud laid out over a mesh: the
    rows ``offset .. offset + num_points`` of a cloud of ``rows`` rows (a
    multiple of the mesh size; :func:`shard_cloud` pads with masked rows).

    The engine takes it as a reference: the matchers search its rows and
    merge over the mesh (:meth:`knn`, :meth:`merge`), and
    ``minimizers.gather_rows`` reads matched rows through :meth:`gather`,
    so ids are global row ids throughout."""

    __slots__ = ("offset", "rows", "mesh")

    def __init__(self, local: PointCloud, offset: int, rows: int, mesh: Mesh):
        super().__init__(local.points, local.mask, local.descriptors,
                         local.times)
        self.offset, self.rows, self.mesh = offset, rows, mesh

    def own(self, ids: torch.Tensor) -> torch.Tensor:
        """True where a global id lies in this rank's rows."""
        return (ids >= self.offset) & (ids < self.offset + self.num_points)

    def knn(self, query, query_mask, k: int = 1, epsilon: float = 0.0):
        """Exact k-NN of ``query`` [N, d] over the whole cloud: the port's
        dispatch (K1, K9, K5) on this rank's rows, ids made global, then
        :func:`merge_nn1` or :func:`merge_knn` → ``(d2 [N, k], ids [N, k])``."""
        d, i = dispatch.knn_search(query, query_mask, self.points, self.mask,
                                   k=k, epsilon=epsilon)
        return self.merge(d, torch.where(i >= 0, i + self.offset, i))

    def merge(self, d, ids):
        """Per-rank results ``[..., k]`` with global ids → the mesh's."""
        if d.shape[-1] == 1:
            gd, gi = merge_nn1(self.mesh, d[..., 0], ids[..., 0])
            return gd[..., None], gi[..., None]
        return merge_knn(self.mesh, d, ids)

    def gather(self, table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        """Rows ``ids [..., P]`` (global, ≥ 0) of a table of this cloud's
        rows ``[num_points, s]`` → ``[..., P, s]``, the same on every rank:
        each rank writes the rows it owns and −0.0 elsewhere, and one
        ``all_reduce(SUM)`` completes the gather. −0.0 is the identity of
        IEEE addition (x + −0.0 = x for every x, +0.0 and ±inf included),
        so the sum is exact whatever its order."""
        own = self.own(ids)
        local = torch.clamp(ids - self.offset, 0, self.num_points - 1)
        rows = table[local]
        rows = torch.where(own[..., None], rows, torch.full_like(rows, -0.0))
        return all_reduce(self.mesh, rows, "sum")

    def own_candidates(self, cand_t: torch.Tensor) -> torch.Tensor:
        """Tile candidate tables ``[..., 8, M]`` with every candidate that
        another rank owns given the +inf pad penalty (a new tensor)."""
        out = cand_t.clone()
        pen = out[..., PEN_ROW, :]
        ids = out[..., CID_ROW, :]
        out[..., PEN_ROW, :] = torch.where(self.own(ids.to(torch.int64)), pen,
                                           torch.full_like(pen, float("inf")))
        return out


def shard_cloud(cloud: PointCloud, mesh: Mesh,
                axis_name: str = "points") -> ShardedCloud:
    """This rank's rows of ``cloud``, on the mesh's device, after padding
    with masked rows to a multiple of the mesh size (as the JAX package
    pads with ``compact(min_size=)``): row ids stay those of ``cloud``."""
    mesh.require(axis_name)
    n = cloud.num_points
    rows = -(-n // mesh.size) * mesh.size
    lo, hi = mesh.span(rows)
    cloud = cloud.to(mesh.device)

    def part(x, fill=0):
        x = x[lo:min(hi, n)]
        if x.shape[0] < hi - lo:
            pad = torch.full((hi - lo - x.shape[0], *x.shape[1:]), fill,
                             dtype=x.dtype, device=x.device)
            x = torch.cat([x, pad])
        return x

    local = PointCloud(part(cloud.points), part(cloud.mask, False),
                       {k: part(v) for k, v in cloud.descriptors.items()},
                       {k: part(v) for k, v in cloud.times.items()})
    return ShardedCloud(local, lo, rows, mesh)


def replicate_cloud(cloud: PointCloud, mesh: Mesh) -> PointCloud:
    """The whole cloud on every rank, on the mesh's device."""
    mesh.require()
    return cloud.to(mesh.device)


# ------------------------------------------------------------- sharded ops
def sharded_knn(query, query_mask, ref, ref_mask, k: int, mesh: Mesh,
                axis_name: str = "points", tile_m: int = 2048):
    """Exact k-NN with the reference rows split over the mesh: each rank
    searches its contiguous rows through the port's dispatch (K1 for k = 1,
    K5 for k > 1), then the merge (two ``all_reduce(MIN)`` for k = 1, two
    ``all_gather`` and a stable sort for k > 1) → ``(d2 [N, k], ids [N,
    k])``, equal to :func:`..ops.dispatch.knn_search` on the whole
    reference bit for bit. ``ref``'s rows must divide the mesh, as the JAX
    package asserts. ``tile_m`` is the JAX sweep's tile and is not read."""
    mesh.require(axis_name)
    m = ref.shape[0]
    if m % mesh.size:
        raise ValueError(f"reference rows {m} must divide the mesh "
                         f"({mesh.size})")
    lo, hi = mesh.span(m)
    local = ShardedCloud(PointCloud(ref[lo:hi], ref_mask[lo:hi]), lo, m, mesh)
    return local.knn(query, query_mask, k=k)


def sharded_block_nn1(points, qb_rows, qb_nb_slots, blocks, block_ids,
                      max_dist: float, mesh: Mesh, axis_name: str = "points"):
    """Bounded-radius 1-NN with the query-block axis split over the mesh
    (:func:`..ops.cellblocks.block_nn1` on each rank's blocks). A query row
    belongs to one block, so the merge is ``all_reduce(MIN)`` of d² and
    ``all_reduce(MAX)`` of the id; equal to the single-device op bit for
    bit. The query-block axis must divide the mesh."""
    from ..ops.cellblocks import QueryBlocks, block_nn1

    mesh.require(axis_name)
    cq = qb_rows.shape[0]
    if cq % mesh.size:
        raise ValueError(f"query-block axis {cq} must divide the mesh "
                         f"({mesh.size})")
    lo, hi = mesh.span(cq)
    d, i = block_nn1(points, QueryBlocks(qb_rows[lo:hi], qb_nb_slots[lo:hi]),
                     blocks, block_ids, max_dist)
    return all_reduce(mesh, d, "min"), all_reduce(mesh, i, "max")


def _local_parents(assign: TileAssign, lo: int, hi: int, pad_unit: int):
    """The virtual tiles ``lo..hi`` of ``assign`` as a parent form of their
    own: the distinct parents among them, their query rows, and per parent
    its virtual tiles in order, padded with an appended all-pad virtual
    tile → ``(q_rows [Tp', TQ], blocks [hi−lo+1, B], vrows [K, Tp'])``."""
    par = np.asarray(assign.parent[lo:hi])
    uniq, inv = np.unique(par, return_inverse=True)
    order = np.argsort(inv, kind="stable")
    counts = np.bincount(inv, minlength=len(uniq))
    slot = np.arange(len(order)) - np.repeat(np.cumsum(counts) - counts, counts)
    vrows = np.full((max(int(counts.max(initial=0)), 1), len(uniq)), hi - lo,
                    np.int32)
    vrows[slot, inv[order]] = order
    blocks = np.concatenate([np.asarray(assign.blocks[lo:hi]),
                             np.full((1, assign.blocks.shape[1]), pad_unit,
                                     assign.blocks.dtype)])
    return np.asarray(assign.q_rows)[uniq], blocks, vrows


def sharded_tile_nn1(points, qmask, assign: TileAssign, units,
                     max_dist: float, mesh: Mesh, axis_name: str = "points"):
    """Bounded-radius 1-NN with the virtual-tile axis split over the mesh
    (the multi-device form of :func:`..ops.tilesweep.tile_nn1`, whose
    arguments it takes): each rank sweeps its virtual tiles with one K7
    launch, their parents' queries read and written by row, then the merge
    keeps the least d² and, among equal ones, the lowest row id, the rule
    by which K7 merges a parent's virtual tiles, so the result equals
    ``tile_nn1`` bit for bit. The virtual-tile axis must divide the mesh."""
    mesh.require(axis_name)
    tv = assign.blocks.shape[0]
    if tv % mesh.size:
        raise ValueError(f"tile axis {tv} must divide the mesh ({mesh.size})")
    lo, hi = mesh.span(tv)
    pad_unit = units.shape[0] - 1
    q_rows, blocks, vrows = _local_parents(assign, lo, hi, pad_unit)
    t = lambda a: torch.as_tensor(a, device=units.device)
    cand_t = gather_candidates(units, t(blocks))
    d, i = tile_nn1_from_candidates(
        points, qmask, t(q_rows), cand_t, max_dist, None, t(vrows),
        t(live_columns(blocks, pad_unit)))
    return merge_nn1(mesh, d, i)


def pad_sweep_tables_for_mesh(rt3, ct, n_dev: int):
    """Pad the survivor sweep's map tables (:mod:`..ops.sweep`, the JAX
    package's layout: ``rt3 [nch, 8, 128]``, ``ct [8, nch_pad]``) so that
    the chunk axis splits over ``n_dev`` ranks into multiples of 128 chunks
    (K2's lane group). Padding chunks are empty: +inf penalty row, ``FAR``
    box, count 0, so they never survive, never bind a bound and never win
    → numpy ``(rt3 [nch2, 8, 128], ct [8, nch2])``."""
    rt3 = np.asarray(rt3.cpu() if isinstance(rt3, torch.Tensor) else rt3,
                     np.float32)
    ct = np.asarray(ct.cpu() if isinstance(ct, torch.Tensor) else ct,
                    np.float32)
    nch = rt3.shape[0]
    local = -(-nch // (128 * n_dev)) * 128
    nch2 = local * n_dev
    if ct.shape[1] > nch2:
        raise ValueError(f"chunk table of {ct.shape[1]} chunks for {nch}")
    rt3_pad = np.zeros((nch2, rt3.shape[1], rt3.shape[2]), np.float32)
    rt3_pad[:nch] = rt3
    rt3_pad[nch:, 3, :] = np.inf          # penalty row: dead candidates
    ct_pad = np.full((ct.shape[0], nch2), np.float32(sweep.FAR))
    ct_pad[:, :ct.shape[1]] = ct
    ct_pad[6:, ct.shape[1]:] = 0.0        # count row: binds no k-bound
    return rt3_pad, ct_pad


def sharded_nn1_sorted_v2(qs, qm, ub_t, rt3, ct, mesh: Mesh,
                          axis_name: str = "points"):
    """The survivor sweep's exact 1-NN with the map's chunk axis split over
    the mesh: each rank runs :func:`..ops.sweep.nn1_sorted_v2` (K2, then K3,
    or K4 above ``SKIP_MAX_MPAD`` rows a rank) over its span of chunks with
    every query. A rank's bound is looser than the global one (its own
    chunks only), so more chunks survive; the result is still exact. Ids
    are made global (``id + index · local_nch · 128``) and merged by (least
    d², lowest id) → ``(d2 [..., n], ids [..., n])``. The tables must come
    from :func:`pad_sweep_tables_for_mesh`."""
    mesh.require(axis_name)
    nch = rt3.shape[0]
    if nch % mesh.size or (nch // mesh.size) % 128:
        raise ValueError(f"chunk axis {nch} must split into multiples of 128 "
                         f"over {mesh.size} ranks (pad_sweep_tables_for_mesh)")
    lo, hi = mesh.span(nch)
    local_nch = hi - lo
    d2, ids = sweep.nn1_sorted_v2(
        qs, qm, ub_t, rt3[lo:hi], ct[:, lo:hi].contiguous(),
        stream=local_nch * 128 > sweep.SKIP_MAX_MPAD)
    gids = torch.where(ids >= 0, ids + lo * 128, ids)
    return merge_nn1(mesh, d2, gids)
