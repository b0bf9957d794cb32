"""Vertex-state layout — who holds each per-vertex statistic — and the
collectives of the sharded engine.

The port of the reference's ``core/vertex_layout.py``. Every
maintenance round is "edge pass -> per-vertex decision -> commit": the
edge pass produces PARTIAL per-vertex statistics (each rank scatters
only its own slots of the table), and the layout completes them:

* ``ReplicatedVertices`` — every rank keeps the full ``[n]`` vertex
  state, and a partial statistic completes with one ``all_reduce(SUM)``
  over the mesh's ``"data"`` group (``axis``); ``axis=None`` is the
  single-device identity.

* ``HaloShardedVertices`` (``vertex_sharding="range"``) — rank ``i``
  OWNS the contiguous vertex range ``[i * n_owned, (i+1) * n_owned)`` and
  keeps beyond it only a per-batch HALO working set: the vertices its
  windowed slots and the batch lanes reference, in a pow2-capped buffer
  (``HaloSession``). No rank holds an ``[n]`` vertex array: memory is
  O(n / world + halo_cap). A round's statistics complete with one
  ``all_gather`` of the halo-domain partials plus a local owner
  scatter-add; the halo values are refreshed by one
  ``reduce_scatter`` of the owners' contributions (the dense regather,
  O(halo_cap) received); labels place by the ring
  ``order.place_block_ring``. Integer arithmetic throughout, so the
  cores and labels are bit for bit those of the replicated layout
  (but for a renumber when phantom vertices pad ``n``: the ring ranks
  them too, which offsets the labels and keeps the k-order, as the
  reference's range engine does).

The reference runs one program over a ``jax.sharding.Mesh``; the port
is SPMD: every rank runs the same Python, and ``axis`` is a
``torch.distributed`` process group. The reference's collectives map
one to one: ``psum`` -> ``all_reduce(SUM)``, ``pmax`` / ``pmin`` ->
``all_reduce(MAX / MIN)``, ``all_gather`` -> ``all_gather`` (stacked to
``[world, ...]``), ``psum_scatter(tiled=False)`` ->
``reduce_scatter_tensor``, ``axis_index`` -> the rank in the group.
Masks and flags travel as int32 or uint8: gloo and NCCL do not both
reduce ``bool``. The reference's ``lax.while_loop`` conditions become
Python loops on an all-reduced verdict (``any_owned``), so every rank
runs the same rounds and issues the same collectives in the same order.
The 2-axis ``"halo"`` layout (``edge_axes``) is ROADMAP Queue 1 B item
3, the sparse frontier exchange (``frontier_cap``) item 4.

Traffic accounting
------------------
``record_traffic()`` records one ``Traffic(op, recv_bytes)`` per
collective issued inside it, with the payload each rank RECEIVES. The
reference records at trace time, once per traced loop body (so its log
of a fixpoint is the per-round budget); the port records at call time,
once per collective actually issued. The layout's records carry the
reference's op names and bytes (``psum``; ``gather_halo``,
``regather``, ``gather_stats``, ``psum_scalar``, ``pmax_scalar``, and
the ring's ``ppermute`` and ``pmin_scalar``); the table collectives of
the batch program, which the reference does not record, are
``"psum_table"`` (found flags and counts), ``"psum_vertex"`` (the range
program's owned counts), ``"pmax_scalar"`` (the high-water mark) and
``"gather_freelist"`` (the free-list ranking's gather).

``record_shapes()`` records, for every vertex-domain tensor the halo
layout and its session allocate, its op and the length of its vertex
axis (``n_owned`` or ``halo_cap``): the memory claim of the range
engine, read off the session itself.
"""
from __future__ import annotations

import dataclasses
from contextlib import contextmanager
from typing import Any, Iterator, List, Optional, Tuple

import torch
import torch.distributed as dist


@dataclasses.dataclass
class Traffic:
    """One collective issued by the sharded engine (call-time record)."""

    op: str          # "psum" | "psum_table" | "pmax_scalar" | ...
    recv_bytes: int  # payload each participating rank receives


_LOG: Optional[List[Traffic]] = None


@contextmanager
def record_traffic() -> Iterator[List[Traffic]]:
    """Capture the collectives issued inside the block. One session at a
    time: a nested entry raises ``RuntimeError`` and leaves the active
    session's log intact."""
    global _LOG
    if _LOG is not None:
        raise RuntimeError(
            "record_traffic() does not nest: the inner context would "
            "steal the active one's records"
        )
    _LOG = log = []
    try:
        yield log
    finally:
        _LOG = None


def _note(op: str, recv_bytes: int) -> None:
    if _LOG is not None:
        _LOG.append(Traffic(op, int(recv_bytes)))


_SHAPES: Optional[List[Tuple[str, int]]] = None


@contextmanager
def record_shapes() -> Iterator[List[Tuple[str, int]]]:
    """Capture ``(op, rows)`` for every vertex-domain tensor the halo
    layout and its sessions allocate inside the block: ``rows`` is the
    length of its vertex axis (``n_owned`` for owned slices,
    ``halo_cap`` for halo arrays; a ``[world, halo_cap]`` exchange buffer
    counts ``halo_cap``). One session at a time, as ``record_traffic``."""
    global _SHAPES
    if _SHAPES is not None:
        raise RuntimeError("record_shapes() does not nest")
    _SHAPES = log = []
    try:
        yield log
    finally:
        _SHAPES = None


def _rows(op: str, rows: int) -> None:
    if _SHAPES is not None:
        _SHAPES.append((op, int(rows)))


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


# -- the collectives (axis: a process group) ---------------------------------
def axis_index(axis) -> int:
    """This rank's coordinate on the mesh axis."""
    return dist.get_rank(axis)


def axis_size(axis) -> int:
    return dist.get_world_size(axis)


def psum(x: torch.Tensor, axis, op: str = "psum") -> torch.Tensor:
    """``all_reduce(SUM)`` of an integer tensor over ``axis``, IN PLACE
    (pass a tensor nothing else holds); identity when ``axis`` is None.
    A bool tensor is summed as int32 (a new tensor)."""
    if axis is None:
        return x
    if x.dtype == torch.bool:
        x = x.to(torch.int32)
    x = x.contiguous()
    _note(op, _nbytes(x))
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=axis)
    return x


def pmax(x: torch.Tensor, axis,
         op: Optional[str] = "pmax_scalar") -> torch.Tensor:
    """``all_reduce(MAX)`` over ``axis``, in place; identity off a mesh.
    ``op=None`` records nothing."""
    if axis is None:
        return x
    x = x.contiguous()
    if op is not None:
        _note(op, _nbytes(x))
    dist.all_reduce(x, op=dist.ReduceOp.MAX, group=axis)
    return x


def pmin(x: torch.Tensor, axis,
         op: Optional[str] = "pmin_scalar") -> torch.Tensor:
    """``all_reduce(MIN)`` over ``axis``, in place; identity off a mesh.
    ``op=None`` records nothing."""
    if axis is None:
        return x
    x = x.contiguous()
    if op is not None:
        _note(op, _nbytes(x))
    dist.all_reduce(x, op=dist.ReduceOp.MIN, group=axis)
    return x


def all_gather(x: torch.Tensor, axis, op: str) -> torch.Tensor:
    """``[world, *x.shape]``: every rank's ``x`` in rank order. A bool
    tensor travels as uint8 (the reference's bool bytes) and comes back
    bool."""
    is_bool = x.dtype == torch.bool
    y = (x.to(torch.uint8) if is_bool else x).contiguous()
    parts = [torch.empty_like(y) for _ in range(axis_size(axis))]
    _note(op, len(parts) * _nbytes(y))
    dist.all_gather(parts, y, group=axis)
    out = torch.stack(parts)
    return out.bool() if is_bool else out


def _gather_into(x: torch.Tensor, axis) -> torch.Tensor:
    """``[world, *x.shape]`` by one ``all_gather`` into one tensor
    (``all_gather_into_tensor``; ``all_gather_single`` where torch has
    renamed it). Integer tensors only; the caller records the traffic."""
    x = x.contiguous()
    world = axis_size(axis)
    out = torch.empty(world * x.numel(), dtype=x.dtype, device=x.device)
    fn = getattr(dist, "all_gather_single", None) or \
        dist.all_gather_into_tensor
    fn(out, x.reshape(-1), group=axis)
    return out.view((world,) + tuple(x.shape))


def _reduce_scatter(x: torch.Tensor, axis) -> torch.Tensor:
    """``psum_scatter(x, scatter_dimension=0, tiled=False)``: ``x`` is
    ``[world, *rest]``; rank ``r`` receives the SUM over ranks of row
    ``r`` (``reduce_scatter_tensor``; ``reduce_scatter_single`` where
    torch has renamed it). The caller records the traffic."""
    x = x.contiguous()
    rest = tuple(x.shape[1:])
    out = torch.empty(x[0].numel(), dtype=x.dtype, device=x.device)
    fn = getattr(dist, "reduce_scatter_single", None) or \
        dist.reduce_scatter_tensor
    fn(out, x.reshape(-1), op=dist.ReduceOp.SUM, group=axis)
    return out.view(rest)


@dataclasses.dataclass(frozen=True)
class ReplicatedVertices:
    """Full ``[n]`` vertex state on every rank; statistics complete by
    ``all_reduce(SUM)`` over ``axis`` (identity when ``axis`` is None)."""

    n: int
    axis: Any = None  # a torch.distributed process group, or None
    device: torch.device | str = "cpu"

    def complete(self, stats: torch.Tensor) -> torch.Tensor:
        """Partial per-vertex stats -> completed stats, full ``[n, ...]``
        (in place over a mesh axis)."""
        return psum(stats, self.axis, "psum")

    def own(self, full: torch.Tensor) -> torch.Tensor:
        return full

    def gather_mask(self, owned_mask: torch.Tensor) -> torch.Tensor:
        return owned_mask

    def any_owned(self, owned_mask: torch.Tensor) -> torch.Tensor:
        """Local: a mask computed from completed statistics and the
        replicated state is the same on every rank."""
        return torch.any(owned_mask)

    def frontier_peak(self, full_mask: torch.Tensor) -> torch.Tensor:
        """Frontier size of one exchanged mask: with replicated state,
        the popcount (int32 device scalar). Local, no collective."""
        return torch.sum(full_mask, dtype=torch.int32)

    def zeros(self, dtype=torch.int32) -> torch.Tensor:
        return torch.zeros(self.n, dtype=dtype, device=self.device)

    def add_at(self, owned: torch.Tensor, idx: torch.Tensor,
               vals: torch.Tensor) -> torch.Tensor:
        """``owned.at[idx].add(vals)``: a new tensor, duplicates summed."""
        return owned.index_add(0, idx.long(), vals.to(owned.dtype))


@dataclasses.dataclass(frozen=True)
class HaloShardedVertices:
    """Rank ``i`` of the owner group ``axis`` owns vertices
    ``[i * n_owned, (i+1) * n_owned)`` and keeps, beyond that owned
    slice, only a per-batch HALO of the ids its windowed slots and the
    batch lanes reference (``bind(halo_ids)`` opens a
    :class:`HaloSession`). ``n`` pads up to ``n_pad = n_owned *
    n_shards``; the phantom vertices past ``n`` hold zeros and no edge
    or lane references them. ``vertex_sharding="range"`` builds it on
    the one shared axis, with the dense halo regather (the reference's
    ``edge_axes`` and ``frontier_cap`` are ROADMAP Queue 1 B items 3 and
    4)."""

    n: int
    axis: Any  # the owner group (a torch.distributed process group)
    n_shards: int
    device: torch.device | str = "cpu"
    kind: str = dataclasses.field(default="halo", init=False)

    @property
    def n_owned(self) -> int:
        return -(-self.n // self.n_shards)

    @property
    def n_pad(self) -> int:
        return self.n_owned * self.n_shards

    def _offset(self) -> int:
        return axis_index(self.axis) * self.n_owned

    def zeros(self, dtype=torch.int32) -> torch.Tensor:
        _rows("zeros", self.n_owned)
        return torch.zeros(self.n_owned, dtype=dtype, device=self.device)

    def add_at(self, owned: torch.Tensor, idx: torch.Tensor,
               vals: torch.Tensor) -> torch.Tensor:
        """Scatter-add replicated batch contributions into the owned
        slice (a new tensor); rows owned by other ranks add nothing (the
        reference drops them past the end)."""
        loc = idx.long() - self._offset()
        mine = (loc >= 0) & (loc < self.n_owned)
        vals = vals.to(owned.dtype)
        _rows("add_at", owned.shape[0])
        return owned.index_add(0, torch.where(mine, loc, 0),
                               torch.where(mine, vals, 0))

    def bind(self, halo_ids: torch.Tensor) -> "HaloSession":
        """Open the per-batch session over ``halo_ids`` (sorted unique
        global int32 ids, ``n_pad``-sentinel padded to the halo cap): ONE
        all_gather publishes every rank's halo membership for the
        batch."""
        _note("gather_halo", self.n_shards * halo_ids.shape[0]
              * halo_ids.element_size())
        _rows("halo_ids", halo_ids.shape[0])
        ids_all = _gather_into(halo_ids, self.axis)  # [world, halo_cap]
        return HaloSession(self, halo_ids, ids_all)


class HaloSession:
    """One batch's halo working set: the companion of
    :class:`HaloShardedVertices`.

    ``halo_ids`` is this rank's sorted unique halo membership
    ``[halo_cap]`` (global ids, ``n_pad`` sentinels past the live prefix)
    and ``ids_all`` the ``[world, halo_cap]`` membership of the whole
    owner group, gathered once a batch. Every method speaks one of two
    domains: OWNED ``[n_owned]`` slices (where decisions run) and HALO
    ``[halo_cap]`` arrays (what the edge passes index). Nothing here is
    O(n). The owner rows of ``ids_all`` (which gathered halo slots fall
    in my owned range, and where) are computed once at ``bind``.
    """

    def __init__(self, layout: HaloShardedVertices, halo_ids: torch.Tensor,
                 ids_all: torch.Tensor) -> None:
        self.layout = layout
        self.halo_ids = halo_ids
        self.ids_all = ids_all
        self.halo_cap = int(halo_ids.shape[0])
        loc = ids_all.long() - layout._offset()
        self._mine = (loc >= 0) & (loc < layout.n_owned)
        # rows this rank does not own read and add a zero: each at its
        # column modulo n_owned (the reference drops them past the end),
        # so the owner scatter-add finds no one hot row to serialize on
        spread = torch.arange(self.halo_cap, device=loc.device) % \
            layout.n_owned
        self._safe = torch.where(self._mine, loc, spread)
        _rows("owner_rows", self.halo_cap)

    # -- delegated owned-range geometry --------------------------------
    @property
    def n_owned(self) -> int:
        return self.layout.n_owned

    @property
    def axis(self):
        return self.layout.axis

    def zeros(self, dtype=torch.int32) -> torch.Tensor:
        return self.layout.zeros(dtype)

    def add_at(self, owned, idx, vals) -> torch.Tensor:
        return self.layout.add_at(owned, idx, vals)

    # -- id <-> halo-position mapping ----------------------------------
    def locate(self, ids: torch.Tensor) -> torch.Tensor:
        """Halo position (int32) of each global id: exact for every id
        the batch can reference (window endpoints and batch lanes are in
        the halo by construction), a clamped position otherwise, which
        every statistic gates off by the edge ``valid`` mask. Monotone in
        the id, so equal ids keep equal positions (the kernels' src runs
        stay runs)."""
        pos = torch.searchsorted(self.halo_ids, ids.to(torch.int32),
                                 out_int32=True)
        return pos.clamp_(0, self.halo_cap - 1)

    # -- owner values -> halo (the dense regather) ----------------------
    def gather_values(self, owned: torch.Tensor) -> torch.Tensor:
        """Owned values -> this rank's halo values ``[halo_cap]`` by ONE
        reduce_scatter over the owner group: each rank contributes the
        rows of ``ids_all`` it owns (every id has exactly one owner) and
        receives its own halo row — O(halo_cap), independent of n. The
        halo's per-round refreshes of (core, label) and of owned masks
        (as int32, ``> 0`` after) are this dense regather (the sparse
        exchange is ROADMAP Queue 1 B item 4)."""
        contrib = torch.where(self._mine, owned[self._safe],
                              torch.zeros((), dtype=owned.dtype,
                                          device=owned.device))
        _rows("regather", self.halo_cap)
        _note("regather", self.halo_cap * owned.element_size())
        return _reduce_scatter(contrib, self.axis)

    # -- halo stat partials -> owned completed stats -------------------
    def complete(self, stats: torch.Tensor) -> torch.Tensor:
        """Halo-domain partial stats ``[halo_cap, ...]`` -> exact OWNED
        stats ``[n_owned, ...]``: one all_gather over the owner group
        (O(world * halo_cap)) and a local owner scatter-add; rows this
        rank does not own add zeros."""
        _note("gather_stats", self.layout.n_shards * _nbytes(stats))
        g = _gather_into(stats, self.axis)  # [world, halo_cap, ...]
        rest = tuple(stats.shape[1:])
        mine = self._mine.reshape(self._mine.shape + (1,) * len(rest))
        g = torch.where(mine, g, torch.zeros((), dtype=g.dtype,
                                             device=g.device))
        own = torch.zeros((self.n_owned,) + rest, dtype=stats.dtype,
                          device=stats.device)
        _rows("complete", self.n_owned)
        return own.index_add_(0, self._safe.reshape(-1),
                              g.reshape((-1,) + rest))

    # -- scalar completions --------------------------------------------
    def any_owned(self, owned_mask: torch.Tensor) -> torch.Tensor:
        """``any`` over the disjoint owned slices: one scalar
        all_reduce(SUM) over the owner group, the same verdict on every
        rank (a device bool)."""
        x = owned_mask.any().to(torch.int32).reshape(1)
        return psum(x, self.axis, "psum_scalar")[0] > 0

    def frontier_peak(self, owned_mask: torch.Tensor) -> torch.Tensor:
        """LOCAL owned popcount of one mask (no collective); the engine
        completes the running max with ONE ``pmax_scalar`` a batch."""
        return torch.sum(owned_mask, dtype=torch.int32)

    def pmax_scalar(self, x: torch.Tensor) -> torch.Tensor:
        return pmax(x.clone(), self.axis, "pmax_scalar")


VertexLayout = ReplicatedVertices | HaloShardedVertices


def make_layout(kind: str, n: int, axis, n_shards: int = 1,
                frontier_cap: Optional[int] = None,
                edge_axes: tuple = (),
                device: torch.device | str = "cpu") -> VertexLayout:
    """Factory keyed by the public ``vertex_sharding`` name, with the
    reference's signature and checks (``device`` added: where the
    layout's zeros live). ``"range"`` builds :class:`HaloShardedVertices`
    on the one shared axis. A misconfiguration raises ``ValueError``
    here, at construction; the 2-axis ``"halo"`` layout and a sparse
    ``frontier_cap`` raise ``NotImplementedError`` (ROADMAP Queue 1 B
    items 3 and 4)."""
    if kind == "replicated":
        if n_shards != 1:
            raise ValueError(
                f"n_shards={n_shards} is meaningless for the replicated "
                "vertex layout (every rank keeps the full state; only "
                "kind='range'/'halo' owns per-shard ranges) — pass "
                "n_shards=1 or use a range-sharded kind"
            )
        if frontier_cap is not None:
            raise ValueError(
                f"frontier_cap={frontier_cap} applies only to "
                "kind='range'/'halo' (the replicated layout exchanges "
                "no frontier masks)"
            )
        if edge_axes:
            raise ValueError(
                "edge_axes apply only to kind='halo' (the replicated "
                "layout completes over the one shared axis)"
            )
        return ReplicatedVertices(n, axis, device)
    if kind in ("range", "halo"):
        if axis is None:
            raise ValueError("range-sharded vertex state needs a mesh axis")
        if frontier_cap is not None and frontier_cap < 1:
            raise ValueError(
                f"frontier_cap must be >= 1 (or None for the dense halo "
                f"regather), got {frontier_cap}"
            )
        if kind == "range" and edge_axes:
            raise ValueError(
                "vertex_sharding='range' is the shared-axis layout; a "
                "2-axis mesh with pure-edge axes needs "
                "vertex_sharding='halo'"
            )
        if kind == "halo" and not edge_axes:
            raise ValueError(
                "vertex_sharding='halo' needs the 2-axis mesh's "
                "pure-edge axes (make_edge_vertex_mesh); for the "
                "shared-axis layout use vertex_sharding='range'"
            )
        if edge_axes:
            raise NotImplementedError(
                "the 2-axis 'halo' layout (edge_axes) is ROADMAP Queue 1 B "
                "item 3; the port has vertex_sharding='range'"
            )
        if frontier_cap is not None:
            raise NotImplementedError(
                "the sparse frontier exchange (frontier_cap) is ROADMAP "
                "Queue 1 B item 4; the port has the dense halo regather"
            )
        return HaloShardedVertices(n, axis, n_shards, device=device)
    raise ValueError(f"unknown vertex layout {kind!r}")
