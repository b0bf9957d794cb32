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

* ``HaloShardedVertices`` (``vertex_sharding="range"`` and ``"halo"``)
  — rank ``i`` of the owner group OWNS the contiguous vertex range
  ``[i * n_owned, (i+1) * n_owned)`` and keeps beyond it only a
  per-batch HALO working set: the vertices its windowed slots and the
  batch lanes reference, in a pow2-capped buffer (``HaloSession``). No
  rank holds an ``[n]`` vertex array: memory is O(n / d_v + halo_cap).
  A round's statistics complete with one ``all_gather`` of the
  halo-domain partials plus a local owner scatter-add and, on the
  2-axis ``(d_e, d_v)`` mesh (``edge_axes``), one all-reduce over the
  pure-edge group (``psum_edge``); the halo values are refreshed either
  by one ``reduce_scatter`` of the owners' contributions (the dense
  regather, O(halo_cap) received) or, with a ``frontier_cap``, by the
  sparse exchange: all_gathers of each owner's count-prefixed,
  compacted changed ids (and values), O(cap * d_v), falling back to the
  dense regather in a round where any owner's frontier overflows the
  cap. Labels place by the ring ``order.place_block_ring``. Integer
  arithmetic throughout, so the cores and labels are bit for bit those
  of the replicated layout (but for a renumber when phantom vertices
  pad ``n``: the ring ranks them too, which offsets the labels and
  keeps the k-order, as the reference's range engine does), whatever
  the cap.

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
runs the same rounds and issues the same collectives in the same order;
the reference's per-round ``lax.cond`` between the sparse exchange and
its dense fallback becomes a Python branch on the gathered (so
replicated) count column.

Traffic accounting
------------------
``record_traffic()`` records one ``Traffic(op, recv_bytes)`` per
collective issued inside it, with the payload each rank RECEIVES. The
reference records at trace time, once per traced loop body (so its log
of a fixpoint is the per-round budget); the port records at call time,
once per collective actually issued, so a round records only the arm
of the sparse exchange it took (the reference traces both and tags the
fallback's ``branch="overflow"``). The layout's records carry the
reference's op names and bytes (and its ``branch="overflow"`` tag on
the dense fallback of the sparse exchange: ``psum``; ``gather_halo``,
``regather``, ``gather_stats``, ``psum_edge``, ``gather_frontier``,
``psum_scalar``, ``pmax_scalar``, and the ring's ``ppermute`` and
``pmin_scalar``); the table collectives of
the batch program, which the reference does not record, are
``"psum_table"`` (found flags and counts), ``"psum_vertex"`` (the range
program's owned counts), ``"pmax_scalar"`` (the high-water mark) and
``"gather_freelist"`` (the free-list ranking's gather).

``record_shapes()`` records, for every vertex-domain tensor the halo
layout and its session allocate, its op and the length of its vertex
axis (``n_owned`` or ``halo_cap``): the memory claim of the halo
engines, read off the session itself.
"""
from __future__ import annotations

import dataclasses
from contextlib import contextmanager
from typing import Any, Iterator, List, Optional, Tuple

import torch
import torch.distributed as dist

from .. import trace


@dataclasses.dataclass
class Traffic:
    """One collective issued by the sharded engine (call-time record)."""

    op: str          # "psum" | "psum_table" | "pmax_scalar" | ...
    recv_bytes: int  # payload each participating rank receives
    branch: str = ""  # "overflow": the sparse exchange's dense fallback


_LOG: Optional[List[Traffic]] = None
# the arm being issued: "" or "overflow" (``_fallback``), as the
# reference tags the fallback cond arm it traces
_BRANCH = ""


@contextmanager
def _fallback() -> Iterator[None]:
    """Tag the collectives issued inside as the sparse exchange's dense
    fallback (``Traffic.branch == "overflow"``)."""
    global _BRANCH
    outer, _BRANCH = _BRANCH, "overflow"
    try:
        yield
    finally:
        _BRANCH = outer


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
        _LOG.append(Traffic(op, int(recv_bytes), _BRANCH))


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
    or lane references them.

    ``edge_axes`` holds the process groups of the PURE-edge axes of a
    2-axis mesh (``launch/mesh.py::make_edge_vertex_mesh``): statistics
    then gain one all-reduce over each after the owner scatter. With
    ``edge_axes=()`` the layout runs on the one shared axis, which is
    what ``vertex_sharding="range"`` builds. ``frontier_cap`` (``None``:
    dense) switches the per-round halo refreshes to the sparse
    compacted-index exchange, O(cap * d_v) received, with the dense
    regather as the fallback of a round whose frontier overflows the cap
    on any owner: bit for bit the same either way."""

    n: int
    axis: Any  # the owner group (a torch.distributed process group)
    n_shards: int
    frontier_cap: Optional[int] = None
    edge_axes: tuple = ()  # the pure-edge process groups
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
    @trace.spanned("HaloSession.gather_values")
    def gather_values(self, owned: torch.Tensor) -> torch.Tensor:
        """Owned values -> this rank's halo values ``[halo_cap]`` by ONE
        reduce_scatter over the owner group: each rank contributes the
        rows of ``ids_all`` it owns (every id has exactly one owner) and
        receives its own halo row — O(halo_cap), independent of n: the
        batch's entry regather, the dense refreshes, and the sparse
        exchange's fallback."""
        contrib = torch.where(self._mine, owned[self._safe],
                              torch.zeros((), dtype=owned.dtype,
                                          device=owned.device))
        _rows("regather", self.halo_cap)
        _note("regather", self.halo_cap * owned.element_size())
        return _reduce_scatter(contrib, self.axis)

    # -- halo stat partials -> owned completed stats -------------------
    @trace.spanned("HaloSession.complete")
    def complete(self, stats: torch.Tensor) -> torch.Tensor:
        """Halo-domain partial stats ``[halo_cap, ...]`` -> exact OWNED
        stats ``[n_owned, ...]``: one all_gather over the owner group
        (O(d_v * halo_cap)) and a local owner scatter-add (rows this
        rank does not own add zeros), then, on a 2-axis mesh, one
        all-reduce over each pure-edge group (``psum_edge``)."""
        _note("gather_stats", self.layout.n_shards * _nbytes(stats))
        g = _gather_into(stats, self.axis)  # [world, halo_cap, ...]
        rest = tuple(stats.shape[1:])
        mine = self._mine.reshape(self._mine.shape + (1,) * len(rest))
        g = torch.where(mine, g, torch.zeros((), dtype=g.dtype,
                                             device=g.device))
        own = torch.zeros((self.n_owned,) + rest, dtype=stats.dtype,
                          device=stats.device)
        _rows("complete", self.n_owned)
        own.index_add_(0, self._safe.reshape(-1), g.reshape((-1,) + rest))
        for group in self.layout.edge_axes:
            own = psum(own, group, "psum_edge")  # in place: own is fresh
        return own

    # -- per-round halo refreshes --------------------------------------
    def _sparse_payload(self, owned_mask: torch.Tensor):
        """The wire format of the sparse exchange: ``[1 + cap]`` int32,
        the owned changed count, then the global ids of the first
        ``cap`` changed owned rows in order (``n_pad`` sentinels past
        them); and each owned row's compaction position (``cap``, the
        spare row, for a row not sent)."""
        cap = self.layout.frontier_cap
        count = owned_mask.sum(dtype=torch.int32).reshape(1)
        pos = torch.cumsum(owned_mask, 0, dtype=torch.int32) - 1
        gidx = torch.arange(self.n_owned, dtype=torch.int32,
                            device=owned_mask.device) + self.layout._offset()
        safe = torch.where(owned_mask & (pos < cap), pos, cap).long()
        # the reference drops the unsent rows' writes past the end; here
        # they land on one spare row, cut off after
        buf = torch.full((cap + 1,), self.layout.n_pad, dtype=torch.int32,
                         device=owned_mask.device)
        buf[safe] = gidx
        return torch.cat([count, buf[:cap]]), safe

    def _halo_targets(self, flat_gidx: torch.Tensor) -> torch.Tensor:
        """Halo positions (int64) of gathered global ids; sentinels and
        ids outside my halo park on ``halo_cap``, one past the end."""
        pos = self.locate(flat_gidx)
        hit = (self.halo_ids[pos.long()] == flat_gidx) & (
            flat_gidx < self.layout.n_pad)
        return torch.where(hit, pos, self.halo_cap).long()

    def _gather_frontier(self, x: torch.Tensor) -> torch.Tensor:
        _note("gather_frontier", self.layout.n_shards * _nbytes(x))
        return _gather_into(x, self.axis)

    def _overflowed(self, g_idx: torch.Tensor) -> bool:
        """Did any owner's frontier overflow the cap? Read off the
        gathered count column, so every rank of the owner group decides
        the same (one host read a refresh; owned values are replicated
        across the pure-edge groups, so the whole mesh decides alike)."""
        return bool(g_idx[:, 0].max() > self.layout.frontier_cap)

    def _set_halo(self, halo: torch.Tensor, tgt: torch.Tensor,
                  vals: torch.Tensor) -> torch.Tensor:
        """``halo`` with the rows ``tgt`` set to ``vals`` (a new tensor);
        parked targets land on a spare row, cut off. Owners are
        disjoint, so no real target repeats."""
        out = torch.cat([halo, halo.new_zeros(1)])
        out[tgt] = vals.to(halo.dtype)
        _rows("refresh", self.halo_cap)
        return out[:self.halo_cap]

    def refresh_mask(self, owned_mask: torch.Tensor):
        """Owned bool mask -> ``(halo mask [halo_cap], overflowed)``.
        Dense (no ``frontier_cap``): one reduce_scatter of the mask as
        int32. Sparse: one all_gather of the count-prefixed compacted
        ids, O(cap * d_v), then a local scatter into the halo; where any
        owner's count exceeds the cap, the dense regather instead
        (``overflowed`` True). The same mask either way."""
        if self.layout.frontier_cap is None:
            return self._mask_dense(owned_mask), False
        payload, _ = self._sparse_payload(owned_mask)
        g = self._gather_frontier(payload)  # [d_v, cap + 1]
        if self._overflowed(g):
            with _fallback():
                return self._mask_dense(owned_mask), True
        tgt = self._halo_targets(g[:, 1:].reshape(-1))
        mask = torch.zeros(self.halo_cap, dtype=torch.bool,
                           device=owned_mask.device)
        ones = torch.ones(tgt.shape[0], dtype=torch.bool, device=tgt.device)
        return self._set_halo(mask, tgt, ones), False

    def _mask_dense(self, owned_mask: torch.Tensor) -> torch.Tensor:
        return self.gather_values(owned_mask.to(torch.int32)) > 0

    def refresh_values(self, core_own: torch.Tensor, label_own: torch.Tensor,
                       changed_own: torch.Tensor, core_h: torch.Tensor,
                       label_h: torch.Tensor):
        """Post-commit halo refresh of (core, label), restricted to the
        round's changed owners. Dense: two regathers of the full halo
        values. Sparse: three all_gathers of the compacted (id, core,
        label) columns (int32, int32, int64), written over the stale
        halo; the dense regathers where any owner overflowed. Returns
        ``(core_h, label_h, overflowed)``."""
        if self.layout.frontier_cap is None:
            return (self.gather_values(core_own),
                    self.gather_values(label_own), False)
        payload, safe = self._sparse_payload(changed_own)
        cap = self.layout.frontier_cap
        cbuf = core_own.new_zeros(cap + 1)
        cbuf[safe] = core_own
        lbuf = label_own.new_zeros(cap + 1)
        lbuf[safe] = label_own
        g_i = self._gather_frontier(payload)      # [d_v, cap + 1]
        g_c = self._gather_frontier(cbuf[:cap])   # [d_v, cap]
        g_l = self._gather_frontier(lbuf[:cap])   # [d_v, cap]
        if self._overflowed(g_i):
            with _fallback():
                return (self.gather_values(core_own),
                        self.gather_values(label_own), True)
        tgt = self._halo_targets(g_i[:, 1:].reshape(-1))
        return (self._set_halo(core_h, tgt, g_c.reshape(-1)),
                self._set_halo(label_h, tgt, g_l.reshape(-1)), False)

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
    layout's zeros live; ``axis`` and ``edge_axes`` are process groups).
    ``"range"`` and ``"halo"`` both build :class:`HaloShardedVertices`:
    ``"range"`` on the one shared axis, ``"halo"`` with the pure-edge
    groups of a 2-axis mesh. A misconfiguration raises ``ValueError``
    here, at construction."""
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
        return HaloShardedVertices(n, axis, n_shards, frontier_cap,
                                   tuple(edge_axes), device=device)
    raise ValueError(f"unknown vertex layout {kind!r}")
