"""CoreMaintainer — the public interface to parallel order-based core
maintenance, on PyTorch.

The port of the reference's ``core/api.py``, with its three engines:

* ``engine="unified"`` (the default): every batch (mixed insertions +
  removals) runs as one call of ``engine.apply_batch`` on the
  maintainer's device, with the slot table updated in place;
* ``engine="host"``: the reference's seed two-call path. The host
  dedups each edit list against the ``edge_slot`` dict, then
  ``remove.remove_batch`` and ``insert.insert_batch`` run on the device
  in plain PyTorch (the reference runs this path in lax only, so
  ``kernel_backend="cuda"`` and ``weighted=True`` raise with it).
  ``n_edges`` is the bump pointer, tombstones are reclaimed by
  ``_compact`` and the table grows by ``_grow``;
* ``engine="sharded"``: the unified engine's program with the slot
  table sharded over a mesh's ``"data"`` axis (core/sharded.py). The
  port is SPMD over ``torch.distributed``: every rank constructs the
  same maintainer (``mesh=`` a ``DeviceMesh``, by default
  ``launch.mesh.make_edge_mesh()`` over the initialized world) and
  calls ``apply_batch`` with the same edits. Each rank keeps its
  ``capacity / world`` slots of the table. ``vertex_sharding`` picks
  where ``core`` and ``label`` live: ``"replicated"`` (every rank holds
  all ``n``), ``"range"`` (rank ``r`` holds its owned slice
  ``[r * n_owned, (r + 1) * n_owned)`` of the state padded with zero
  phantom vertices to ``n_owned * world``; a batch adds only a bounded
  halo working set) or ``"halo"`` (the same on a 2-axis ``(d_e, d_v)``
  edge x vertex mesh, ``mesh_shape``: rank ``e * d_v + v`` holds slot
  block ``e * d_v + v`` and owns vertex range ``v``).
  ``frontier_exchange="sparse"`` (range / halo) refreshes the halo with
  compacted ids in a ``frontier_cap`` bucket (0: planned a batch) in
  place of the dense regather. ``freelist`` picks the slot ranking
  (``"interleaved"`` | ``"hierarchical"``). The queries that read the
  table or, under ``"range"`` / ``"halo"``, the vertex state
  (``edge_slot``, ``live_edges``, ``cores``, ``labels``, ``order_lt``,
  ``state``, ``save``) are collectives: every rank calls them.

Under the device engines the host keeps

  * a lazily-built ``edge -> slot`` mirror for queries (``edge_slot``;
    dropped after each batch, built on first access), and
  * two monotone bounds for capacity planning: ``hwm_ub`` (upper bound
    on the per-shard slot high-water mark, reported exactly by
    ``stats.high_water``) and ``live_ub`` (upper bound on the live edge
    count). The free-list recycles tombstoned slots in the batch
    program, so the bounds are re-read from the device only when they
    cross the capacity threshold. Under the sharded engine both are
    read from replicated values, so every rank plans — and defrags —
    at the same batch.

Entry points run on the card: ``device=None`` means ``"cuda"`` and
raises when no CUDA device is present; tests pass ``device="cpu"``.
``kernel_backend`` is ``"torch"`` or ``"cuda"`` (the counterparts of the
reference's ``"lax"`` and ``"pallas"``) and defaults to ``"cuda"`` on a
CUDA device, ``"torch"`` on the CPU and under ``engine="host"``;
``"cuda"`` on a CPU device raises.

``weighted=True`` (weighted coreness, Zhou et al.) adds a per-slot int32
weight column ``w``: ``from_graph(weights=)`` takes the initial
weights, ``apply_batch(insert_weights=)`` the weights of each batch's
inserts, and both maintenance phases run the weighted h-index fixpoint
(``engine.apply_batch_weighted``).

Checkpoints use the reference's ``np.savez_compressed`` payload (n,
capacity, src, dst, valid, n_edges, core, label, and ``w`` when
weighted), so they load in both directions, across the engines and
across shard counts (the saved table is the global one).

Edge endpoints are validated on every edit path: out-of-range vertices
raise ``ValueError`` by default, or are dropped under ``validate=False``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_backend, resolve_device
from ..graph.csr import CSRGraph, build_csr
from ..launch.mesh import make_edge_mesh, make_edge_vertex_mesh, table_group
from .decomposition import peel_decomposition, rank_to_labels
from .engine import BatchStats, apply_batch, apply_batch_weighted
from .insert import InsertStats, insert_batch
from .oracle import bz_core_decomposition
from .order import needs_renumber, renumber
from .remove import (RemoveStats, remove_batch,
                     weighted_core_fixpoint_pass)
from .sharded import axis_group, make_sharded_apply
from .vertex_layout import all_gather, axis_index, psum

EDGE_AXIS = "data"  # mesh axis the sharded engine shards edge slots over

_ENGINES = ("unified", "host", "sharded")

_STATE_KEYS = ("n", "capacity", "src", "dst", "valid", "n_edges", "core",
               "label")


def _pow2_roundup(need: int) -> int:
    """Smallest power of two >= need — the bucketing idiom behind batch
    padding and the active window."""
    p = 1
    while p < need:
        p *= 2
    return p


def plan_window(hwm_ub: int, b_ins: int, local_cap: int) -> int:
    """Pow2 bucket of the active window covering the high-water bound
    plus a ``b_ins``-insert batch, clamped to the table size."""
    return min(_pow2_roundup(max(16, hwm_ub + b_ins + 1)), local_cap)


def plan_frontier_cap(frontier_exchange: str, pinned_cap: int,
                      b_pad: int, n_owned: int, observed: int = 0) -> int:
    """Pow2 capacity of the sparse frontier buffer for a batch padded to
    ``b_pad`` lanes: 0 when the exchange is off, ``pinned_cap`` as given
    when the caller pinned one, else a few cascade multiples of the
    batch grown to twice ``observed`` (a running quantile of the
    stream's per-batch ``stats.max_frontier``) and clamped to the pow2
    roof of the owned range, past which the sparse buffer cannot beat
    the dense exchange. A cap too small costs only the dense fallback
    of the rounds that overflow it, never correctness."""
    if frontier_exchange != "sparse":
        return 0
    if pinned_cap > 0:
        return pinned_cap
    cap = _pow2_roundup(max(32, 4 * b_pad, 2 * observed))
    while cap // 2 >= n_owned:
        cap //= 2
    return cap


def bucket_lattice(local_cap: int, max_batch_lanes: int,
                   frontier_exchange: str = "bitmask",
                   pinned_cap: int = 0, n_owned: int = 1) -> list:
    """Every ``(window, frontier_cap)`` bucket pair the planners above
    can reach for batches up to ``max_batch_lanes`` padded lanes: each
    pair keys one sharded program (``CoreMaintainer._sharded_fn``), so
    the lattice bounds how many a stream builds. The windows are the
    pow2 ladder from 16 clamped to ``local_cap``; the sparse caps are
    the planned caps of every pow2 batch bucket and, unpinned, the pow2
    ladder from the smallest up to the owned-range roof (the observed
    quantile can push a cap up any rung of it)."""
    windows = set()
    p = 16
    while p < local_cap:
        windows.add(p)
        p *= 2
    windows.add(min(p, local_cap))
    caps = set()
    if frontier_exchange != "sparse":
        caps.add(0)
    else:
        b = 1
        while b <= max(1, max_batch_lanes):
            caps.add(plan_frontier_cap(frontier_exchange, pinned_cap,
                                       b, n_owned))
            b *= 2
        if pinned_cap <= 0:
            c = min(caps)
            roof = plan_frontier_cap(frontier_exchange, pinned_cap, 1,
                                     n_owned, observed=max(1, n_owned))
            while c < roof:
                caps.add(c)
                c *= 2
            caps.add(roof)
    return sorted((w, c) for w in windows for c in caps)


def _pad_pow2(x: np.ndarray, fill: int) -> np.ndarray:
    p = _pow2_roundup(max(1, len(x)))
    out = np.full(p, fill, dtype=np.int32)
    out[: len(x)] = x
    return out


def _as_edge_array(edges) -> np.ndarray:
    if edges is None:
        return np.zeros((0, 2), dtype=np.int64)
    return np.asarray(edges, dtype=np.int64).reshape(-1, 2)


def _check_config(engine: str, kernel_backend: Optional[str],
                  weighted: bool, mesh=None,
                  vertex_sharding: str = "replicated",
                  freelist: str = "interleaved",
                  mesh_shape: Optional[Tuple[int, int]] = None,
                  frontier_exchange: str = "bitmask",
                  frontier_cap: int = 0) -> None:
    """The engine configuration, checked as the reference's
    ``__post_init__`` checks it, before any device check (so the message
    is the same on every device)."""
    if engine not in _ENGINES:
        raise ValueError(f"unknown engine {engine!r}")
    if vertex_sharding not in ("replicated", "range", "halo"):
        raise ValueError(f"unknown vertex_sharding {vertex_sharding!r}")
    if freelist not in ("interleaved", "hierarchical"):
        raise ValueError(f"unknown freelist {freelist!r}")
    if frontier_exchange not in ("bitmask", "sparse"):
        raise ValueError(
            f"unknown frontier_exchange {frontier_exchange!r}"
        )
    if mesh is not None and engine != "sharded":
        raise ValueError(
            f"mesh= is only consumed by engine='sharded' (got "
            f"engine={engine!r}) — a silently ignored mesh would hide a "
            "misconfigured deployment"
        )
    if vertex_sharding in ("range", "halo") and engine != "sharded":
        raise ValueError(
            f"vertex_sharding={vertex_sharding!r} needs "
            "engine='sharded' (the other engines keep full vertex "
            "state on one device)"
        )
    if mesh_shape is not None:
        if vertex_sharding != "halo":
            raise ValueError(
                f"mesh_shape={mesh_shape} is only consumed by "
                "vertex_sharding='halo' (the single-axis layouts would "
                "silently ignore the factorization)"
            )
        if mesh is not None:
            raise ValueError(
                "pass mesh= OR mesh_shape=, not both — mesh_shape builds "
                "the default 2-axis mesh; a user mesh carries its own "
                "factorization"
            )
        de, dv = mesh_shape
        if de < 1 or dv < 1:
            raise ValueError(f"mesh_shape must be positive, got {mesh_shape}")
    if freelist == "hierarchical" and engine != "sharded":
        raise ValueError(
            "freelist='hierarchical' needs engine='sharded' — the "
            "ranking only differs across shards, so accepting it "
            "elsewhere would silently do nothing"
        )
    if frontier_exchange == "sparse" and vertex_sharding not in (
            "range", "halo"):
        raise ValueError(
            "frontier_exchange='sparse' needs vertex_sharding='range' or "
            "'halo' (only the halo layouts exchange frontier refreshes; "
            "the replicated layout would silently ignore it)"
        )
    if frontier_cap < 0:
        raise ValueError(
            f"frontier_cap must be >= 0 (0 = plan automatically), got "
            f"{frontier_cap}"
        )
    if frontier_cap > 0 and frontier_exchange != "sparse":
        raise ValueError(
            f"frontier_cap={frontier_cap} is only consumed by "
            "frontier_exchange='sparse' — the bitmask exchange would "
            "silently ignore it"
        )
    if engine == "host" and kernel_backend == "cuda":
        raise ValueError(
            "kernel_backend='cuda' needs a device engine ('unified' | "
            "'sharded') — "
            "the host path runs the seed two-call path in plain PyTorch "
            "and would silently ignore it"
        )
    if engine == "host" and weighted:
        raise ValueError(
            "weighted=True needs a device engine ('unified' | 'sharded') "
            "— the seed "
            "host path runs the unit-count order-maintenance fixpoints "
            "and has no weight column"
        )


def _default_edge_mesh(vertex_sharding: str = "replicated",
                       mesh_shape: Optional[Tuple[int, int]] = None):
    """The mesh a sharded maintainer builds when given none, over the
    initialized world: under ``"halo"`` the 2-axis ``mesh_shape`` (by
    default ``(1, world)``, the pure owner-axis column), else the 1-D
    edge mesh (under ``"range"`` its one axis carries the edge shards
    AND the vertex ranges)."""
    if vertex_sharding == "halo":
        return make_edge_vertex_mesh(
            mesh_shape=mesh_shape or (1, dist.get_world_size()))
    return make_edge_mesh(axis=EDGE_AXIS)


@dataclasses.dataclass
class CoreMaintainer:
    """Dynamic-graph core maintenance with k-order labels (PyTorch)."""

    n: int
    capacity: int
    # the slot table: int32 / int32 / bool [capacity], this rank's
    # [capacity / world] shard under engine="sharded"
    src: torch.Tensor
    dst: torch.Tensor
    valid: torch.Tensor
    # int32 scalar: the live edge count (unified), the bump pointer =
    # slot high-water mark (host)
    n_edges: torch.Tensor
    core: torch.Tensor     # int32 [n]; the owned [n_owned] under "range"
    #                        and "halo"
    label: torch.Tensor    # int64 [n]; likewise
    n_levels: int
    engine: str = "unified"     # "unified" | "host" | "sharded"
    mesh: Optional[Any] = None  # sharded engine only: a DeviceMesh with
    #                             a "data" dimension
    vertex_sharding: str = "replicated"  # | "range" | "halo"
    mesh_shape: Optional[Tuple[int, int]] = None  # (d_e, d_v): builds the
    #                             default mesh of vertex_sharding="halo"
    freelist: str = "interleaved"        # "interleaved" | "hierarchical"
    frontier_exchange: str = "bitmask"   # "bitmask" (the dense halo
    #                                      regather) | "sparse" (range/halo)
    frontier_cap: int = 0  # the sparse buffer's capacity; 0: planned a
    #                        batch as a pow2 bucket
    kernel_backend: Optional[str] = None  # None: "cuda" on a card
    validate: bool = True  # raise on out-of-range endpoints (else mask)
    weighted: bool = False
    w: Optional[torch.Tensor] = None  # int32 slot column when weighted
    last_insert_stats: Optional[InsertStats] = None
    last_remove_stats: Optional[RemoveStats] = None
    last_batch_stats: Optional[BatchStats] = None
    slot_cache: Optional[Dict[Tuple[int, int], int]] = None
    live_ub: int = -1  # upper bound on live edges (-1: from valid)
    hwm_ub: int = -1   # upper bound on the slot high-water mark
    host_renumbered: bool = False  # the last host-path call renumbered
    _last_window: int = dataclasses.field(default=0, repr=False)
    # the table tensors hold this rank's shard (set by _place_sharded)
    _sharded_table: bool = dataclasses.field(default=False, repr=False)
    # core/label hold this rank's owned slice (set by _place_vertices)
    _owned_vertices: bool = dataclasses.field(default=False, repr=False)
    # sharded engine: the mesh's "data" (owner) process group, the group
    # of every rank the table is sharded over (the same group on one
    # axis), and this rank's apply function for each (window, cap) bucket
    _group: Any = dataclasses.field(default=None, repr=False)
    _table_group: Any = dataclasses.field(default=None, repr=False)
    _sharded_fns: Dict[Tuple[int, int], Callable] = dataclasses.field(
        default_factory=dict, repr=False)
    # the planned sparse cap's feedback: this stream's per-batch
    # max_frontier (device scalars not read yet, and the host ints)
    _frontier_obs: list = dataclasses.field(default_factory=list,
                                            repr=False)
    _frontier_hist: list = dataclasses.field(default_factory=list,
                                             repr=False)

    def __post_init__(self) -> None:
        _check_config(self.engine, self.kernel_backend, self.weighted,
                      self.mesh, self.vertex_sharding, self.freelist,
                      self.mesh_shape, self.frontier_exchange,
                      self.frontier_cap)
        dev = self.src.device
        self.kernel_backend = resolve_backend(self.kernel_backend, dev,
                                              self.engine != "host")
        if self.weighted:
            if self.w is None:
                # unit weights: the weighted engine then computes exactly
                # the classic coreness
                self.w = torch.ones(self.capacity, dtype=torch.int32,
                                    device=dev)
            elif tuple(self.w.shape) != (self.capacity,):
                raise ValueError(
                    f"w has shape {tuple(self.w.shape)}, expected the "
                    f"slot table shape ({self.capacity},)"
                )
            else:
                self.w = self.w.to(device=dev, dtype=torch.int32)
        elif self.w is not None:
            raise ValueError(
                "w= (per-slot edge weights) needs weighted=True; the "
                "unweighted engine would silently ignore the column"
            )
        if self.live_ub < 0 or self.hwm_ub < 0:
            live = torch.nonzero(self.valid).flatten()
            self.live_ub = int(live.shape[0])
            self.hwm_ub = int(live[-1]) + 1 if live.numel() else 0
        if self.engine == "host" and int(self.n_edges) < self.hwm_ub:
            # the host path bump-allocates from n_edges: it must cover
            # the high-water mark (unified saves store the live count)
            self.n_edges = torch.tensor(self.hwm_ub, dtype=torch.int32,
                                        device=dev)
        if self.engine == "sharded":
            if self.mesh is None:
                self.mesh = _default_edge_mesh(self.vertex_sharding,
                                               self.mesh_shape)
            if self.mesh.device_type != dev.type:
                raise ValueError(
                    f"the mesh is on {self.mesh.device_type!r} but the "
                    f"maintainer's device is {dev}: NCCL meshes hold CUDA "
                    "tensors, gloo meshes CPU tensors"
                )
            self._group = axis_group(self.mesh, EDGE_AXIS,
                                     self.vertex_sharding)
            self._table_group = table_group(self.mesh)
            # one small collective a group: NCCL builds a communicator at
            # its first one, and that belongs to set-up, not the first
            # batch
            for name in self.mesh.mesh_dim_names:
                dist.all_reduce(torch.zeros(1, dtype=torch.int32,
                                            device=dev),
                                group=self.mesh.get_group(name))
            if self._table_group is not self._group:
                dist.all_reduce(torch.zeros(1, dtype=torch.int32,
                                            device=dev),
                                group=self._table_group)
            self._place_vertices()
            if self._n_shards > 1:
                # one re-layout: pad capacity to an even shard split AND
                # stride the live slots across the shards, so the
                # densest shard's high-water mark starts near
                # live / n_shards
                self._defrag_to(self.capacity)
            else:
                self._place_sharded()

    @property
    def device(self) -> torch.device:
        return self.src.device

    # -- sharded placement ---------------------------------------------------
    @property
    def _n_shards(self) -> int:
        """Edge-slot shard count: the whole mesh size, ``d_e * d_v`` on
        the 2-axis mesh (1 off the sharded engine)."""
        if self.engine != "sharded":
            return 1
        return self.mesh.size()

    @property
    def _local_cap(self) -> int:
        """Slots per shard (== capacity off the sharded engine)."""
        return self.capacity // self._n_shards

    @property
    def _halo_layout(self) -> bool:
        """Does each rank own a slice of the vertex state (``"range"``,
        ``"halo"``)?"""
        return (self.engine == "sharded"
                and self.vertex_sharding in ("range", "halo"))

    @property
    def _d_v(self) -> int:
        """Vertex owner-shard count: the size of the owner (``"data"``)
        axis under ``"range"`` / ``"halo"``, else 1."""
        if not self._halo_layout:
            return 1
        return self.mesh.mesh.shape[
            tuple(self.mesh.mesh_dim_names).index(EDGE_AXIS)]

    @property
    def _n_vertex_pad(self) -> int:
        """Vertex-state length under ``"range"`` / ``"halo"``: ``n``
        rounded up to an owner-shard multiple (the phantom tail holds
        zeros, is never referenced by an edge and is never
        returned)."""
        return -(-self.n // self._d_v) * self._d_v

    def _pad_vertex_state(self) -> None:
        pad = self._n_vertex_pad - self.core.shape[0]
        if pad > 0:
            self.core = torch.cat([self.core, self.core.new_zeros(pad)])
            self.label = torch.cat([self.label, self.label.new_zeros(pad)])

    def _place_vertices(self) -> None:
        """Under ``"range"`` / ``"halo"``: pad the vertex state to
        ``n_owned * d_v`` and keep the owned slice of this rank's owner
        coordinate (once, at construction: set-up may hold ``[n]`` for a
        moment, the batch path never does)."""
        if not self._halo_layout or self._owned_vertices:
            return
        self._pad_vertex_state()
        no = self._n_vertex_pad // self._d_v
        r = axis_index(self._group)
        self.core = self.core[r * no:(r + 1) * no].clone()
        self.label = self.label[r * no:(r + 1) * no].clone()
        self._owned_vertices = True

    def _full(self, x: torch.Tensor) -> torch.Tensor:
        """A vertex-state tensor (``core`` or ``label``) as the GLOBAL
        ``[n]`` on the maintainer's device: itself, or under ``"range"`` /
        ``"halo"`` one all_gather of the owned slices over the owner
        group with the phantom tail stripped (a collective: every rank
        calls it)."""
        if not self._owned_vertices:
            return x
        return all_gather(x, self._group, "gather_vertex").reshape(-1)[
            : self.n]

    def _place_sharded(self) -> None:
        """Keep this rank's block of the global slot table (rank r of the
        table group, ``e * d_v + v`` on the 2-axis mesh, holds slots
        ``[r * local_cap, (r + 1) * local_cap)``, at offset 0 of its own
        tensors); the vertex state stays where ``_place_vertices`` put
        it."""
        lc = self._local_cap
        r = axis_index(self._table_group)

        def mine(x):
            part = x[r * lc:(r + 1) * lc]
            return part if lc == x.shape[0] else part.clone()

        self.src, self.dst, self.valid = (mine(self.src), mine(self.dst),
                                          mine(self.valid))
        if self.weighted:
            self.w = mine(self.w)
        self._sharded_table = True

    def _table(self):
        """The GLOBAL slot table ``(src, dst, valid, w)`` (``w`` None when
        unweighted): the tensors themselves off the sharded engine, one
        ``all_gather`` a column of every rank's shard on it (a
        collective: every rank calls it)."""
        cols = (self.src, self.dst, self.valid,
                self.w if self.weighted else None)
        if not self._sharded_table:
            return cols
        return tuple(
            None if x is None
            else all_gather(x, self._table_group, "gather_table").reshape(-1)
            for x in cols)

    # -- construction -------------------------------------------------------
    @classmethod
    def from_graph(
        cls,
        g: CSRGraph,
        capacity: Optional[int] = None,
        init: str = "host-bz",
        engine: str = "unified",
        kernel_backend: Optional[str] = None,
        weighted: bool = False,
        validate: bool = True,
        device=None,
        weights=None,
        mesh: Optional[Any] = None,
        vertex_sharding: str = "replicated",
        freelist: str = "interleaved",
        mesh_shape: Optional[Tuple[int, int]] = None,
        frontier_exchange: str = "bitmask",
        frontier_cap: int = 0,
    ) -> "CoreMaintainer":
        """Build a maintainer from a static graph. ``init="host-bz"``
        runs the sequential BZ oracle on the host; ``init="jax-peel"``
        (the reference's name, kept so callers port unchanged) runs the
        level-synchronous peel on the device. The ``edge_slot`` mirror
        is left to be built on first access.

        ``weighted=True`` takes ``weights`` aligned with
        ``g.edge_array()`` (positive integers; None means all ones) and
        bypasses ``init``: the initial cores come from the engine's own
        weighted h-index fixpoint, from the weighted-degree bound, on
        the maintainer's device and kernel backend (the integer result
        cannot depend on the backend), and the initial labels are the
        ``(core, vertex id)`` lexicographic ranks.

        ``engine="sharded"``: every rank calls this with the same graph
        (``mesh``, ``vertex_sharding``, ``mesh_shape``, ``freelist``,
        ``frontier_exchange`` and ``frontier_cap`` as the fields); each
        computes the same initial state and keeps its shard."""
        _check_config(engine, kernel_backend, weighted, mesh,
                      vertex_sharding, freelist, mesh_shape,
                      frontier_exchange, frontier_cap)
        dev = resolve_device(device)
        edges = g.edge_array()
        m = edges.shape[0]
        capacity = capacity or max(16, 2 * m)
        if capacity <= m:
            raise ValueError("capacity must exceed edge count")
        if weights is not None and not weighted:
            raise ValueError("weights= needs weighted=True")
        src = torch.zeros(capacity, dtype=torch.int32, device=dev)
        dst = torch.zeros(capacity, dtype=torch.int32, device=dev)
        val = torch.zeros(capacity, dtype=torch.bool, device=dev)
        src[:m] = torch.from_numpy(edges[:, 0].astype(np.int32)).to(dev)
        dst[:m] = torch.from_numpy(edges[:, 1].astype(np.int32)).to(dev)
        val[:m] = True
        common = dict(n=g.n, capacity=capacity, src=src, dst=dst, valid=val,
                      n_edges=torch.tensor(m, dtype=torch.int32, device=dev),
                      n_levels=g.n + 2, engine=engine, validate=validate,
                      live_ub=m, hwm_ub=m, mesh=mesh,
                      vertex_sharding=vertex_sharding, freelist=freelist,
                      mesh_shape=mesh_shape,
                      frontier_exchange=frontier_exchange,
                      frontier_cap=frontier_cap)
        if weighted:
            wv = (np.ones(m, dtype=np.int64) if weights is None
                  else np.asarray(weights, dtype=np.int64).reshape(-1))
            if wv.shape[0] != m:
                raise ValueError(
                    f"weights have length {wv.shape[0]} but the graph "
                    f"has {m} edges"
                )
            if wv.size and (wv < 1).any():
                raise ValueError("edge weights must be positive integers")
            backend = resolve_backend(kernel_backend, dev)
            wcol = torch.zeros(capacity, dtype=torch.int32, device=dev)
            wcol[:m] = torch.from_numpy(wv.astype(np.int32)).to(dev)
            deg_w = np.zeros(g.n, dtype=np.int64)
            np.add.at(deg_w, edges[:, 0], wv)
            np.add.at(deg_w, edges[:, 1], wv)
            core, _, _ = weighted_core_fixpoint_pass(
                src, dst, val, wcol,
                torch.from_numpy(deg_w.astype(np.int32)).to(dev), g.n,
                kernel_backend=backend,
            )
            core_np = core.cpu().numpy()
            order = np.lexsort((np.arange(g.n), core_np))
            rank = np.zeros(g.n, dtype=np.int32)
            rank[order] = np.arange(g.n, dtype=np.int32)
            label = rank_to_labels(torch.from_numpy(rank).to(dev))
            return cls(core=core, label=label, kernel_backend=backend,
                       weighted=True, w=wcol, **common)
        if init == "host-bz":
            adj = [set(g.neighbors(v).tolist()) for v in range(g.n)]
            core_np, order = bz_core_decomposition(g.n, adj)
            rank = np.zeros(g.n, dtype=np.int32)
            rank[np.asarray(order, dtype=np.int64)] = np.arange(
                g.n, dtype=np.int32
            )
            core = torch.from_numpy(core_np.astype(np.int32)).to(dev)
            label = rank_to_labels(torch.from_numpy(rank).to(dev))
        elif init == "jax-peel":
            core, rank = peel_decomposition(src, dst, val, g.n)
            label = rank_to_labels(rank)
        else:
            raise ValueError(init)
        return cls(core=core, label=label, kernel_backend=kernel_backend,
                   **common)

    @classmethod
    def from_state(
        cls,
        arrays: Mapping[str, np.ndarray],
        device=None,
        kernel_backend: Optional[str] = None,
        engine: str = "unified",
        weighted: bool = False,
        validate: bool = True,
        mesh: Optional[Any] = None,
        vertex_sharding: str = "replicated",
        freelist: str = "interleaved",
        mesh_shape: Optional[Tuple[int, int]] = None,
        frontier_exchange: str = "bitmask",
        frontier_cap: int = 0,
    ) -> "CoreMaintainer":
        """Build a maintainer from the reference's state as numpy arrays:
        the keys of its ``save`` payload (n, capacity, src, dst, valid,
        n_edges, core, label, and ``w`` of a weighted maintainer). The
        unweighted engine ignores a weight column, as the reference's
        unweighted ``load`` does; ``weighted=True`` without one adopts
        unit weights. Under ``engine="host"`` the saved ``n_edges`` is
        raised to the slot high-water mark (the bump pointer). Under
        ``engine="sharded"`` every rank calls it with the same (global)
        arrays and keeps its shard."""
        _check_config(engine, kernel_backend, weighted, mesh,
                      vertex_sharding, freelist, mesh_shape,
                      frontier_exchange, frontier_cap)
        dev = resolve_device(device)
        missing = [k for k in _STATE_KEYS if k not in arrays]
        if missing:
            raise KeyError(f"state lacks {missing}")

        def t(key, dtype):
            # a copy: the slot table is updated in place, and the caller's
            # arrays (a reference maintainer's buffers) must stay as given
            return torch.from_numpy(np.array(arrays[key], dtype=dtype)).to(dev)

        n = int(np.asarray(arrays["n"]))
        return cls(
            n=n,
            capacity=int(np.asarray(arrays["capacity"])),
            src=t("src", np.int32),
            dst=t("dst", np.int32),
            valid=t("valid", np.bool_),
            n_edges=t("n_edges", np.int32).reshape(()),
            core=t("core", np.int32),
            label=t("label", np.int64),
            n_levels=n + 2,
            engine=engine,
            kernel_backend=kernel_backend,
            validate=validate,
            weighted=weighted,
            w=t("w", np.int32) if weighted and "w" in arrays else None,
            mesh=mesh,
            vertex_sharding=vertex_sharding,
            freelist=freelist,
            mesh_shape=mesh_shape,
            frontier_exchange=frontier_exchange,
            frontier_cap=frontier_cap,
        )

    # -- queries -------------------------------------------------------------
    @property
    def edge_slot(self) -> Dict[Tuple[int, int], int]:
        """Host mirror of the live edge -> GLOBAL slot table, built on
        first access after a batch (queries tolerate the sync; the edit
        path never reads it). A collective under the sharded engine."""
        if self.slot_cache is None:
            src, dst, valid, _ = self._table()
            live = torch.nonzero(valid).flatten().cpu().numpy()
            src = src.cpu().numpy()[live]
            dst = dst.cpu().numpy()[live]
            lo, hi = np.minimum(src, dst), np.maximum(src, dst)
            self.slot_cache = dict(zip(zip(lo.tolist(), hi.tolist()),
                                       live.tolist()))
        return self.slot_cache

    def cores(self) -> np.ndarray:
        """Core numbers ``[n]`` (gathered under ``"range"`` / ``"halo"``:
        a collective)."""
        return self._full(self.core).cpu().numpy()[: self.n]

    def labels(self) -> np.ndarray:
        """k-order labels ``[n]`` (gathered under ``"range"`` /
        ``"halo"``: a collective)."""
        return self._full(self.label).cpu().numpy()[: self.n]

    def order_lt(self, u: int, v: int) -> bool:
        core, label = self._full(self.core), self._full(self.label)
        cu, cv = int(core[u]), int(core[v])
        if cu != cv:
            return cu < cv
        return int(label[u]) < int(label[v])

    @property
    def live_edges(self) -> int:
        """The live edge count (one ``all_reduce`` under the sharded
        engine: every rank calls it)."""
        count = self.valid.sum(dtype=torch.int32)
        if self._sharded_table:
            count = psum(count, self._table_group, "psum_table")
        return int(count)

    # -- validation ----------------------------------------------------------
    def _validated(self, edges, what: str, weights=None):
        """Normalize an edge batch and enforce endpoint bounds: with
        ``validate`` an out-of-range endpoint raises, otherwise the
        offending rows are dropped. ``weights``, when given, must align
        row for row, always validate strictly (positive integers) and
        are dropped with their rows. Returns ``edges``, or ``(edges,
        weights)`` when weights were passed."""
        edges = _as_edge_array(edges)
        if weights is not None:
            weights = np.asarray(weights, dtype=np.int64).reshape(-1)
            if weights.shape[0] != edges.shape[0]:
                raise ValueError(
                    f"{what} weights have length {weights.shape[0]} but "
                    f"the edge batch has {edges.shape[0]} rows"
                )
            if weights.size and (weights < 1).any():
                raise ValueError(
                    f"{what} edge weights must be positive integers, "
                    f"got {int(weights[weights < 1][0])}"
                )
        if edges.size:
            bad = ((edges < 0) | (edges >= self.n)).any(axis=1)
            if bad.any():
                if self.validate:
                    row = edges[bad][0]
                    raise ValueError(
                        f"{what} edge {row.tolist()} out of range for "
                        f"n={self.n} (pass validate=False to mask instead)"
                    )
                edges = edges[~bad]
                if weights is not None:
                    weights = weights[~bad]
        if weights is not None:
            return edges, weights
        return edges

    # -- edits ----------------------------------------------------------------
    def apply_batch(self, insert_edges=None, remove_edges=None,
                    insert_weights=None) -> BatchStats:
        """Apply one mixed batch (removals first, then insertions) on the
        device. Both lists are validated before any state changes, so a
        rejected batch is rejected whole (the host path commits its
        removals before it looks at the insert list). Under
        ``engine="host"`` the batch runs the seed two-call path and its
        statistics are composed from both calls.

        ``insert_weights`` (weighted maintainers only) aligns row for row
        with ``insert_edges``; omitted means weight 1 per edge. An
        in-batch duplicate keeps the FIRST row's weight, inserting a
        live edge keeps the stored weight, and remove + insert in one
        batch commits the new weight."""
        if insert_weights is not None and not self.weighted:
            raise ValueError(
                "insert_weights= needs weighted=True; the unweighted "
                "engine would silently drop the weights"
            )
        if self.weighted:
            if insert_weights is None:
                insert_weights = np.ones(
                    _as_edge_array(insert_edges).shape[0], dtype=np.int64)
            ins, ins_w = self._validated(insert_edges, "insert",
                                         weights=insert_weights)
        else:
            ins = self._validated(insert_edges, "insert")
        rm = self._validated(remove_edges, "remove")
        if self.engine == "host":
            return self._apply_batch_host(ins, rm)
        dev = self.device
        b_ins = ins.shape[0]
        if b_ins == 0 and rm.shape[0] == 0:
            z = torch.zeros((), dtype=torch.int32, device=dev)
            stats = BatchStats(
                z, z, z, z, z, z, z,
                torch.zeros((), dtype=torch.bool, device=dev), z,
                torch.tensor(self.hwm_ub, dtype=torch.int32, device=dev),
                z, z,
            )
            self.last_batch_stats = stats
            return stats
        self._ensure_capacity(b_ins)
        iu = _pad_pow2(ins[:, 0], 0)
        iv = _pad_pow2(ins[:, 1], 0)
        iok = np.zeros(len(iu), dtype=bool)
        iok[:b_ins] = True
        ru = _pad_pow2(rm[:, 0], 0)
        rv = _pad_pow2(rm[:, 1], 0)
        rok = np.zeros(len(ru), dtype=bool)
        rok[: rm.shape[0]] = True
        # pow2 bound on the slot high-water mark incl. this batch: every
        # edge pass runs over this slot prefix only, and (the free-list
        # fills the lowest holes first) it always holds >= b_ins free
        # slots
        window = self._window(b_ins)
        if 0 < self._last_window < window:
            # the bucket would grow — refresh the exact bounds (one
            # amortized sync) before paying for wider passes
            self._refresh_bounds()
            window = self._window(b_ins)
        self._last_window = window
        if self.weighted:
            # padded lanes carry weight 1; iok=False keeps them out of
            # the slot writes and the total-weight promotion bound
            iw = _pad_pow2(ins_w.astype(np.int32), 1)
            lanes = [torch.from_numpy(x).to(dev)
                     for x in (iu, iv, iw, iok, ru, rv, rok)]
            state = (self.src, self.dst, self.valid, self.w, self.core,
                     self.label, self.n_edges)
        else:
            lanes = [torch.from_numpy(x).to(dev)
                     for x in (iu, iv, iok, ru, rv, rok)]
            state = (self.src, self.dst, self.valid, self.core, self.label,
                     self.n_edges)
        if self.engine == "sharded":
            # every rank runs its shard's window with the same batch; the
            # sparse cap is a second bucket, keyed off the padded batch
            fcap = self._frontier_bucket(max(len(iu), len(ru)))
            out = self._sharded_fn(window, fcap)(*state, *lanes)
        elif self.weighted:
            out = apply_batch_weighted(
                *state, *lanes, self.n, self.n_levels, window,
                kernel_backend=self.kernel_backend)
        else:
            out = apply_batch(*state, *lanes, self.n, self.n_levels, window,
                              kernel_backend=self.kernel_backend)
        if self.weighted:
            (self.src, self.dst, self.valid, self.w, self.core, self.label,
             self.n_edges, stats) = out
        else:
            (self.src, self.dst, self.valid, self.core, self.label,
             self.n_edges, stats) = out
        # monotone bounds: each insert can raise the densest shard's
        # high-water mark and the live count by at most one; removals
        # only help
        self.hwm_ub = min(self.hwm_ub + b_ins, self._local_cap)
        self.live_ub = min(self.live_ub + b_ins, self.capacity)
        self.slot_cache = None
        self.last_batch_stats = stats
        if self.frontier_exchange == "sparse" and self.frontier_cap == 0:
            # kept for the planned cap's feedback (_observed_frontier)
            self._frontier_obs.append(stats.max_frontier)
        return stats

    def _sharded_fn(self, local_active: int,
                    frontier_cap: int = 0) -> Callable:
        """This rank's sharded program for one (per-shard window,
        frontier cap) bucket pair, both powers of two, built once."""
        key = (local_active, frontier_cap)
        fn = self._sharded_fns.get(key)
        if fn is None:
            fn = self._sharded_fns[key] = make_sharded_apply(
                self.mesh, self.n, self.n_levels, axis=EDGE_AXIS,
                local_active=local_active,
                vertex_sharding=self.vertex_sharding,
                freelist=self.freelist,
                frontier_exchange=self.frontier_exchange,
                frontier_cap=frontier_cap,
                kernel_backend=self.kernel_backend,
                weighted=self.weighted,
            )
        return fn

    def _frontier_bucket(self, b_pad: int) -> int:
        """The sparse cap for a batch padded to ``b_pad`` lanes
        (``plan_frontier_cap``; 0 when the exchange is dense)."""
        return plan_frontier_cap(
            self.frontier_exchange, self.frontier_cap, b_pad,
            self._n_vertex_pad // self._d_v,
            observed=self._observed_frontier(),
        )

    def _observed_frontier(self) -> int:
        """Running quantile (p95) of the stream's per-batch
        ``stats.max_frontier``, the datum the planned sparse cap grows
        from. The reference reads only the device scalars that are
        already computed, one host deciding for the whole SPMD program;
        here every rank plans its own cap and the ranks must agree on
        it (the caps size their all_gathers), so every rank reads every
        earlier batch's value, which the owner group's all-reduce made
        the same on every rank: one host read of what the previous
        batch already synchronized."""
        if self.frontier_exchange != "sparse" or self.frontier_cap > 0:
            return 0
        self._frontier_hist += [int(x) for x in self._frontier_obs]
        self._frontier_obs = []
        hist = self._frontier_hist = self._frontier_hist[-256:]
        if not hist:
            return 0
        return sorted(hist)[int(0.95 * (len(hist) - 1))]

    def _apply_batch_host(self, ins: np.ndarray,
                          rm: np.ndarray) -> BatchStats:
        """``apply_batch`` under ``engine="host"``: removals, then
        insertions, each through its own call, with the reference's
        twelve statistics (no recycling, no exchange; the high-water
        mark is the bump pointer)."""
        n_live0 = len(self.edge_slot)
        rm_st = self._remove_edges_host(rm)
        n_live1 = len(self.edge_slot)
        renumbered = self.host_renumbered
        in_st = self._insert_edges_host(ins)
        renumbered = renumbered or self.host_renumbered
        dev = self.device

        def i32(x):
            return torch.tensor(x, dtype=torch.int32, device=dev)

        stats = BatchStats(
            n_inserted=i32(len(self.edge_slot) - n_live1),
            n_removed=i32(n_live0 - n_live1),
            insert_rounds=in_st.rounds,
            n_promoted=in_st.n_promoted,
            v_plus=in_st.v_plus,
            remove_rounds=rm_st.rounds,
            n_dropped=rm_st.n_dropped,
            renumbered=torch.tensor(renumbered, device=dev),
            n_recycled=i32(0),  # the host path reclaims by _compact
            high_water=self.n_edges,  # the bump pointer
            max_frontier=torch.maximum(in_st.max_frontier,
                                       rm_st.max_frontier),
            n_overflow=i32(0),  # one device: no exchange to overflow
        )
        self.last_batch_stats = stats
        return stats

    def insert_edges(self, edges: np.ndarray,
                     weights: Optional[np.ndarray] = None) -> InsertStats:
        if self.engine == "host":
            if weights is not None:
                raise ValueError(
                    "weights= needs weighted=True (a device engine)"
                )
            return self._insert_edges_host(edges)
        st = self.apply_batch(insert_edges=edges, insert_weights=weights)
        self.last_insert_stats = InsertStats(
            rounds=st.insert_rounds,
            n_promoted=st.n_promoted,
            v_plus=st.v_plus,
            max_frontier=st.max_frontier,
        )
        return self.last_insert_stats

    def remove_edges(self, edges: np.ndarray) -> RemoveStats:
        if self.engine == "host":
            return self._remove_edges_host(edges)
        st = self.apply_batch(remove_edges=edges)
        self.last_remove_stats = RemoveStats(
            rounds=st.remove_rounds, n_dropped=st.n_dropped,
            max_frontier=st.max_frontier,
        )
        return self.last_remove_stats

    # -- the seed two-call path (engine="host") ---------------------------
    def _zeros(self, k: int) -> tuple:
        z = torch.zeros((), dtype=torch.int32, device=self.device)
        return (z,) * k

    def _insert_edges_host(self, edges) -> InsertStats:
        """Dedup on the host against the ``edge_slot`` dict (self-loops,
        in-batch repeats and live edges dropped, the first row kept),
        make room (``_compact``, then ``_grow``), record the new slots
        in the dict, then ``insert.insert_batch`` on the device and the
        renumber gate."""
        self.host_renumbered = False
        edges = self._validated(edges, "insert")
        lo = np.minimum(edges[:, 0], edges[:, 1])
        hi = np.maximum(edges[:, 0], edges[:, 1])
        keep, seen = [], set()
        slot_table = self.edge_slot
        for key in zip(lo.tolist(), hi.tolist()):
            if key[0] == key[1] or key in seen or key in slot_table:
                continue
            seen.add(key)
            keep.append(key)
        if not keep:
            self.last_insert_stats = None
            return InsertStats(*self._zeros(4))
        arr = np.asarray(keep, dtype=np.int32)
        if int(self.n_edges) + arr.shape[0] + 1 >= self.capacity:
            self._compact()  # replaces the slot dict: re-read below
            if int(self.n_edges) + arr.shape[0] + 1 >= self.capacity:
                self._grow(arr.shape[0])
        base = int(self.n_edges)
        slot_table = self.edge_slot
        for i, key in enumerate(keep):
            slot_table[key] = base + i
        new_ok = np.zeros(_pow2_roundup(arr.shape[0]), dtype=bool)
        new_ok[: arr.shape[0]] = True
        lanes = [torch.from_numpy(x).to(self.device)
                 for x in (_pad_pow2(arr[:, 0], 0), _pad_pow2(arr[:, 1], 0),
                           new_ok)]
        (self.src, self.dst, self.valid, self.n_edges, self.core,
         self.label, stats) = insert_batch(
            self.src, self.dst, self.valid, self.core, self.label, *lanes,
            self.n_edges, self.n, self.n_levels,
        )
        # on the host path n_edges IS the bump pointer (slot high-water)
        self.hwm_ub = int(self.n_edges)
        self.live_ub = self.hwm_ub
        self.host_renumbered = self._maybe_renumber()
        self.last_insert_stats = stats
        return stats

    def _remove_edges_host(self, edges) -> RemoveStats:
        """Pop each live edge's slot from the ``edge_slot`` dict, then
        ``remove.remove_batch`` on the device (slots padded with -1) and
        the renumber gate."""
        self.host_renumbered = False
        edges = self._validated(edges, "remove")
        slots = []
        slot_table = self.edge_slot
        for a, b in edges.tolist():
            slot = slot_table.pop((min(a, b), max(a, b)), None)
            if slot is not None:
                slots.append(slot)
        if not slots:
            self.last_remove_stats = None
            return RemoveStats(*self._zeros(3))
        padded = _pad_pow2(np.asarray(slots, dtype=np.int32), -1)
        self.valid, self.core, self.label, stats = remove_batch(
            self.src, self.dst, self.valid, self.core, self.label,
            torch.from_numpy(padded).to(self.device), self.n,
            self.n_levels,
        )
        self.host_renumbered = self._maybe_renumber()
        self.last_remove_stats = stats
        return stats

    def _maybe_renumber(self) -> bool:
        """The host path's renumber gate, after each call: relabel iff
        the label space is out of headroom."""
        if bool(needs_renumber(self.label)):
            self.label = renumber(self.core, self.label)
            return True
        return False

    # -- capacity planning ----------------------------------------------------
    def _window(self, b_ins: int) -> int:
        return plan_window(self.hwm_ub, b_ins, self._local_cap)

    def _refresh_bounds(self) -> None:
        """Replace the monotone planning bounds with the exact values the
        device already computed (``stats.high_water`` and ``n_edges``)."""
        if self.last_batch_stats is not None:
            self.hwm_ub = int(self.last_batch_stats.high_water)
        self.live_ub = int(self.n_edges)

    def _ensure_capacity(self, b_ins: int) -> None:
        """Make the per-shard window able to hold the live slots plus
        this batch: bound check -> exact-bound refresh -> defrag, growing
        in the same re-layout if a packed table would still leave no
        headroom. Every decision reads replicated values."""
        if self.hwm_ub + b_ins + 1 < self._local_cap:
            return
        self._refresh_bounds()
        if self.hwm_ub + b_ins + 1 < self._local_cap:
            return
        nd = self._n_shards
        new_cap = self.capacity
        # after a balanced defrag the densest shard holds ceil(live / nd)
        while -(-self.live_ub // nd) + b_ins + 1 >= new_cap // nd:
            new_cap = max(new_cap * 2, new_cap + nd * (2 * b_ins + 16))
        self._defrag_to(new_cap)

    def _defrag_to(self, new_cap: int) -> None:
        """Repack the live slots into a balanced layout of ``new_cap``
        slots (compact and grow in one re-layout), on the device: live
        edge j lands on shard ``j % n_shards``, so every shard's
        high-water mark starts at ``ceil(live / n_shards)`` (one shard:
        the lowest ``m`` slots). ``new_cap`` is padded to a multiple of
        the shard count. Preserves core/label state."""
        nd = self._n_shards
        new_cap += (-new_cap) % nd
        src0, dst0, val0, w0 = self._table()
        live = torch.nonzero(val0).flatten()
        m = int(live.shape[0])
        if new_cap <= m:
            raise ValueError(
                f"defrag target {new_cap} cannot hold {m} live edges"
            )
        dev = self.device
        # live edge j lands on shard j % nd, at local slot j // nd (every
        # rank computes the same re-layout and keeps its block)
        j = torch.arange(m, device=dev)
        tgt = (j % nd) * (new_cap // nd) + j // nd
        src = torch.zeros(new_cap, dtype=torch.int32, device=dev)
        dst = torch.zeros(new_cap, dtype=torch.int32, device=dev)
        val = torch.zeros(new_cap, dtype=torch.bool, device=dev)
        src[tgt] = src0[live]
        dst[tgt] = dst0[live]
        val[tgt] = True
        self.src, self.dst, self.valid = src, dst, val
        if self.weighted:
            w = torch.zeros(new_cap, dtype=torch.int32, device=dev)
            w[tgt] = w0[live]
            self.w = w
        self.n_edges = torch.tensor(m, dtype=torch.int32, device=dev)
        self.capacity = new_cap
        self.live_ub = m
        self.hwm_ub = -(-m // nd)
        self._last_window = 0  # fresh layout: let the next batch re-bucket
        self.slot_cache = None
        self._sharded_table = False
        if self.engine == "sharded":
            self._place_sharded()

    def _compact(self) -> None:
        """Drop tombstoned slots: the host path's reclaim (the unified
        engine recycles them in its batch program)."""
        self._defrag_to(self.capacity)

    def _grow(self, need: int) -> None:
        self._grow_to(max(self.capacity * 2, self.capacity + 2 * need + 16))

    def _grow_to(self, new_cap: int) -> None:
        """Extend the slot table with dead headroom (the host path's
        growth step). The sharded engine grows through ``_defrag_to``,
        which also re-strides across the shards."""
        if self.engine == "sharded":
            self._defrag_to(new_cap)
            return
        pad = new_cap - self.capacity
        if pad <= 0:
            return
        self.src = torch.cat([self.src, self.src.new_zeros(pad)])
        self.dst = torch.cat([self.dst, self.dst.new_zeros(pad)])
        self.valid = torch.cat([self.valid, self.valid.new_zeros(pad)])
        if self.weighted:
            self.w = torch.cat([self.w, self.w.new_zeros(pad)])
        self.capacity = new_cap

    # -- persistence -------------------------------------------------------------
    def state(self) -> Dict[str, np.ndarray]:
        """The checkpoint payload as numpy arrays — the reference's
        ``save`` keys and dtypes (``w`` added when weighted), so
        ``from_state`` of either package reads it. The table is the
        GLOBAL one (gathered under the sharded engine: a collective), so
        the payload loads on any engine and shard count."""
        src, dst, valid, w = self._table()
        payload = dict(
            n=self.n,
            capacity=self.capacity,
            src=src.cpu().numpy(),
            dst=dst.cpu().numpy(),
            valid=valid.cpu().numpy(),
            n_edges=self.n_edges.cpu().numpy(),
            core=self.cores(),
            label=self.labels(),
        )
        if self.weighted:
            payload["w"] = w.cpu().numpy()
        return payload

    def save(self, path: str) -> None:
        """Checkpoint the maintainer (the free-list is implicit: a dead
        slot is exactly a ``valid=False`` entry). Under the sharded
        engine every rank calls it; rank 0 writes, behind a barrier."""
        payload = self.state()
        if not self._sharded_table:
            np.savez_compressed(path, **payload)
            return
        if axis_index(self._table_group) == 0:
            np.savez_compressed(path, **payload)
        torch.distributed.barrier(group=self._table_group)

    @classmethod
    def load(cls, path: str, device=None,
             kernel_backend: Optional[str] = None,
             engine: str = "unified", weighted: bool = False,
             validate: bool = True, mesh: Optional[Any] = None,
             vertex_sharding: str = "replicated",
             freelist: str = "interleaved",
             mesh_shape: Optional[Tuple[int, int]] = None,
             frontier_exchange: str = "bitmask",
             frontier_cap: int = 0) -> "CoreMaintainer":
        """Load a checkpoint of either package, saved on any engine and
        shard count (under ``engine="sharded"`` every rank loads it)."""
        with np.load(path) as z:
            arrays = {k: z[k] for k in z.files}
        return cls.from_state(arrays, device=device,
                              kernel_backend=kernel_backend, engine=engine,
                              weighted=weighted, validate=validate,
                              mesh=mesh, vertex_sharding=vertex_sharding,
                              freelist=freelist, mesh_shape=mesh_shape,
                              frontier_exchange=frontier_exchange,
                              frontier_cap=frontier_cap)


def maintainer_from_edges(n: int, edges, **kw) -> CoreMaintainer:
    """A maintainer of the graph on ``n`` vertices with these edges
    (``build_csr`` drops self-loops and duplicates)."""
    return CoreMaintainer.from_graph(build_csr(n, edges), **kw)
