"""Unified device-resident edit engine: one mixed insert+remove batch per
call — the port of the reference's ``core/engine.py``. ``batch_program``
is the ONE program body, shared by the unified engine (``axis=None``)
and every rank of the replicated sharded engine (core/sharded.py).

  1. REMOVE  — vectorized slot lookup of the removal edges against the
               live ``(src, dst, valid)`` table, tombstoning, then the
               mcd removal fixpoint (remove.removal_fixpoint).
  2. DEDUP   — in-batch duplicate and self-loop masking plus a
               membership test against the *post-removal* table, so an
               edge removed and re-inserted in one batch round-trips.
  3. INSERT  — slot allocation from the free-list
               (``insert.freelist_alloc``), table writes, and the
               promotion rounds (insert.promotion_fixpoint), seeded from
               the removal fixpoint's terminating (hi, dout_same) plus
               the new edges' O(batch) delta.
  4. RELABEL — the ``needs_renumber`` gate (order.maybe_renumber).

The reference donates its buffers to the compiled program; the port
instead updates the slot table IN PLACE: ``apply_batch`` hands
``batch_program`` views of the active window, and the tombstones and
slot writes land directly in the full-capacity tensors (no slice and
splice). ``apply_batch_weighted`` does the same with the slot table's
weight column.

``batch_program_halo`` is the same four phases for halo-sharded vertex
state (``vertex_sharding="range"`` and ``"halo"``, core/sharded.py):
``core`` and ``label`` are OWNED ``[n_owned]`` slices, and every edge
pass indexes a bounded per-batch HALO working set (``build_halo_ids``,
``vertex_layout.HaloSession``) instead of an ``[n]`` copy.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from . import graph_ops as G
from .. import trace
from .insert import (freelist_alloc, promotion_fixpoint,
                     promotion_fixpoint_halo, weighted_promotion_fixpoint,
                     weighted_promotion_fixpoint_halo)
from .order import maybe_renumber, maybe_renumber_ring
from .remove import (removal_fixpoint, removal_fixpoint_halo,
                     weighted_core_fixpoint_pass,
                     weighted_core_fixpoint_pass_halo)
from .vertex_layout import (HaloShardedVertices, ReplicatedVertices, _note,
                            _rows, psum)

_BIG = 1 << 62  # sentinel key: tombstones sort past every real key


class BatchStats(NamedTuple):
    """Per-batch statistics of the unified engine (device scalars)."""

    n_inserted: torch.Tensor     # edges actually added (post dedup)
    n_removed: torch.Tensor      # live slots tombstoned
    insert_rounds: torch.Tensor  # promotion rounds executed
    n_promoted: torch.Tensor     # |V*| of the insertion phase
    v_plus: torch.Tensor         # |V+| — vertices reached by FORWARD
    remove_rounds: torch.Tensor  # removal fixpoint rounds executed
    n_dropped: torch.Tensor      # |V*| of the removal phase
    renumbered: torch.Tensor     # True if the label renumber fired
    n_recycled: torch.Tensor     # inserts that reused a tombstoned slot
    high_water: torch.Tensor     # post-batch max per-shard high-water mark
    max_frontier: torch.Tensor   # max exchanged-mask count (both phases)
    n_overflow: torch.Tensor     # sparse exchanges that fell back dense


def edge_key(lo: torch.Tensor, hi: torch.Tensor, n: int) -> torch.Tensor:
    """Canonical int64 key of a normalized (lo <= hi) undirected edge."""
    return lo.long() * n + hi.long()


def table_lookup(src, dst, valid, n: int):
    """One sorted int64-key view of a slot table, shared by the removal
    slot lookup and the insert membership test. Returns
    ``lookup(qkey) -> (found, slot)``; tombstones carry a sentinel key
    that sorts past every real key, so they are never found."""
    capacity = src.shape[0]
    with trace.span("engine.lookup"):
        tkey = torch.where(valid, edge_key(torch.minimum(src, dst),
                                           torch.maximum(src, dst), n),
                           torch.full_like(src, _BIG, dtype=torch.int64))
        torder = torch.argsort(tkey, stable=True)
        tsorted = tkey[torder]

    def lookup(qkey):
        pos = torch.searchsorted(tsorted, qkey).clamp(max=capacity - 1)
        return tsorted[pos] == qkey, torder[pos]

    return lookup


def batch_dedup(ins_u, ins_v, ins_ok, n: int):
    """Normalize orientation, drop self-loops and in-batch duplicates
    (the stable sort keeps the first lane of each run of equal keys).
    Returns ``(ilo, ihi, iok, key)``."""
    ilo = torch.minimum(ins_u, ins_v)
    ihi = torch.maximum(ins_u, ins_v)
    iok = ins_ok & (ilo != ihi)
    key = edge_key(ilo, ihi, n)
    ikey = torch.where(iok, key, torch.full_like(key, _BIG))
    iperm = torch.argsort(ikey, stable=True)
    isorted = ikey[iperm]
    first = torch.ones_like(iok)
    first[1:] = isorted[1:] != isorted[:-1]
    keep = torch.empty_like(iok)
    keep[iperm] = first
    return ilo, ihi, iok & keep, key


@trace.spanned("engine.batch_program")
def batch_program(src, dst, valid, core, label, n_edges,
                  ins_u, ins_v, ins_ok, rm_u, rm_v, rm_ok,
                  n: int, n_levels: int, axis=None,
                  layout: ReplicatedVertices | None = None,
                  freelist: str = "interleaved",
                  kernel_backend: str = "torch",
                  w: Optional[torch.Tensor] = None,
                  ins_w: Optional[torch.Tensor] = None):
    """The mixed-batch program body over one slot table.

    ``src``/``dst``/``valid`` are updated IN PLACE (and returned); pass
    views of the active window to update a larger table. Returns
    ``(src, dst, valid, core, label, n_edges, stats)``.

    ``w`` (the slot table's weight column, updated in place too) and
    ``ins_w`` (per-lane insert weights) switch the program into WEIGHTED
    mode: both phases run the decrease-only weighted h-index fixpoint
    (removal from the current cores, promotion from ``core + total
    batch weight``), labels stay frozen through them, and ONE forced
    renumber re-canonicalizes the labels whenever any core moved. The
    weighted return is ``(src, dst, valid, w, core, label, n_edges,
    stats)``.

    ``axis`` (a process group: the mesh's ``"data"`` group) makes the
    table arrays this rank's shard of the slot table, while the vertex
    state and the batch lanes are replicated. It changes three things:
    the free-list ranks dead slots across shards (``freelist``:
    ``"interleaved"`` or ``"hierarchical"``, ``insert.freelist_alloc``);
    found flags and counts are completed by ``all_reduce`` (an edge
    lives in exactly one shard, so the sum of the local verdicts IS the
    global verdict); and every fixpoint statistic is completed by the
    vertex ``layout`` (``ReplicatedVertices(n, axis)`` by default), which
    turns the fused decisions off.
    """
    weighted = w is not None
    if weighted != (ins_w is not None):
        raise ValueError("w and ins_w come together (weighted mode)")
    if layout is None:
        layout = ReplicatedVertices(n, axis, device=core.device)
    capacity = src.shape[0]  # this rank's window under a mesh axis
    dev = src.device

    def allsum(x):
        return psum(x, axis, "psum_table")

    # pre-batch LOCAL high-water mark: inserts landing below it reclaimed
    # a tombstone (the n_recycled statistic)
    hwm0 = G.slot_high_water(valid)
    lookup = table_lookup(src, dst, valid, n)

    # ---- 1. removals: vectorized slot lookup + tombstoning -------------
    with trace.span("engine.tombstone"):
        rlo = torch.minimum(rm_u, rm_v)
        rhi = torch.maximum(rm_u, rm_v)
        rm_ok = rm_ok & (rlo != rhi)
        rfound, rslot = lookup(edge_key(rlo, rhi, n))
        found = rfound & rm_ok
        # scatter-max: not-found rows are no-ops even where they collide
        rm_mask = torch.zeros(capacity, dtype=torch.int32, device=dev)
        rm_mask = rm_mask.scatter_reduce_(0, rslot, found.to(torch.int32),
                                          "amax").bool()
        valid &= ~rm_mask
        n_removed = allsum(rm_mask.sum(dtype=torch.int32))

    core_pre_rm = core
    if weighted:
        core, rm_rounds, rm_fmax = weighted_core_fixpoint_pass(
            src, dst, valid, w, core, n, layout=layout,
            kernel_backend=kernel_backend,
        )
    else:
        core, label, rm_rounds, hi, dout_same, rm_fmax = removal_fixpoint(
            src, dst, valid, core, label, n, n_levels, layout=layout,
            kernel_backend=kernel_backend,
        )
    n_dropped = (core != core_pre_rm).sum(dtype=torch.int32)

    # ---- 2. insert dedup + membership against the post-removal table --
    with trace.span("engine.dedup"):
        ilo, ihi, iok, key = batch_dedup(ins_u, ins_v, ins_ok, n)
        ifound, islot_hit = lookup(key)
        exists = allsum((ifound & ~rm_mask[islot_hit]).to(torch.int32)) > 0
        iok = iok & ~exists

    # ---- 3. slot allocation from the free-list + table writes ----------
    with trace.span("engine.alloc"):
        lpos, iok = freelist_alloc(valid, iok, axis=axis,
                                   hierarchical=(freelist == "hierarchical"))
        # a kept lane has a slot inside this table unless it landed on
        # another shard (lpos == capacity)
        put = lpos < capacity
        # the mask indexes below (and ins_w's), and on a card the host
        # value ``True`` written into ``valid``
        trace.count_sync("core/engine.py::batch_program:hidden",
                         3 + weighted)
        trace.count_sync("core/engine.py::batch_program:hidden", device=dev)
        slots = lpos[put]
        src[slots] = ilo[put].to(src.dtype)
        dst[slots] = ihi[put].to(dst.dtype)
        valid[slots] = True
        if weighted:
            # dedup kept the FIRST lane of an in-batch duplicate, so its
            # weight is the one written; a live re-insert was masked above
            # and keeps the stored weight
            w[slots] = ins_w[put].to(w.dtype)
        n_inserted = iok.sum(dtype=torch.int32)
        n_recycled = allsum((lpos < hwm0).sum(dtype=torch.int32))
        # n_edges is the LIVE edge count
        n_edges = n_edges - n_removed + n_inserted

    # O(batch) delta keeps the shared (hi, dout_same) exact for the table
    # with the new edges
    core_pre_ins = core
    if weighted:
        total_w = torch.where(iok, ins_w, torch.zeros_like(ins_w)).sum(
            dtype=torch.int32)
        core, ins_rounds, ins_fmax = weighted_promotion_fixpoint(
            src, dst, valid, w, core, total_w, n, layout=layout,
            kernel_backend=kernel_backend,
        )
        v_plus = core != core_pre_ins
    else:
        hi_u, hi_v, do_u, do_v = G.hi_dout_indicators(core, label, ilo,
                                                      ihi, iok)
        hi = layout.add_at(hi, ilo, hi_u.to(torch.int32))
        hi = layout.add_at(hi, ihi, hi_v.to(torch.int32))
        dout_same = layout.add_at(dout_same, ilo, do_u.to(torch.int32))
        dout_same = layout.add_at(dout_same, ihi, do_v.to(torch.int32))

        core, label, ins_rounds, v_plus, ins_fmax = promotion_fixpoint(
            src, dst, valid, core, label, ilo, ihi, iok, hi, dout_same,
            n, n_levels, layout=layout, kernel_backend=kernel_backend,
        )
    n_promoted = (core != core_pre_ins).sum(dtype=torch.int32)

    # ---- 4. renumber gate ----------------------------------------------
    # the weighted fixpoints froze the labels, so any moved core forces
    # one relabel; force=None keeps the unweighted gate as it was
    force = ((n_dropped > 0) | (n_promoted > 0)) if weighted else None
    with trace.span("engine.renumber"):
        label, renumbered = maybe_renumber(core, label, force=force)

    stats = BatchStats(
        n_inserted=n_inserted,
        n_removed=n_removed,
        insert_rounds=ins_rounds,
        n_promoted=n_promoted,
        v_plus=v_plus.sum(dtype=torch.int32),
        remove_rounds=rm_rounds,
        n_dropped=n_dropped,
        renumbered=renumbered,
        n_recycled=n_recycled,
        high_water=G.slot_high_water(valid, axis),
        max_frontier=torch.maximum(rm_fmax, ins_fmax),
        n_overflow=torch.zeros((), dtype=torch.int32, device=dev),
    )
    if weighted:
        return src, dst, valid, w, core, label, n_edges, stats
    return src, dst, valid, core, label, n_edges, stats


def _pow2(x: int) -> int:
    return 1 << max(x - 1, 0).bit_length()


def halo_cap_for(window: int, lanes_total: int, n_pad: int) -> int:
    """Halo capacity of one batch: the pow2 bucket of the endpoint
    candidates — 2 per windowed slot and 2 per batch lane (insert and
    removal) — clamped to ``n_pad``. Deduplication only shrinks the
    candidate set, so every vertex the batch can reference fits."""
    return min(_pow2(2 * window + 2 * lanes_total), n_pad)


def build_halo_ids(layout: HaloShardedVertices, src, dst, ins_u, ins_v,
                   rm_u, rm_v, n: int) -> torch.Tensor:
    """This rank's halo membership: the sorted unique global ids its
    windowed slots or any batch lane reference, ``n_pad``-sentinel
    padded to ``halo_cap_for``'s bucket (int32). Tombstoned slots' ids
    are still valid vertex ids after the clip: they widen the halo,
    never corrupt it (every statistic is gated by ``valid``)."""
    cand = torch.cat([src, dst, ins_u, ins_v, rm_u, rm_v]).to(torch.int32)
    cand = cand.clamp(0, n - 1)
    hcap = halo_cap_for(int(src.shape[0]),
                        int(ins_u.shape[0]) + int(rm_u.shape[0]),
                        layout.n_pad)
    ids = torch.unique(cand)  # sorted; at most n <= n_pad ids
    _rows("build_halo_ids", hcap)
    if ids.shape[0] >= hcap:
        # hcap == n_pad here (the bucket was clamped): nothing to pad
        return ids[:hcap].contiguous()
    return torch.cat([ids, ids.new_full((hcap - ids.shape[0],),
                                        layout.n_pad)])


def batch_program_halo(src, dst, valid, core, label, n_edges,
                       ins_u, ins_v, ins_ok, rm_u, rm_v, rm_ok,
                       n: int, n_levels: int, table_axis,
                       layout: HaloShardedVertices,
                       freelist: str = "interleaved",
                       kernel_backend: str = "torch",
                       w: Optional[torch.Tensor] = None,
                       ins_w: Optional[torch.Tensor] = None):
    """``batch_program`` for halo-sharded vertex state: the same four
    phases over the same shard of the slot table (updated IN PLACE), with
    ``core``/``label`` OWNED ``[n_owned]`` slices and every edge pass
    over HALO positions (``session.locate``). ``table_axis`` is the group
    of EVERY rank the slots are sharded over (table verdicts: found
    flags, counts, the free-list, the high-water mark): on a 2-axis mesh
    the table group, numbered ``e * d_v + v`` (``launch.mesh.
    table_group``), so the degenerate ``(1, d)`` / ``(d, 1)`` meshes
    allocate the slots of the one-axis engines. The vertex scalars
    complete over the layout's owner group only (the owned slices are
    replicated across the pure-edge groups). Bit-identical cores, stats
    and k-order to ``batch_program`` on the assembled state, and labels
    but after a renumber with phantom vertices (which the ring ranks
    too). ``stats.n_overflow`` counts the sparse refreshes that fell
    back to the dense regather. Returns ``(src, dst, valid, core, label,
    n_edges, stats)``; weighted (``w``/``ins_w``) ``(src, dst, valid, w,
    core, label, n_edges, stats)``.
    """
    weighted = w is not None
    if weighted != (ins_w is not None):
        raise ValueError("w and ins_w come together (weighted mode)")
    capacity = src.shape[0]
    dev = src.device

    def allsum(x):  # table domain: every rank
        return psum(x, table_axis, "psum_table")

    def vsum(x):    # owned-vertex domain: the owner group only
        return psum(x.reshape(1), layout.axis, "psum_vertex")[0]

    hwm0 = G.slot_high_water(valid)
    lookup = table_lookup(src, dst, valid, n)

    # ---- 1. removals: vectorized slot lookup + tombstoning -------------
    rlo = torch.minimum(rm_u, rm_v)
    rhi = torch.maximum(rm_u, rm_v)
    rm_ok = rm_ok & (rlo != rhi)
    rfound, rslot = lookup(edge_key(rlo, rhi, n))
    found = rfound & rm_ok
    rm_mask = torch.zeros(capacity, dtype=torch.int32, device=dev)
    rm_mask = rm_mask.scatter_reduce_(0, rslot, found.to(torch.int32),
                                      "amax").bool()
    valid &= ~rm_mask
    n_removed = allsum(rm_mask.sum(dtype=torch.int32))

    # ---- the halo working set: ONE membership gather and one bounded
    # value regather a batch (weighted mode never reads a halo label)
    halo_ids = build_halo_ids(layout, src, dst, ins_u, ins_v, rm_u, rm_v, n)
    session = layout.bind(halo_ids)
    core_h = session.gather_values(core)
    label_h = None if weighted else session.gather_values(label)
    src_h = session.locate(src)
    dst_h = session.locate(dst)

    core_pre_rm = core
    if weighted:
        # the weighted fixpoints keep the halo exact without a refresh:
        # nothing there can overflow
        core, core_h, rm_rounds, rm_fmax = weighted_core_fixpoint_pass_halo(
            src_h, dst_h, valid, w, core, core_h, session,
            kernel_backend=kernel_backend,
        )
        rm_ovf = torch.zeros((), dtype=torch.int32, device=dev)
    else:
        (core, label, core_h, label_h, rm_rounds, hi, dout_same,
         rm_fmax, rm_ovf) = removal_fixpoint_halo(
            src_h, dst_h, valid, core, label, core_h, label_h, session,
            n_levels, kernel_backend=kernel_backend,
        )
    n_dropped = vsum((core != core_pre_rm).sum(dtype=torch.int32))

    # ---- 2. insert dedup + membership against the post-removal table --
    ilo, ihi, iok, key = batch_dedup(ins_u, ins_v, ins_ok, n)
    ifound, islot_hit = lookup(key)
    exists = allsum((ifound & ~rm_mask[islot_hit]).to(torch.int32)) > 0
    iok = iok & ~exists

    # ---- 3. slot allocation + table writes (as batch_program) ----------
    lpos, iok = freelist_alloc(valid, iok, axis=table_axis,
                               hierarchical=(freelist == "hierarchical"))
    put = lpos < capacity
    slots = lpos[put]
    src[slots] = ilo[put].to(src.dtype)
    dst[slots] = ihi[put].to(dst.dtype)
    valid[slots] = True
    if weighted:
        w[slots] = ins_w[put].to(w.dtype)
    n_inserted = iok.sum(dtype=torch.int32)
    n_recycled = allsum((lpos < hwm0).sum(dtype=torch.int32))
    n_edges = n_edges - n_removed + n_inserted

    # the new slots reference only lane endpoints, already in the halo,
    # so relocating the window is local compute
    src_h = session.locate(src)
    dst_h = session.locate(dst)

    core_pre_ins = core
    if weighted:
        total_w = torch.where(iok, ins_w, torch.zeros_like(ins_w)).sum(
            dtype=torch.int32)
        core, core_h, ins_rounds, ins_fmax = weighted_promotion_fixpoint_halo(
            src_h, dst_h, valid, w, core, core_h, total_w, session,
            kernel_backend=kernel_backend,
        )
        v_plus = core != core_pre_ins
        ins_ovf = torch.zeros((), dtype=torch.int32, device=dev)
    else:
        u_pos = session.locate(ilo)
        v_pos = session.locate(ihi)
        # O(batch) delta on the owned (hi, dout_same): the predicate
        # reads lane endpoints' halo values (the same on every rank), the
        # scatter lands in each owner's slice
        hi_u, hi_v, do_u, do_v = G.hi_dout_indicators(core_h, label_h,
                                                      u_pos, v_pos, iok)
        hi = layout.add_at(hi, ilo, hi_u.to(torch.int32))
        hi = layout.add_at(hi, ihi, hi_v.to(torch.int32))
        dout_same = layout.add_at(dout_same, ilo, do_u.to(torch.int32))
        dout_same = layout.add_at(dout_same, ihi, do_v.to(torch.int32))
        (core, label, core_h, label_h, ins_rounds, v_plus, ins_fmax,
         ins_ovf) = promotion_fixpoint_halo(
            src_h, dst_h, valid, core, label, core_h, label_h,
            ilo, ihi, u_pos, v_pos, iok, hi, dout_same, session, n_levels,
            kernel_backend=kernel_backend,
        )
    n_promoted = vsum((core != core_pre_ins).sum(dtype=torch.int32))

    # ---- 4. renumber gate (the ring relabel over the owner group) ------
    force = ((n_dropped > 0) | (n_promoted > 0)) if weighted else None
    label, renumbered = maybe_renumber_ring(
        core, label, layout.axis, layout.n_shards, note=_note, force=force)

    stats = BatchStats(
        n_inserted=n_inserted,
        n_removed=n_removed,
        insert_rounds=ins_rounds,
        n_promoted=n_promoted,
        v_plus=vsum(v_plus.sum(dtype=torch.int32)),
        remove_rounds=rm_rounds,
        n_dropped=n_dropped,
        renumbered=renumbered,
        n_recycled=n_recycled,
        high_water=G.slot_high_water(valid, table_axis),
        # the per-round peaks were tracked locally: ONE pmax completes them
        max_frontier=session.pmax_scalar(torch.maximum(rm_fmax, ins_fmax)),
        # every rank decided each fallback from the gathered counts, so
        # the local sum is the batch's count
        n_overflow=rm_ovf + ins_ovf,
    )
    if weighted:
        return src, dst, valid, w, core, label, n_edges, stats
    return src, dst, valid, core, label, n_edges, stats


def apply_batch(src, dst, valid, core, label, n_edges,
                ins_u, ins_v, ins_ok, rm_u, rm_v, rm_ok,
                n: int, n_levels: int, active_cap: int,
                kernel_backend: str = "torch"):
    """Apply one mixed batch (removals first, then insertions) and
    restore core numbers + k-order labels.

    ``ins_*``/``rm_*`` are padded edge lists masked by their ``_ok``
    flags. Every edge pass runs over the first ``active_cap`` slots (the
    host's pow2 bound on the slot high-water mark incl. this batch); the
    tail past it stays all-invalid. The slot table is updated in place.
    Returns ``(src, dst, valid, core, label, n_edges, stats)``.
    """
    _, _, _, core, label, n_edges, stats = batch_program(
        src[:active_cap], dst[:active_cap], valid[:active_cap],
        core, label, n_edges,
        ins_u, ins_v, ins_ok, rm_u, rm_v, rm_ok,
        n, n_levels, kernel_backend=kernel_backend,
    )
    return src, dst, valid, core, label, n_edges, stats


def apply_batch_weighted(src, dst, valid, w, core, label, n_edges,
                         ins_u, ins_v, ins_w, ins_ok, rm_u, rm_v, rm_ok,
                         n: int, n_levels: int, active_cap: int,
                         kernel_backend: str = "torch"):
    """``apply_batch`` with the slot table's weight column: ``w`` is
    updated in place over the same active window, and the batch's
    per-lane insert weights ``ins_w`` feed the weighted program body.
    Returns ``(src, dst, valid, w, core, label, n_edges, stats)``."""
    _, _, _, _, core, label, n_edges, stats = batch_program(
        src[:active_cap], dst[:active_cap], valid[:active_cap],
        core, label, n_edges,
        ins_u, ins_v, ins_ok, rm_u, rm_v, rm_ok,
        n, n_levels, kernel_backend=kernel_backend,
        w=w[:active_cap], ins_w=ins_w,
    )
    return src, dst, valid, w, core, label, n_edges, stats
