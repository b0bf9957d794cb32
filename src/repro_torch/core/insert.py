"""Batch-parallel edge insertion maintenance (paper Algorithm 5) — the
port of the reference's ``core/insert.py``, on one device or on a rank
of the replicated sharded engine.

Round structure (all levels of all inserted edges processed together):

  1. SEED    — k-order roots of the pending edges, last round's promoted
               vertices, and every certificate violator.
  2. FORWARD — masked wave expansion along same-level k-order-increasing
               edges, gated by ``hi + dout_same + din_reached > core``.
  3. EVICT   — the candidate fixpoint on the reached set: evict v while
               ``hi(v) + |same-level candidate nbrs| <= core(v)``.
  4. COMMIT  — survivors' core += 1, placed at the head of O_{K+1} in
               old label order; evicted vertices go to the tail of O_K
               in (eviction round, old label) order.

Rounds repeat while the k-order certificate is violated somewhere. Each
of the reference's ``lax.while_loop``s is a Python loop here with one
host sync per iteration (its condition); round counts match exactly.
The weighted engine's promotion phase (``weighted_promotion_fixpoint``)
has no order machinery: it is the removal phase's weighted h-index
fixpoint started from ``core + total batch weight``. The host engine
(``engine="host"``) inserts through ``write_edge_slots`` (bump
allocation) and ``insert_batch``, in plain PyTorch as the reference's
host path runs lax.

The ``*_halo`` twins run the promotion rounds under halo-sharded vertex
state (``vertex_sharding="range"`` / ``"halo"``): masks and decisions on
OWNED slices, edge passes over the batch's HALO working set, each
wave's and eviction round's mask refreshed into the halo
(``session.refresh_mask``: one reduce_scatter, or the sparse exchange),
labels placed by ``order.place_block_ring``, and every loop condition
an all-reduced verdict (``session.any_owned``).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from . import graph_ops as G
from ..kernels import coremaint
from .order import place_block, place_block_ring
from .remove import (weighted_core_fixpoint_pass,
                     weighted_core_fixpoint_pass_halo)
from .vertex_layout import (HaloSession, ReplicatedVertices, _note,
                            all_gather, axis_index)


class InsertStats(NamedTuple):
    rounds: torch.Tensor        # outer promotion rounds
    n_promoted: torch.Tensor    # |V*| over the whole batch
    v_plus: torch.Tensor        # |V+| — vertices ever reached by FORWARD
    max_frontier: torch.Tensor  # max exchanged-mask count over all rounds


def freelist_alloc(valid: torch.Tensor, iok: torch.Tensor,
                   axis=None, hierarchical: bool = False
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Recycling slot allocator: every dead slot IS the free-list.

    Dead slots (``~valid``) are ranked in (local slot, shard) order and
    the batch's kept inserts (``iok``, ranked by cumsum) take the
    lowest-ranked free slots one to one. Filling the lowest local
    indices first, interleaved ACROSS shards, keeps the densest shard's
    high-water mark (which sizes the per-shard window) near
    ``live / n_shards``. On one shard every order is ascending slot id,
    so the unified and one-rank sharded engines pick the same slots.

    With ``axis`` (a process group; each rank holds its shard of the
    table) each rank ranks its own dead slots from one ``all_gather``
    of the windowed dead masks, ``[world, window]``, writes the batch
    ranks that land in its shard and drops the rest.
    ``hierarchical`` gathers ONE scalar per shard instead (the per-shard
    free count, ``[world]``): the ranking becomes (shard, local slot),
    which gives up the interleaved shard balance for O(world) bytes a
    batch. Neither changes the live edge set or the cores and labels.

    Returns ``(lpos, iok)``: ``lpos[b]`` is this shard's local slot for
    insert lane ``b`` (``== capacity`` when the lane is masked or lands
    on another shard), and ``iok`` narrowed by the free-exhaustion
    guard (replicated: it depends on global counts only). Sync-free:
    the reference's ``mode="drop"`` scatter becomes a scatter into one
    spare row.
    """
    capacity = valid.shape[0]
    b = iok.shape[0]
    dev = valid.device
    dead = ~valid
    if axis is None:
        total_free = dead.sum(dtype=torch.int32)
        drank = torch.cumsum(dead, 0, dtype=torch.int32) - 1
    elif hierarchical:
        my_free = dead.sum(dtype=torch.int32).reshape(1)
        counts = all_gather(my_free, axis, "gather_freelist")[:, 0]
        me = axis_index(axis)
        total_free = counts.sum(dtype=torch.int32)
        # my dead slot with local free-rank r has global rank (free slots
        # on shards before me) + r: (shard, slot) order
        base = counts[:me].sum(dtype=torch.int32)
        drank = base + torch.cumsum(dead, 0, dtype=torch.int32) - 1
    else:
        all_dead = all_gather(dead, axis, "gather_freelist")  # [world, cap]
        me = axis_index(axis)
        col = all_dead.sum(0, dtype=torch.int32)  # dead slots per index
        total_free = col.sum(dtype=torch.int32)
        # free rank of MY dead slot i = dead slots at indices < i (any
        # shard) + dead slots at index i on shards before me
        col_before = torch.cumsum(col, 0, dtype=torch.int32) - col
        row_before = all_dead[:me].sum(0, dtype=torch.int32)
        drank = col_before + row_before
    rank = torch.cumsum(iok, 0, dtype=torch.int32) - 1
    iok = iok & (rank < total_free)
    # ranks past the batch can never be targets (rank < b always): their
    # dead slots park on the spare row b
    spos = torch.where(dead & (drank < b), drank, torch.full_like(drank, b))
    slot_of_rank = torch.full((b + 1,), capacity, dtype=torch.int32,
                              device=dev)
    slot_of_rank.scatter_(
        0, spos.long(), torch.arange(capacity, dtype=torch.int32, device=dev)
    )
    lpos = torch.where(iok, slot_of_rank[rank.clamp(min=0)],
                       torch.full_like(rank, capacity))
    return lpos, iok


def write_edge_slots(src, dst, valid, n_edges, new_src, new_dst, new_ok
                     ) -> Tuple[torch.Tensor, ...]:
    """Bump slot allocation — the seed path behind ``engine="host"``,
    where ``n_edges`` is the bump pointer (slot high-water mark) and
    tombstones are reclaimed only by the host's ``_compact``. Lane ``b``
    of the kept inserts takes slot ``n_edges + cumsum(new_ok)[b] - 1``.

    The reference parks its padding lanes on the last slot and rewrites
    that slot's own values; only the ``new_ok`` lanes are written here,
    which leaves the same table. Callers guarantee that
    ``n_edges + batch + 1 <= capacity``. Returns the updated ``(src,
    dst, valid, n_edges)``.
    """
    slot = n_edges + torch.cumsum(new_ok, 0, dtype=torch.int32) - 1
    at = slot[new_ok].long()
    src = src.index_put((at,), new_src[new_ok].to(src.dtype))
    dst = dst.index_put((at,), new_dst[new_ok].to(dst.dtype))
    valid = valid.index_put((at,), torch.ones_like(at, dtype=torch.bool))
    return src, dst, valid, n_edges + new_ok.sum(dtype=torch.int32)


def insert_batch(src, dst, valid, core, label, new_src, new_dst, new_ok,
                 n_edges, n: int, n_levels: int
                 ) -> Tuple[torch.Tensor, ...]:
    """Insert ``(new_src, new_dst)`` (masked by ``new_ok``) and restore
    core numbers + k-order labels — the host engine's insertion, in
    plain PyTorch (the reference runs it in lax only).

    Returns ``(src, dst, valid, n_edges, core, label, stats)``.
    """
    src, dst, valid, n_edges = write_edge_slots(
        src, dst, valid, n_edges, new_src, new_dst, new_ok
    )
    core0 = core
    hi, dout_same = G.hi_and_dout_same(src, dst, valid, core, label, n)
    core, label, rounds, v_plus, fmax = promotion_fixpoint(
        src, dst, valid, core, label, new_src, new_dst, new_ok,
        hi, dout_same, n, n_levels, kernel_backend="torch",
    )
    stats = InsertStats(
        rounds=rounds,
        n_promoted=(core != core0).sum(dtype=torch.int32),
        v_plus=v_plus.sum(dtype=torch.int32),
        max_frontier=fmax,
    )
    return src, dst, valid, n_edges, core, label, stats


def promotion_fixpoint(
    src, dst, valid, core, label, new_src, new_dst, new_ok, hi, dout_same,
    n: int, n_levels: int,
    layout: ReplicatedVertices | None = None,
    kernel_backend: str = "torch",
) -> Tuple[torch.Tensor, ...]:
    """Promotion rounds for pending edges already written into the table.

    ``hi``/``dout_same`` must describe the CURRENT (core, label, valid)
    state including the pending edges; each round recomputes them after
    its commit. Returns ``(core, label, rounds, v_plus_mask,
    max_frontier)``.

    ``kernel_backend="cuda"`` runs every wave/evict statistic through
    ``coo_stat``; where the layout completes locally the terminating
    statistics and the violator check run as ``fused_promotion_stats``,
    under a mesh axis as ``coo_stat(stat="hi_dout")`` completed by the
    layout before the check. With a mesh layout the table arrays are
    this rank's shard and every loop condition reads completed values,
    so all ranks run the same rounds.
    """
    if layout is None:
        layout = ReplicatedVertices(n, device=core.device)
    # the fused violator check needs the COMPLETED statistics in the
    # kernel: only where the layout completes locally (one device)
    fuse_decision = kernel_backend == "cuda" and G.completes_locally(layout)
    dev = core.device
    promoted_prev = torch.zeros(n, dtype=torch.bool, device=dev)
    v_plus = torch.zeros(n, dtype=torch.bool, device=dev)
    fmax = torch.zeros((), dtype=torch.int32, device=dev)
    rounds = 0
    while True:
        # SEED: roots of pending edges (order-min endpoint at current
        # state)
        cs, cd = core[new_src], core[new_dst]
        e_src_lt = (cs < cd) | ((cs == cd) & (label[new_src] < label[new_dst]))
        root = torch.where(e_src_lt, new_src, new_dst)
        seed = torch.zeros(n, dtype=torch.int32, device=dev).index_add_(
            0, root, new_ok.to(torch.int32)) > 0
        viol = layout.gather_mask((hi + dout_same) > layout.own(core))
        fmax = torch.maximum(fmax, layout.frontier_peak(viol))
        seed = seed | viol | promoted_prev

        reach, passing, wave_fmax = _forward_reach(
            src, dst, valid, core, label, seed, hi, dout_same, n, layout,
            kernel_backend=kernel_backend,
        )
        cand0 = reach & passing
        cand, evict_round, ev_fmax = _evict_fixpoint(
            src, dst, valid, core, cand0, hi, n, layout,
            kernel_backend=kernel_backend,
        )
        fmax = torch.maximum(fmax, torch.maximum(wave_fmax, ev_fmax))

        new_core = core + cand.to(torch.int32)
        # promoted -> head of O_{K+1} in old-label order
        label = place_block(new_core, label, cand, at_head=True,
                            n_levels=n_levels)
        # Backward-evicted -> tail of O_K in (eviction round, old label)
        # order; restores the dout <= core certificate
        evicted = cand0 & ~cand
        label = place_block(new_core, label, evicted, at_head=False,
                            n_levels=n_levels, round_key=evict_round)
        # (hi, dout_same) for the NEXT round; continue only while the
        # k-order certificate is violated somewhere
        if fuse_decision:
            hi, dout_same, viol_next = coremaint.fused_promotion_stats(
                src, dst, valid, new_core, label, n
            )
            changed = viol_next.any()
        else:
            hi, dout_same = G.hi_and_dout_same(
                src, dst, valid, new_core, label, n, layout,
                backend=kernel_backend,
            )
            changed = layout.any_owned(
                (hi + dout_same) > layout.own(new_core)
            )
        core = new_core
        promoted_prev = cand
        v_plus = v_plus | reach
        rounds += 1
        if not bool(changed):
            break
    rounds = torch.tensor(rounds, dtype=torch.int32, device=dev)
    return core, label, rounds, v_plus, fmax


def _forward_reach(src, dst, valid, core, label, seed, hi, dout_same,
                   n: int, layout: ReplicatedVertices | None = None,
                   kernel_backend: str = "torch"):
    """Monotone fixpoint of gated forward expansion. Returns ``(reach,
    passing, max_frontier)``; ``passing`` uses the optimistic test with
    din counted over reached-and-passing predecessors only."""
    if layout is None:
        layout = ReplicatedVertices(n, device=core.device)
    core_own = layout.own(core)
    reach = seed
    passing = layout.gather_mask((hi + dout_same) > core_own)
    fmax = layout.frontier_peak(passing)
    while True:
        rp = reach & passing
        din, grow = G.din_and_expand(src, dst, valid, core, label, rp, n,
                                     layout, backend=kernel_backend)
        new_passing = layout.gather_mask((hi + dout_same + din) > core_own)
        grow_full = layout.gather_mask(grow)
        fmax = torch.maximum(fmax, torch.maximum(
            layout.frontier_peak(new_passing),
            layout.frontier_peak(grow_full),
        ))
        new_reach = reach | grow_full
        changed = (new_reach != reach).any() | (new_passing != passing).any()
        reach, passing = new_reach, new_passing
        if not bool(changed):
            return reach, passing, fmax


def _evict_fixpoint(src, dst, valid, core, cand, hi, n: int,
                    layout: ReplicatedVertices | None = None,
                    kernel_backend: str = "torch"):
    """Greatest fixpoint of the candidate support test. Returns
    (surviving candidates, eviction round per vertex, max_frontier);
    the round numbers order the Backward tail placement (never-evicted
    keep 0)."""
    if layout is None:
        layout = ReplicatedVertices(n, device=core.device)
    core_own = layout.own(core)
    evict_round = torch.zeros(n, dtype=torch.int32, device=core.device)
    fmax = torch.zeros((), dtype=torch.int32, device=core.device)
    rnd = 1
    while True:
        support = hi + G.count_same_level_in(src, dst, valid, core, cand, n,
                                             layout, backend=kernel_backend)
        keep = layout.gather_mask(support > core_own)
        fmax = torch.maximum(fmax, layout.frontier_peak(keep))
        new_cand = cand & keep
        newly_evicted = cand & ~new_cand
        evict_round = torch.where(newly_evicted,
                                  torch.full_like(evict_round, rnd),
                                  evict_round)
        rnd += 1
        changed = (new_cand != cand).any()
        cand = new_cand
        if not bool(changed):
            return cand, evict_round, fmax


def weighted_promotion_fixpoint(src, dst, valid, w, core, total_w, n: int,
                                layout: ReplicatedVertices | None = None,
                                kernel_backend: str = "torch"):
    """Weighted promotion phase: the removal phase's decrease-only
    h-index fixpoint (remove.weighted_core_fixpoint_pass), started from
    the sound upper bound ``core + total_w``. A batch of total inserted
    weight W can raise any vertex by at most W, including vertices with
    no inserted edge incident (docs/DESIGN.md §4.5 of the reference).
    Returns ``(core, rounds, max_frontier)``."""
    return weighted_core_fixpoint_pass(
        src, dst, valid, w, core + total_w, n, layout=layout,
        kernel_backend=kernel_backend,
    )


def weighted_promotion_fixpoint_halo(src_h, dst_h, valid, w, core_own,
                                     core_h, total_w,
                                     session: HaloSession,
                                     kernel_backend: str = "torch"):
    """``weighted_promotion_fixpoint`` on a halo working set: the bound
    ``+ total_w`` is replicated, so the halo image stays exact by the
    same local add (sentinel rows drift to ``total_w``; no valid edge
    reads them). Returns ``(core_own, core_h, rounds, max_frontier)``."""
    return weighted_core_fixpoint_pass_halo(
        src_h, dst_h, valid, w, core_own + total_w, core_h + total_w,
        session, kernel_backend=kernel_backend,
    )


def promotion_fixpoint_halo(src_h, dst_h, valid, core_own, label_own,
                            core_h, label_h, new_src, new_dst, u_pos, v_pos,
                            new_ok, hi, dout_same, session: HaloSession,
                            n_levels: int, kernel_backend: str = "torch"):
    """The promotion rounds on a halo working set — no ``[n]`` buffer.

    The mirror of ``promotion_fixpoint`` with every mask and decision in
    the OWNED domain and every edge-pass input in the HALO domain:
    ``src_h``/``dst_h`` index the halo, ``u_pos``/``v_pos`` are the
    pending lanes' halo positions (every lane endpoint is in every
    rank's halo, so the root choice is the same everywhere) and
    ``new_src``/``new_dst`` stay global ids for the owned seed scatter.
    ``hi``/``dout_same`` are OWNED. The wave and eviction masks cross
    the owner group as halo refreshes (``session.refresh_mask``), the
    commits run ``order.place_block_ring``, then one (core, label) halo
    refresh restricted to the moved owners (``session.refresh_values``);
    each refresh is sparse under a ``frontier_cap`` and falls back to
    the dense regather on overflow.

    Returns ``(core_own, label_own, core_h, label_h, rounds, v_plus_own,
    max_frontier, n_overflow)``: ``n_overflow`` counts the refreshes
    that fell back (an int32 scalar, the same on every rank).
    """
    hcap = session.halo_cap
    d_v = session.layout.n_shards
    dev = core_own.device
    zmask = torch.zeros(session.n_owned, dtype=torch.bool, device=dev)
    promoted_prev = v_plus = zmask
    fmax = torch.zeros((), dtype=torch.int32, device=dev)
    rounds = n_ovf = 0
    while True:
        # SEED: roots of the pending edges at the current state
        cu, cv = core_h[u_pos], core_h[v_pos]
        e_src_lt = (cu < cv) | ((cu == cv)
                                & (label_h[u_pos] < label_h[v_pos]))
        root = torch.where(e_src_lt, new_src, new_dst)
        seed = session.add_at(session.zeros(), root,
                              new_ok.to(torch.int32)) > 0
        viol = (hi + dout_same) > core_own
        fmax = torch.maximum(fmax, session.frontier_peak(viol))
        seed = seed | viol | promoted_prev

        reach, passing, wave_fmax, wave_ovf = _forward_reach_halo(
            src_h, dst_h, valid, core_own, core_h, label_h, seed, hi,
            dout_same, session, kernel_backend=kernel_backend,
        )
        cand0 = reach & passing
        cand, evict_round, ev_fmax, ev_ovf = _evict_fixpoint_halo(
            src_h, dst_h, valid, core_own, core_h, cand0, hi, session,
            kernel_backend=kernel_backend,
        )
        fmax = torch.maximum(fmax, torch.maximum(wave_fmax, ev_fmax))

        new_core = core_own + cand.to(torch.int32)
        # promoted -> head of O_{K+1} in old-label order
        label_own = place_block_ring(
            new_core, label_own, cand, at_head=True, n_levels=n_levels,
            axis=session.axis, n_shards=d_v, note=_note,
        )
        # Backward-evicted -> tail of O_K in (eviction round, old label)
        # order
        evicted = cand0 & ~cand
        label_own = place_block_ring(
            new_core, label_own, evicted, at_head=False, n_levels=n_levels,
            axis=session.axis, n_shards=d_v, round_key=evict_round,
            note=_note,
        )
        # cand0 covers every vertex whose core or label just moved
        core_h, label_h, ovf = session.refresh_values(
            new_core, label_own, cand0, core_h, label_h)
        n_ovf += wave_ovf + ev_ovf + ovf
        new_hi, new_dout = G.hi_and_dout_same(
            src_h, dst_h, valid, core_h, label_h, hcap, session,
            backend=kernel_backend,
        )
        changed = session.any_owned((new_hi + new_dout) > new_core)
        core_own = new_core
        promoted_prev = cand
        v_plus = v_plus | reach
        hi, dout_same = new_hi, new_dout
        rounds += 1
        if not bool(changed):
            break
    rounds = torch.tensor(rounds, dtype=torch.int32, device=dev)
    n_ovf = torch.tensor(n_ovf, dtype=torch.int32, device=dev)
    return (core_own, label_own, core_h, label_h, rounds, v_plus, fmax,
            n_ovf)


def _forward_reach_halo(src_h, dst_h, valid, core_own, core_h, label_h,
                        seed, hi, dout_same, session: HaloSession,
                        kernel_backend: str = "torch"):
    """``_forward_reach`` with OWNED loop masks and a halo refresh of
    the reached-and-passing frontier each wave. Returns ``(reach,
    passing, max_frontier, n_overflow)``: owned masks, and the waves
    whose sparse refresh fell back (a Python int)."""
    hcap = session.halo_cap
    reach = seed
    passing = (hi + dout_same) > core_own
    fmax = session.frontier_peak(passing)
    n_ovf = 0
    while True:
        rp_h, ovf = session.refresh_mask(reach & passing)
        n_ovf += ovf
        din, grow = G.din_and_expand(src_h, dst_h, valid, core_h, label_h,
                                     rp_h, hcap, session,
                                     backend=kernel_backend)
        new_passing = (hi + dout_same + din) > core_own
        new_reach = reach | grow
        fmax = torch.maximum(fmax, torch.maximum(
            session.frontier_peak(new_passing), session.frontier_peak(grow)))
        changed = session.any_owned((new_reach != reach)
                                    | (new_passing != passing))
        reach, passing = new_reach, new_passing
        if not bool(changed):
            return reach, passing, fmax, n_ovf


def _evict_fixpoint_halo(src_h, dst_h, valid, core_own, core_h, cand, hi,
                         session: HaloSession,
                         kernel_backend: str = "torch"):
    """``_evict_fixpoint`` with OWNED candidate masks and a halo refresh
    each round. Returns ``(cand, evict_round, max_frontier,
    n_overflow)``: owned arrays, and the rounds whose sparse refresh
    fell back (a Python int)."""
    hcap = session.halo_cap
    dev = core_own.device
    evict_round = torch.zeros(session.n_owned, dtype=torch.int32, device=dev)
    fmax = torch.zeros((), dtype=torch.int32, device=dev)
    rnd = 1
    n_ovf = 0
    while True:
        cand_h, ovf = session.refresh_mask(cand)
        n_ovf += ovf
        support = hi + G.count_same_level_in(src_h, dst_h, valid, core_h,
                                             cand_h, hcap, session,
                                             backend=kernel_backend)
        keep = support > core_own
        fmax = torch.maximum(fmax, session.frontier_peak(keep))
        new_cand = cand & keep
        newly_evicted = cand & ~new_cand
        evict_round = torch.where(newly_evicted,
                                  torch.full_like(evict_round, rnd),
                                  evict_round)
        changed = session.any_owned(new_cand != cand)
        cand = new_cand
        rnd += 1
        if not bool(changed):
            return cand, evict_round, fmax, n_ovf
