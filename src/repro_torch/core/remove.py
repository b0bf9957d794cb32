"""Batch-parallel edge removal maintenance (paper Algorithm 6) — the port
of the reference's ``core/remove.py``, on one device or on a rank of the
replicated sharded engine (``layout`` over a mesh axis: every statistic
completed by one ``all_reduce``, every loop condition read from
completed values, so all ranks run the same rounds).

The mcd cascade is a decrease-only fixpoint over dense per-vertex state:

    round:  mcd[v] = |{u in N(v) : core[u] >= core[v]}|
            drop   = mcd < core
            core  -= drop

Every round handles all affected levels of all removed edges at once;
this round's droppers are placed at the tail of their new level.

The weighted engine runs ``weighted_core_fixpoint_pass`` instead: the
same decrease-only shape with the weighted h-index in place of mcd. The
host engine (``engine="host"``) removes through ``remove_batch``.

The ``*_halo`` twins run the same fixpoints under halo-sharded vertex
state (``vertex_sharding="range"`` / ``"halo"``): decisions on OWNED
slices, edge passes over the batch's HALO working set
(``vertex_layout.HaloSession``), labels placed by
``order.place_block_ring``, and every loop condition an all-reduced
verdict (``session.any_owned``).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from . import graph_ops as G
from .. import trace
from ..kernels import coremaint
from .order import place_block, place_block_ring
from .vertex_layout import HaloSession, ReplicatedVertices, _note


class RemoveStats(NamedTuple):
    rounds: torch.Tensor        # number of fixpoint rounds executed
    n_dropped: torch.Tensor     # |V*| — vertices whose core decreased
    max_frontier: torch.Tensor  # max drop-mask count over all rounds


def removal_fixpoint(
    src, dst, valid, core, label, n: int, n_levels: int,
    share_stats: bool = True,
    layout: ReplicatedVertices | None = None,
    kernel_backend: str = "torch",
) -> Tuple[torch.Tensor, ...]:
    """Run the decrease-only mcd fixpoint on an already-tombstoned table.

    Returns ``(core, label, rounds, hi, dout_same, max_frontier)``. With
    ``share_stats`` the (hi, dout_same) statistics come from the same
    packed scatter as the terminating mcd check, so they describe the
    FINAL state exactly — the unified engine seeds its promotion phase
    from them. ``share_stats=False`` scatters just the 1-column mcd and
    returns zero hi/dout_same.

    ``kernel_backend="cuda"`` runs each round as ``fused_removal_round``
    (stats, drop decision and core commit) where the layout completes
    locally; under a mesh axis the decision needs the completed mcd, so
    the round runs ``coo_stat(stat="mcd_hi_dout")`` (or ``"mcd"``),
    completes it, and decides after. The reference's
    ``lax.while_loop`` is a Python loop here, one host sync per round;
    ``rounds`` counts body executions, including the last one, which
    drops nothing.
    """
    if layout is None:
        layout = ReplicatedVertices(n, device=core.device)
    # decision fusion needs the GLOBAL mcd in the kernel: only where the
    # layout completes statistics locally (one device)
    fuse_decision = kernel_backend == "cuda" and G.completes_locally(layout)
    hi = dout_same = layout.zeros()
    fmax = torch.zeros((), dtype=torch.int32, device=core.device)
    rounds = 0
    while True:
        with trace.span("remove.round"):
            if fuse_decision:
                _, k_hi, k_dout, new_core, drop = (
                    coremaint.fused_removal_round(src, dst, valid, core,
                                                  label, n))
                if share_stats:
                    hi, dout_same = k_hi, k_dout
            else:
                if share_stats:
                    mcd, hi, dout_same = G.mcd_hi_dout(
                        src, dst, valid, core, label, n, layout,
                        backend=kernel_backend,
                    )
                else:
                    mcd = G.count_ge(src, dst, valid, core, n, layout,
                                     backend=kernel_backend)
                core_own = layout.own(core)
                drop = layout.gather_mask((mcd < core_own) & (core_own > 0))
                new_core = core - drop.to(torch.int32)
            fmax = torch.maximum(fmax, layout.frontier_peak(drop))
            rounds += 1
            trace.count_sync("core/remove.py::removal_fixpoint:round")
            if not bool(layout.any_owned(drop)):
                # the last round drops nothing: core and label stay
                break
            # place this round's droppers at the tail of their new level
            label = place_block(new_core, label, drop, at_head=False,
                                n_levels=n_levels)
            core = new_core
    trace.count_sync("core/remove.py::removal_fixpoint:hidden",
                     device=core.device)
    rounds = torch.tensor(rounds, dtype=torch.int32, device=core.device)
    return core, label, rounds, hi, dout_same, fmax


def remove_batch(src, dst, valid, core, label, slots, n: int,
                 n_levels: int) -> Tuple[torch.Tensor, ...]:
    """Remove the edges in ``slots`` (int32; ``-1`` entries are padding)
    and restore core numbers + k-order labels — the host engine's
    removal, in plain PyTorch (the reference runs it in lax only).

    Returns ``(valid, core, label, stats)``.
    """
    ok = slots >= 0
    safe = torch.where(ok, slots, torch.zeros_like(slots)).long()
    # a commutative scatter: padding (ok=False) adds 0, so it stays a
    # no-op even where it collides with a real removal of slot 0
    rm = torch.zeros(valid.shape[0], dtype=torch.int32, device=valid.device)
    rm.index_add_(0, safe, ok.to(torch.int32))
    valid = valid & (rm == 0)
    core0 = core
    core, label, rounds, _, _, fmax = removal_fixpoint(
        src, dst, valid, core, label, n, n_levels, share_stats=False,
        kernel_backend="torch",
    )
    stats = RemoveStats(
        rounds=rounds, n_dropped=(core != core0).sum(dtype=torch.int32),
        max_frontier=fmax,
    )
    return valid, core, label, stats


def weighted_core_fixpoint_pass(
    src, dst, valid, w, core, n: int,
    layout: ReplicatedVertices | None = None,
    kernel_backend: str = "torch",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Decrease-only weighted h-index fixpoint (Zhou et al., WWW'21): per
    round ``core <- min(core, H_w(core))`` (graph_ops.weighted_h_index)
    until no vertex moves. Converges to the exact weighted cores from
    any state upper-bounding them: the removal phase starts from the
    current cores, the promotion phase from ``core + W`` (W the batch's
    total inserted weight).

    Labels are frozen throughout; the engine renumbers once per batch.
    Returns ``(core, rounds, max_frontier)``; ``rounds`` counts body
    executions, including the last one, which moves nothing, as the
    reference's ``lax.while_loop`` does."""
    if layout is None:
        layout = ReplicatedVertices(n, device=core.device)
    fmax = torch.zeros((), dtype=torch.int32, device=core.device)
    rounds = 0
    while True:
        h = G.weighted_h_index(src, dst, valid, w, core, core, n, layout,
                               backend=kernel_backend)
        new_core = torch.minimum(core, h)
        changed = new_core < core
        fmax = torch.maximum(fmax, layout.frontier_peak(changed))
        rounds += 1
        core = new_core
        if not bool(layout.any_owned(changed)):
            break
    rounds = torch.tensor(rounds, dtype=torch.int32, device=core.device)
    return core, rounds, fmax


def removal_fixpoint_halo(src_h, dst_h, valid, core_own, label_own, core_h,
                          label_h, session: HaloSession, n_levels: int,
                          kernel_backend: str = "torch"):
    """The removal fixpoint on a halo working set — no ``[n]`` buffer.

    ``src_h``/``dst_h`` are the windowed endpoints as HALO positions
    (``session.locate``), ``core_h``/``label_h`` the current halo values,
    ``core_own``/``label_own`` the owned slices. A round: one halo-domain
    stats pass (``mcd_hi_dout``, kernel a on the card) completed into the
    owned slice by the session, the drop decision there, the ring label
    commit, ONE halo refresh of (core, label) restricted to the dropped
    owners (``session.refresh_values``: sparse under a ``frontier_cap``,
    the dense regather otherwise or on overflow), and the all-reduced
    continue verdict. Every round runs the whole body, as the reference's
    loop does (the last one commits nothing).

    Returns ``(core_own, label_own, core_h, label_h, rounds, hi,
    dout_same, max_frontier, n_overflow)``: ``hi``/``dout_same`` the
    terminating round's OWNED promotion-seeding stats, ``max_frontier``
    the LOCAL per-round owned drop-count peak (the engine completes it),
    ``n_overflow`` the rounds whose sparse refresh fell back to the
    dense regather (an int32 scalar, the same on every rank).
    """
    hcap = session.halo_cap
    d_v = session.layout.n_shards
    dev = core_own.device
    hi = dout_same = session.zeros()
    fmax = torch.zeros((), dtype=torch.int32, device=dev)
    rounds = n_ovf = 0
    while True:
        mcd, hi, dout_same = G.mcd_hi_dout(
            src_h, dst_h, valid, core_h, label_h, hcap, session,
            backend=kernel_backend,
        )
        drop = (mcd < core_own) & (core_own > 0)
        fmax = torch.maximum(fmax, session.frontier_peak(drop))
        new_core = core_own - drop.to(torch.int32)
        label_own = place_block_ring(
            new_core, label_own, drop, at_head=False, n_levels=n_levels,
            axis=session.axis, n_shards=d_v, note=_note,
        )
        core_h, label_h, ovf = session.refresh_values(
            new_core, label_own, drop, core_h, label_h)
        n_ovf += ovf
        cont = session.any_owned(drop)
        core_own = new_core
        rounds += 1
        if not bool(cont):
            break
    rounds = torch.tensor(rounds, dtype=torch.int32, device=dev)
    n_ovf = torch.tensor(n_ovf, dtype=torch.int32, device=dev)
    return (core_own, label_own, core_h, label_h, rounds, hi, dout_same,
            fmax, n_ovf)


def _weighted_h_index_halo(src_h, dst_h, valid, w, core_own, core_h,
                           session: HaloSession,
                           kernel_backend: str = "torch"):
    """Lockstep owned + halo weighted h-index bisection. ``(lo, hi)``
    live in BOTH domains: the owned pair decides, the halo pair is its
    exact image (each step's ``ok`` verdict is regathered as a dense
    int32 mask). The continuation is an all-reduced verdict (one
    ``any_owned`` a step), so every rank runs the same steps. Returns
    ``(lo_own, lo_halo)``."""
    hcap = session.halo_cap
    lo_o = torch.zeros_like(core_own)
    hi_o = torch.clamp(core_own, min=0)
    lo_h = torch.zeros_like(core_h)
    hi_h = torch.clamp(core_h, min=0)
    cont = session.any_owned(lo_o < hi_o)
    while bool(cont):
        mid_o = torch.div(lo_o + hi_o + 1, 2, rounding_mode="floor")
        mid_h = torch.div(lo_h + hi_h + 1, 2, rounding_mode="floor")
        s = G.weighted_support(src_h, dst_h, valid, w, core_h, mid_h, hcap,
                               session, backend=kernel_backend)
        ok_o = s >= mid_o
        ok_h = session.gather_values(ok_o.to(torch.int32)) > 0
        lo_o = torch.where(ok_o, mid_o, lo_o)
        hi_o = torch.where(ok_o, hi_o, mid_o - 1)
        lo_h = torch.where(ok_h, mid_h, lo_h)
        hi_h = torch.where(ok_h, hi_h, mid_h - 1)
        cont = session.any_owned(lo_o < hi_o)
    return lo_o, lo_h


def weighted_core_fixpoint_pass_halo(src_h, dst_h, valid, w, core_own,
                                     core_h, session: HaloSession,
                                     kernel_backend: str = "torch"):
    """``weighted_core_fixpoint_pass`` on a halo working set. The halo
    core image stays exact without a refresh: each round commits ``min``
    against the bisection result, whose halo copy is the owned one's
    exact image, so the halo update is the same local ``min`` (sentinel
    rows hold 0 and stay 0). Labels are frozen; the engine runs one ring
    renumber a batch. Returns ``(core_own, core_h, rounds,
    max_frontier)`` with ``max_frontier`` the LOCAL per-round owned
    change-count peak."""
    dev = core_own.device
    fmax = torch.zeros((), dtype=torch.int32, device=dev)
    rounds = 0
    while True:
        lo_o, lo_h = _weighted_h_index_halo(
            src_h, dst_h, valid, w, core_own, core_h, session,
            kernel_backend=kernel_backend,
        )
        new_o = torch.minimum(core_own, lo_o)
        new_h = torch.minimum(core_h, lo_h)
        changed = new_o < core_own
        fmax = torch.maximum(fmax, session.frontier_peak(changed))
        cont = session.any_owned(changed)
        core_own, core_h = new_o, new_h
        rounds += 1
        if not bool(cont):
            break
    rounds = torch.tensor(rounds, dtype=torch.int32, device=dev)
    return core_own, core_h, rounds, fmax
