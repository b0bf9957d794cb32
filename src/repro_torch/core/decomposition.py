"""Data-parallel core decomposition — the port of the reference's
``core/decomposition.py``.

* ``peel_decomposition`` — exact level-synchronous peeling (the ParK
  adaptation of BZ): every wave removes ALL vertices whose current
  degree is <= k. Produces core numbers AND a valid k-order (wave-major,
  vertex-id minor).
* ``h_index_decomposition`` — the decrease-only mcd fixpoint from the
  degree upper bound.

The reference's ``lax.while_loop``s become Python loops with one host
sync per wave (the loop condition); every other per-wave quantity stays
on the device.
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import graph_ops as G
from .order import LABEL_GAP

_BIG = 2**30


def peel_decomposition(src, dst, valid, n: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact core numbers + peel rank for a COO-slot graph.

    Returns ``(core [n] int32, rank [n] int32)`` where ``rank`` is a
    valid k-order position (rank sorts by (core, within-level peel
    order)).
    """
    dev = src.device
    d = G.degree(src, dst, valid, n)
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    core = torch.zeros(n, dtype=torch.int32, device=dev)
    rank = torch.zeros(n, dtype=torch.int32, device=dev)
    pos = torch.zeros((), dtype=torch.int32, device=dev)
    k = torch.zeros((), dtype=torch.int32, device=dev)
    big = torch.full_like(d, _BIG)
    while bool(alive.any()):
        min_alive = torch.where(alive, d, big).min()
        has_frontier = (alive & (d <= k)).any()
        k = torch.where(has_frontier, k, min_alive)
        frontier = alive & (d <= k)
        core = torch.where(frontier, k, core)
        # intra-wave rank by vertex id (any intra-wave order is a valid
        # BZ-certificate order)
        within = torch.cumsum(frontier, 0, dtype=torch.int32) - 1
        rank = torch.where(frontier, pos + within, rank)
        pos = pos + frontier.sum(dtype=torch.int32)
        alive = alive & ~frontier
        dec_src = valid & frontier[dst] & alive[src]
        dec_dst = valid & frontier[src] & alive[dst]
        d = d - G._seg2(dec_src, dec_dst, src, dst, n)
    return core, rank


def h_index_decomposition(src, dst, valid, n: int) -> torch.Tensor:
    """Exact core numbers via the decrease-only mcd fixpoint from the
    degree upper bound. Rounds are bounded by max(deg - core)."""
    core = G.degree(src, dst, valid, n)
    while True:
        mcd = G.count_ge(src, dst, valid, core, n)
        drop = (mcd < core) & (core > 0)
        core = core - drop.to(torch.int32)
        if not bool(drop.any()):
            return core


def rank_to_labels(rank) -> torch.Tensor:
    """Initial OM labels from peel ranks: int64 with LABEL_GAP spacing."""
    return rank.long() * LABEL_GAP
