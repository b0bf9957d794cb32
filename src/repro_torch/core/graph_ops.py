"""Vectorized per-vertex neighborhood statistics over COO edge slots.

The port of the reference's ``core/graph_ops.py``. Each undirected edge
is stored once; each statistic adds its per-edge indicators to both
endpoints. Every statistic takes an optional ``layout``
(core/vertex_layout.py): on a rank of the sharded engine the edge
arrays are this rank's slots and the local sums are COMPLETED by the
layout (one ``all_reduce(SUM)`` over the mesh axis for
``ReplicatedVertices``); with ``layout=None`` completion is the
identity.

This module is the KERNEL DISPATCH POINT: the round statistics accept
``backend="torch" | "cuda"``, the counterparts of the reference's
``"lax" | "pallas"``. The torch path gathers endpoint state and scatters
with an ``index_add_`` pair (``_seg2``), the port of the lax path. The
cuda path runs the hand-written kernels of ``kernels/coremaint.py`` and
produces the same LOCAL integer sums bit for bit, completed by the
layout exactly as the torch path's are, so the backend changes kernel
launches, never collectives. ``count_gt``,
``count_same_level_after``, ``count_same_level_before_in`` and
``expand_forward`` have no kernel backend, as in the reference.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..kernels import coremaint
from .vertex_layout import ReplicatedVertices, VertexLayout, pmax


def completes_locally(layout: Optional[VertexLayout]) -> bool:
    """True when the layout's completion is the identity (one device):
    partial statistics ARE the global statistics, so the fused kernels
    may commit per-vertex decisions after their edge pass. Under a mesh
    axis the decision waits for the layout's collective."""
    return layout is None or (
        isinstance(layout, ReplicatedVertices) and layout.axis is None
    )


def _complete(x: torch.Tensor, layout: Optional[VertexLayout]):
    return x if layout is None else layout.complete(x)


def _pmax(x: torch.Tensor, axis) -> torch.Tensor:
    return pmax(x, axis)


def slot_high_water(valid: torch.Tensor, axis=None) -> torch.Tensor:
    """1 + the largest valid slot index (0 when empty), int32 scalar.
    With ``axis`` (a rank's shard of the table) the result is the max
    over shards of each shard's LOCAL high-water mark — the "densest
    shard" bound that sizes the sharded engine's per-shard window."""
    idx = torch.arange(1, valid.shape[0] + 1, dtype=torch.int32,
                       device=valid.device)
    local = torch.where(valid, idx, torch.zeros_like(idx)).max()
    return _pmax(local, axis)


def _seg2(data_to_src: torch.Tensor, data_to_dst: torch.Tensor,
          src: torch.Tensor, dst: torch.Tensor, n: int,
          layout=None) -> torch.Tensor:
    """Two-direction segment sum, one ``index_add_`` per direction,
    completed by the layout."""
    out = torch.zeros((n,) + data_to_src.shape[1:], dtype=torch.int32,
                      device=src.device)
    out.index_add_(0, src, data_to_src.to(torch.int32))
    out.index_add_(0, dst, data_to_dst.to(torch.int32))
    return _complete(out, layout)


def degree(src, dst, valid, n: int, layout=None) -> torch.Tensor:
    one = valid.to(torch.int32)
    return _seg2(one, one, src, dst, n, layout)


def count_ge(src, dst, valid, vals, n: int, layout=None,
             backend: str = "torch") -> torch.Tensor:
    """mcd (Def 3.8): per-vertex count of neighbors w with
    vals[w] >= vals[v]."""
    if backend == "cuda":
        out = coremaint.coo_stat(src, dst, valid, vals, None, n, stat="mcd")
        return _complete(out, layout)[:, 0]
    cs, cd = vals[src], vals[dst]
    return _seg2(valid & (cd >= cs), valid & (cs >= cd), src, dst, n,
                 layout)


def count_gt(src, dst, valid, vals, n: int, layout=None) -> torch.Tensor:
    """Per-vertex count of neighbors w with vals[w] > vals[v]."""
    cs, cd = vals[src], vals[dst]
    return _seg2(valid & (cd > cs), valid & (cs > cd), src, dst, n, layout)


def hi_dout_indicators(core, label, u, v, ok):
    """Per-edge indicator columns of the promotion statistics: for each
    (u, v) edge masked by ``ok``, whether it contributes to hi(u),
    hi(v), dout_same(u), dout_same(v). Shared by the full passes and by
    the unified engine's O(batch) delta update."""
    cu, cv = core[u], core[v]
    same = ok & (cu == cv)
    hi_to_u = ok & (cv > cu)
    hi_to_v = ok & (cu > cv)
    dout_to_u = same & (label[v] > label[u])
    dout_to_v = same & (label[u] > label[v])
    return hi_to_u, hi_to_v, dout_to_u, dout_to_v


def hi_and_dout_same(src, dst, valid, core, label, n: int, layout=None,
                     backend: str = "torch"):
    """Packed (hi, dout_same) for the insertion round: one [n, 2]
    scatter carries the higher-core neighbor count and the same-level
    k-order successor count."""
    if backend == "cuda":
        out = _complete(coremaint.coo_stat(src, dst, valid, core, label, n,
                                           stat="hi_dout"), layout)
        return out[:, 0], out[:, 1]
    hi_s, hi_d, do_s, do_d = hi_dout_indicators(core, label, src, dst,
                                                valid)
    out = _seg2(torch.stack([hi_s, do_s], dim=-1),
                torch.stack([hi_d, do_d], dim=-1), src, dst, n, layout)
    return out[:, 0], out[:, 1]


def mcd_hi_dout(src, dst, valid, core, label, n: int, layout=None,
                backend: str = "torch"):
    """Packed (mcd, hi, dout_same) — the removal fixpoint's support count
    together with both promotion-seeding statistics, in one [n, 3]
    scatter."""
    if backend == "cuda":
        out = _complete(coremaint.coo_stat(src, dst, valid, core, label, n,
                                           stat="mcd_hi_dout"), layout)
        return out[:, 0], out[:, 1], out[:, 2]
    hi_s, hi_d, do_s, do_d = hi_dout_indicators(core, label, src, dst,
                                                valid)
    cs, cd = core[src], core[dst]
    out = _seg2(torch.stack([valid & (cd >= cs), hi_s, do_s], dim=-1),
                torch.stack([valid & (cs >= cd), hi_d, do_d], dim=-1),
                src, dst, n, layout)
    return out[:, 0], out[:, 1], out[:, 2]


def count_same_level_after(src, dst, valid, core, label, n: int,
                           layout=None) -> torch.Tensor:
    """dout within level (part of Def 3.7): neighbors with equal core and
    a larger order label (same-level k-order successors)."""
    same = valid & (core[src] == core[dst])
    return _seg2(same & (label[dst] > label[src]),
                 same & (label[src] > label[dst]), src, dst, n, layout)


def count_same_level_before_in(src, dst, valid, core, label, mask, n: int,
                               layout=None) -> torch.Tensor:
    """din* (Def 3.6): same-level order-predecessors that are in
    ``mask``."""
    same = valid & (core[src] == core[dst])
    return _seg2(same & (label[dst] < label[src]) & mask[dst],
                 same & (label[src] < label[dst]) & mask[src],
                 src, dst, n, layout)


def count_same_level_in(src, dst, valid, core, mask, n: int, layout=None,
                        backend: str = "torch") -> torch.Tensor:
    """Per-vertex count of same-level neighbors inside ``mask``."""
    if backend == "cuda":
        out = coremaint.coo_stat(src, dst, valid, core, None, n,
                                 stat="same_in", aux=mask)
        return _complete(out, layout)[:, 0]
    same = valid & (core[src] == core[dst])
    return _seg2(same & mask[dst], same & mask[src], src, dst, n, layout)


def din_and_expand(src, dst, valid, core, label, rp, n: int, layout=None,
                   backend: str = "torch"):
    """FORWARD-wave statistics in one scatter: din counts reached-and-
    passing k-order predecessors, and frontier growth is ``din > 0``."""
    if backend == "cuda":
        out = coremaint.coo_stat(src, dst, valid, core, label, n,
                                 stat="din", aux=rp)
        din = _complete(out, layout)[:, 0]
        return din, din > 0
    same = valid & (core[src] == core[dst])
    fwd_to_dst = same & (label[src] < label[dst]) & rp[src]
    fwd_to_src = same & (label[dst] < label[src]) & rp[dst]
    din = _seg2(fwd_to_src, fwd_to_dst, src, dst, n, layout)
    return din, din > 0


def weighted_support(src, dst, valid, w, core, thresh, n: int, layout=None,
                     backend: str = "torch") -> torch.Tensor:
    """Weighted generalization of ``count_ge``: per-vertex SUM of incident
    edge weights to neighbours u with ``core[u] >= thresh[v]`` (the
    inner statistic of the weighted h-index bisection; with unit weights
    and ``thresh == core`` this IS mcd)."""
    if backend == "cuda":
        out = coremaint.coo_stat(src, dst, valid, core, None, n,
                                 stat="wsum", aux=thresh, edge_w=w)
        return _complete(out, layout)[:, 0]
    wi = w.to(torch.int32)
    zero = torch.zeros_like(wi)
    to_src = torch.where(valid & (core[dst] >= thresh[src]), wi, zero)
    to_dst = torch.where(valid & (core[src] >= thresh[dst]), wi, zero)
    return _seg2(to_src, to_dst, src, dst, n, layout)


def weighted_h_index(src, dst, valid, w, core, upper, n: int, layout=None,
                     backend: str = "torch") -> torch.Tensor:
    """Per-vertex weighted h-index by lockstep bisection:
    ``H_w(v) = max{h <= upper[v] : sum of weights to nbrs with
    core >= h is >= h}`` (Zhou et al., WWW'21). The feasible set is a
    prefix, so bisection over ``[0, upper]`` takes O(log maxW) steps,
    each ONE weighted support pass over the edge window. ``lo`` stays
    feasible (``lo = 0`` trivially); converged lanes re-test
    ``mid == lo`` and stay fixed, so the loop runs until the slowest
    lane converges. The reference's ``lax.while_loop`` is a Python loop
    here, one host sync per step (its condition). Under a mesh layout
    each step completes its support with one ``all_reduce``, so ``lo``
    and ``hi`` — and the loop condition — are the same on every rank."""
    upper = torch.clamp(upper.to(torch.int32), min=0)
    lo = torch.zeros_like(upper)
    hi = upper
    while bool((lo < hi).any()):
        mid = torch.div(lo + hi + 1, 2, rounding_mode="floor")
        s = weighted_support(src, dst, valid, w, core, mid, n, layout,
                             backend)
        ok = s >= mid
        lo, hi = torch.where(ok, mid, lo), torch.where(ok, hi, mid - 1)
    return lo


def expand_forward(src, dst, valid, core, label, frontier, n: int,
                   layout=None) -> torch.Tensor:
    """One wave of the Forward phase: the same-level k-order successors
    of ``frontier`` vertices, as a bool [n] mask."""
    same = valid & (core[src] == core[dst])
    hit_dst = same & frontier[src] & (label[src] < label[dst])
    hit_src = same & frontier[dst] & (label[dst] < label[src])
    return _seg2(hit_src, hit_dst, src, dst, n, layout) > 0
