"""k-order label maintenance — the port of the reference's
``core/order.py`` for one device.

Vertices carry ``(core, label)`` pairs; the k-order predicate is the
lexicographic comparison ``(core[u], label[u]) < (core[v], label[v])``.
Batch "insert at head of O_{K+1}" / "append at tail of O_{K-1}" are
vectorized label assignments below the level minimum / above the level
maximum, and the OM relabel is a global renumber by one lexsort.

Labels are int64 with ``LABEL_GAP = 1 << 20`` and sentinels +-2^62,
exactly as the reference defines them. The ring variants for
owner-sharded vertex state come with ROADMAP Queue 1 item 8.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

LABEL_GAP = 1 << 20
_NEG = -(1 << 62)
_POS = 1 << 62
_I64_MAX = torch.iinfo(torch.int64).max
_I64_MIN = torch.iinfo(torch.int64).min


def lexsort(keys) -> torch.Tensor:
    """``jnp.lexsort``: the permutation that sorts by the LAST key first,
    ties broken by the earlier keys, then by index. Built from stable
    sorts, least significant key first."""
    perm = torch.argsort(keys[0], stable=True)
    for k in keys[1:]:
        perm = perm[torch.argsort(k[perm], stable=True)]
    return perm


def _ranks(perm: torch.Tensor, dtype=torch.int32) -> torch.Tensor:
    """Inverse permutation: ``zeros.at[perm].set(arange)``."""
    out = torch.empty(perm.shape[0], dtype=dtype, device=perm.device)
    out[perm] = torch.arange(perm.shape[0], dtype=dtype, device=perm.device)
    return out


def _segment_reduce(vals, seg, n_seg: int, reduce: str, empty: int):
    """``jax.ops.segment_{min,max}``: ``empty`` where a segment has no
    member; ids outside ``[0, n_seg)`` are dropped."""
    out = torch.full((n_seg,), empty, dtype=vals.dtype, device=vals.device)
    ok = (seg >= 0) & (seg < n_seg)
    seg = torch.where(ok, seg, torch.full_like(seg, n_seg)).long()
    # a spare row takes the dropped ids and is cut away
    out = torch.cat([out, out.new_full((1,), empty)])
    out.scatter_reduce_(0, seg, vals, reduce, include_self=False)
    return out[:n_seg]


def level_min_labels(core, label, exclude, n_levels: int) -> torch.Tensor:
    """Min label per level over vertices not in ``exclude``: ``_POS``
    when every member is excluded, the int64 maximum for a level with
    no vertex at all (the identity of ``segment_min``)."""
    vals = torch.where(exclude, torch.full_like(label, _POS), label)
    return _segment_reduce(vals, core, n_levels, "amin", _I64_MAX)


def level_max_labels(core, label, exclude, n_levels: int) -> torch.Tensor:
    vals = torch.where(exclude, torch.full_like(label, _NEG), label)
    return _segment_reduce(vals, core, n_levels, "amax", _I64_MIN)


def place_block(core_new, label, moving, at_head: bool, n_levels: int,
                round_key: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Assign fresh labels to ``moving`` vertices at the head (insertion,
    O_{K+1}) or tail (removal / Backward eviction) of their new level.

    Within a level the moving block is ordered by ``(round_key, old
    label)`` — old-label order for promotions (required to preserve the
    k-order certificate), eviction-round order for Backward-evicted
    vertices, any order for removal drops.
    """
    n = core_new.shape[0]
    base_min = level_min_labels(core_new, label, moving, n_levels)
    base_max = level_max_labels(core_new, label, moving, n_levels)
    base_min = torch.where(base_min == _POS, torch.zeros_like(base_min),
                           base_min)
    base_max = torch.where(base_max == _NEG, torch.zeros_like(base_max),
                           base_max)

    # order moving vertices by (new level, round_key, old label)
    sort_level = torch.where(moving, core_new,
                             torch.full_like(core_new, n_levels))
    if round_key is None:
        perm = lexsort((label, sort_level))
    else:
        perm = lexsort((label, round_key, sort_level))
    ranks = _ranks(perm)
    first_rank = _segment_reduce(
        torch.where(moving, ranks, torch.full_like(ranks, 2**30)),
        core_new, n_levels, "amin", torch.iinfo(torch.int32).max,
    )
    count = torch.zeros(n_levels, dtype=torch.int32, device=core_new.device)
    count.index_add_(0, core_new, moving.to(torch.int32))
    lvl = core_new.long()
    pos = ranks - first_rank[lvl]  # position within the moving block
    if at_head:
        newlab = base_min[lvl] - LABEL_GAP * (count[lvl] - pos).long()
    else:
        newlab = base_max[lvl] + LABEL_GAP * (pos + 1).long()
    return torch.where(moving, newlab, label)


def renumber(core, label) -> torch.Tensor:
    """Global relabel: fresh LABEL_GAP-spaced labels in (core, label)
    order."""
    return _ranks(lexsort((label, core)), torch.int64) * LABEL_GAP


def needs_renumber(label) -> torch.Tensor:
    """True when the label space is running out of headroom."""
    lim = 1 << 61
    return (label.min() < -lim) | (label.max() > lim)


def maybe_renumber(core, label,
                   force: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Renumber gate: relabel iff the label space is out of headroom.
    Returns ``(label, did_renumber)``. The reference folds the gate into
    its compiled program with ``lax.cond``; here it is a Python branch,
    one host sync per batch."""
    need = needs_renumber(label)
    if force is not None:
        need = need | force
    if bool(need):
        label = renumber(core, label)
    return label, need
