"""k-order label maintenance — the port of the reference's
``core/order.py`` for one device.

Vertices carry ``(core, label)`` pairs; the k-order predicate is the
lexicographic comparison ``(core[u], label[u]) < (core[v], label[v])``.
Batch "insert at head of O_{K+1}" / "append at tail of O_{K-1}" are
vectorized label assignments below the level minimum / above the level
maximum, and the OM relabel is a global renumber by one lexsort.

Labels are int64 with ``LABEL_GAP = 1 << 20`` and sentinels +-2^62,
exactly as the reference defines them.

The ring variants (``place_block_ring``, ``renumber_ring``,
``maybe_renumber_ring``) run the same placements on OWNED slices of
halo-sharded vertex state (``vertex_sharding="range"`` / ``"halo"``):
the global quantities ``place_block`` reads off per-level arrays are
accumulated over a ring of ``d_v - 1`` rotations of the other owners'
blocks (on a 2-axis mesh each edge row runs its own ring over its owner
group, on the same owned values), each
rotation one ``batch_isend_irecv`` (send to the next rank of the group,
receive from the previous), with O(n_owned) buffers. The reference's
``lax.scan`` is a Python loop and its ``lax.cond`` an ``if`` on an
all-reduced verdict.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist

from .vertex_layout import axis_index, pmax, pmin

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


# -- the ring variants (owned slices of halo-sharded vertex state) -----------
def _local_ranks(*keys) -> torch.Tensor:
    """Rank (int32) of each element under the stable lexsort of ``keys``
    (last key primary). Same-level labels are globally unique, so
    stability only tie-breaks sentinel rows nobody queries."""
    return _ranks(lexsort(keys))


def _ring_visiting(payload, axis, n_shards: int, note=None):
    """One ring rotation of ``payload`` (a tuple of ``[n_owned]``
    tensors) over the group ``axis``: after ``t`` rotations rank ``i``
    holds rank ``(i - t) mod n_shards``'s block. One
    ``batch_isend_irecv`` sends every array to the next rank and
    receives the previous rank's. At one shard the rotation is the
    identity (a rank cannot send to itself under NCCL): the payload
    itself. ``note(op, bytes)`` records one ``ppermute`` an array, as
    the reference traces it."""
    if note is not None:
        for arr in payload:
            note("ppermute", arr.numel() * arr.element_size())
    if n_shards == 1:
        return tuple(payload)
    me = axis_index(axis)
    nxt = dist.get_global_rank(axis, (me + 1) % n_shards)
    prv = dist.get_global_rank(axis, (me - 1) % n_shards)
    out, ops = [], []
    for arr in payload:
        arr = arr.contiguous()
        got = torch.empty_like(arr)
        ops += [dist.P2POp(dist.isend, arr, nxt, axis),
                dist.P2POp(dist.irecv, got, prv, axis)]
        out.append(got)
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return tuple(out)


def _ring_steps(n_shards: int) -> range:
    """The ring's steps ``1 .. max(n_shards - 1, 1)``: at one shard ONE
    step runs (its rotation recorded, its contribution masked), as the
    reference's scan does so its program is mesh-size independent."""
    return range(1, max(n_shards - 1, 1) + 1)


def place_block_ring(core_new, label, moving, at_head: bool, n_levels: int,
                     axis, n_shards: int,
                     round_key: Optional[torch.Tensor] = None,
                     note=None) -> torch.Tensor:
    """``place_block`` on OWNED slices only: the same labels, with no
    ``[n]`` or ``[n_levels]`` buffer on any rank.

    Every input is this rank's owned range ``[n_owned]``. The global
    quantities ``place_block`` reads off per-level arrays (the position
    in the moving block, the block's size, the level's base label) are
    accumulated over the ring: each step a visiting block of (level,
    round_key, label, moving) rows answers three ORDER queries per owned
    mover — visiting same-level movers with a smaller (round_key, label)
    key, visiting same-level movers in all, and the visiting non-moving
    label extremes — by sorted-column ``searchsorted`` plus one combined
    lexsort (same-level labels are globally unique, so no key ties
    across ranks). A masked step contributes nothing and is skipped."""
    n_owned = core_new.shape[0]
    dev = core_new.device
    core_new = core_new.to(torch.int32)
    rkey = (torch.zeros(n_owned, dtype=torch.int32, device=dev)
            if round_key is None else round_key.to(torch.int32))
    lvl_sent = torch.full_like(core_new, n_levels)
    zero32 = torch.zeros_like(core_new)
    zero64 = torch.zeros_like(label)
    # moving rows keyed (level, round_key, label); non-moving rows are
    # (n_levels, 0, 0) sentinels that sort past every moving key
    lvl_m = torch.where(moving, core_new, lvl_sent)
    rk_m = torch.where(moving, rkey, zero32)
    lab_m = torch.where(moving, label, zero64)
    # non-moving rows keyed (level, label) for the base-label extremes
    lvl_nm = torch.where(moving, lvl_sent, core_new)
    lab_nm = torch.where(moving, zero64, label)

    # local (t = 0) contributions
    q = _local_ranks(lab_m, rk_m, lvl_m)  # rank among ALL owned rows
    s_lvl_m = torch.sort(lvl_m).values
    below = torch.searchsorted(s_lvl_m, lvl_m, out_int32=True)
    pos = q - below  # rank within my level's movers
    count = torch.searchsorted(s_lvl_m, lvl_m, right=True,
                               out_int32=True) - below

    def _extremes(v_lvl_nm, v_lab_nm):
        """(min, max) non-moving label of each owned vertex's level over
        one ``[n_owned]`` block; sentinels where the level is empty."""
        perm = lexsort((v_lab_nm, v_lvl_nm))
        s_lvl = v_lvl_nm[perm]
        s_lab = v_lab_nm[perm]
        lo = torch.searchsorted(s_lvl, core_new)
        hi = torch.searchsorted(s_lvl, core_new, right=True)
        found = hi > lo
        bmin = torch.where(found, s_lab[lo.clamp(max=n_owned - 1)],
                           torch.full_like(label, _POS))
        bmax = torch.where(found, s_lab[(hi - 1).clamp(0, n_owned - 1)],
                           torch.full_like(label, _NEG))
        return bmin, bmax

    bmin, bmax = _extremes(lvl_nm, lab_nm)

    # ring accumulation over the other ranks' blocks
    pay = (lvl_m, rk_m, lab_m, lvl_nm, lab_nm)
    for t in _ring_steps(n_shards):
        pay = _ring_visiting(pay, axis, n_shards, note=note)
        if t >= n_shards:
            continue  # the one-shard step: masked, no contribution
        v_lvl_m, v_rk_m, v_lab_m, v_lvl_nm, v_lab_nm = pay
        # visiting movers with a key strictly below mine, any level: my
        # combined rank minus my local rank (stability keeps my rows in
        # local order; visiting sentinels sort past every moving key)
        p = _local_ranks(torch.cat([lab_m, v_lab_m]),
                         torch.cat([rk_m, v_rk_m]),
                         torch.cat([lvl_m, v_lvl_m]))[:n_owned]
        s_vlvl = torch.sort(v_lvl_m).values
        v_below = torch.searchsorted(s_vlvl, lvl_m, out_int32=True)
        pos = pos + (p - q) - v_below
        count = count + torch.searchsorted(
            s_vlvl, lvl_m, right=True, out_int32=True) - v_below
        v_bmin, v_bmax = _extremes(v_lvl_nm, v_lab_nm)
        bmin = torch.minimum(bmin, v_bmin)
        bmax = torch.maximum(bmax, v_bmax)

    bmin = torch.where(bmin == _POS, zero64, bmin)
    bmax = torch.where(bmax == _NEG, zero64, bmax)
    if at_head:
        newlab = bmin - LABEL_GAP * (count - pos).long()
    else:
        newlab = bmax + LABEL_GAP * (pos + 1).long()
    return torch.where(moving, newlab, label)


def renumber_ring(core, label, axis, n_shards: int,
                  note=None) -> torch.Tensor:
    """``renumber`` on owned slices: global (core, label)-order ranks by
    the same ring merge-count as ``place_block_ring``, then fresh
    LABEL_GAP-spaced labels."""
    n_owned = core.shape[0]
    q = _local_ranks(label, core)
    rank = q.long()
    pay = (core, label)
    for t in _ring_steps(n_shards):
        pay = _ring_visiting(pay, axis, n_shards, note=note)
        if t >= n_shards:
            continue
        v_core, v_lab = pay
        p = _local_ranks(torch.cat([label, v_lab]),
                         torch.cat([core, v_core]))[:n_owned]
        rank = rank + (p - q).long()
    return rank * LABEL_GAP


def maybe_renumber_ring(core, label, axis, n_shards: int, note=None,
                        force: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``maybe_renumber`` over owned slices: the headroom check completes
    with one all_reduce(MIN) and one all_reduce(MAX) over the owner group
    (the same verdict on every rank, so every rank takes the same
    branch); the relabel itself is the ring renumber. ``force`` (a
    replicated bool) ORs into the verdict, as the weighted engine
    needs. Returns ``(label, did_renumber)``."""
    lim = 1 << 61
    rec = note is not None
    lo = pmin(label.min().reshape(1), axis, "pmin_scalar" if rec else None)
    hi = pmax(label.max().reshape(1), axis, "pmax_scalar" if rec else None)
    need = ((lo < -lim) | (hi > lim))[0]
    if force is not None:
        need = need | force
    if bool(need):
        label = renumber_ring(core, label, axis, n_shards, note=note)
    return label, need
