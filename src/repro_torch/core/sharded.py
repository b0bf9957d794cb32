"""Multi-device core maintenance over ``torch.distributed``.

The port of the reference's ``core/sharded.py``. The edge slots are
sharded across every rank of the mesh: rank ``r`` (on a 2-axis
``(d_e, d_v)`` mesh, ``r = e * d_v + v``) holds slots
``[r * local_cap, (r + 1) * local_cap)`` of the table, at offset 0 of
its own tensors, and every batch is replicated. The vertex state's home
is the layout (core/vertex_layout.py):

* ``vertex_sharding="replicated"`` — every rank keeps the full
  ``[n]`` core and label; each neighborhood statistic is a local
  scatter over the rank's slots completed by one ``all_reduce(SUM)``
  (``engine.batch_program``);
* ``vertex_sharding="range"`` — rank ``r`` OWNS the vertex range
  ``[r * n_owned, (r + 1) * n_owned)`` on the same single axis and keeps
  beyond it only a per-batch halo of the vertices its window and the
  lanes reference (``engine.batch_program_halo``): statistics complete
  by one bounded all_gather and an owner scatter, decisions run on
  owned slices, labels place by the ring ``order.place_block_ring``.
  Bit for bit the replicated engine's cores and k-order (and labels,
  but after a renumber with phantom vertices padding ``n``);
* ``vertex_sharding="halo"`` — the same halo machinery on the 2-axis
  mesh of ``launch.mesh.make_edge_vertex_mesh(mesh_shape=(d_e, d_v))``:
  the vertex ranges shard over the ``"data"`` (owner) axis only and are
  replicated across ``"edge"``, and completed statistics gain one
  all-reduce over the pure-edge group. Per-rank vertex memory is
  O(n / d_v + halo).

Under ``"range"`` and ``"halo"`` ``frontier_exchange="sparse"`` sends
each round's changed owners as compacted ids in a ``frontier_cap``
bucket instead of the dense halo regather, falling back to it in a
round that overflows the cap: a bandwidth knob, bit for bit either way.

The reference runs ``engine.batch_program`` inside a ``shard_map``; the
port is SPMD: every rank calls the function ``make_sharded_apply``
returns with the same batch, and the program runs on the rank's shard
with process groups for the reference's axes. Every loop condition of
the fixpoints reads completed values, so all ranks run the same rounds
and issue the same collectives in the same order; a rank that skipped
one would leave the others waiting.

``make_sharded_remove`` / ``make_sharded_insert_round`` are the
reference's minimal core-only building blocks (no k-order labels), and
``shard_edges`` slices a global slot column into this rank's shard.
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import graph_ops as G
from ..launch.mesh import table_group
from .engine import batch_program, batch_program_halo
from .vertex_layout import (ReplicatedVertices, axis_index, axis_size,
                            make_layout)


def axis_group(mesh, axis: str, vertex_sharding: str = "replicated"):
    """The process group of ``mesh``'s axis ``axis``, with the
    reference's checks of the mesh against the layout: the axis must
    exist, a multi-axis mesh needs ``vertex_sharding="halo"`` and
    ``"halo"`` a multi-axis mesh."""
    names = tuple(mesh.mesh_dim_names or ())
    if axis not in names:
        raise ValueError(
            f"mesh has axes {names}, no vertex/owner axis {axis!r}"
        )
    if len(names) > 1 and vertex_sharding != "halo":
        raise ValueError(
            f"a multi-axis mesh (axes {names}) needs vertex_sharding="
            "'halo' — the replicated and shared-axis range layouts "
            "complete statistics over ONE axis and would silently drop "
            "the pure-edge partials"
        )
    if len(names) < 2 and vertex_sharding == "halo":
        raise ValueError(
            "vertex_sharding='halo' needs a 2-axis (edge x vertex) mesh "
            "— launch.mesh.make_edge_vertex_mesh(mesh_shape=(d_e, d_v)) "
            "or mesh_shape=; a single shared axis is "
            "vertex_sharding='range'"
        )
    return mesh.get_group(axis)


def make_sharded_apply(mesh, n: int, n_levels: int,
                       axis: str = "data",
                       local_active: int | None = None,
                       vertex_sharding: str = "replicated",
                       freelist: str = "interleaved",
                       frontier_exchange: str = "bitmask",
                       frontier_cap: int = 0,
                       kernel_backend: str = "torch",
                       weighted: bool = False):
    """Build this rank's sharded mixed-batch engine over ``mesh``.

    The returned function has ``engine.apply_batch``'s signature minus
    the statics: ``(src, dst, valid, core, label, n_edges, ins_u, ins_v,
    ins_ok, rm_u, rm_v, rm_ok) -> (src, dst, valid, core, label,
    n_edges, stats)``, where ``src``/``dst``/``valid`` are this rank's
    shard of the slot table and everything else is replicated. With
    ``weighted`` the table gains its weight column and the batch its
    lane weights: ``(src, dst, valid, w, core, label, n_edges, ins_u,
    ins_v, ins_w, ins_ok, rm_u, rm_v, rm_ok) -> (src, dst, valid, w,
    core, label, n_edges, stats)``. Every rank calls it with the same
    batch. Under ``vertex_sharding="range"`` / ``"halo"`` ``core`` and
    ``label`` are this rank's OWNED slices ``[n_owned]`` of the state
    padded to ``n_owned * d_v`` (api.py pads and places them), and come
    back so. ``"halo"`` takes the 2-axis mesh
    (``make_edge_vertex_mesh(mesh_shape=(d_e, d_v))``): the table
    collectives run over the table group of every rank
    (``launch.mesh.table_group``), the vertex ones over ``axis`` (the
    owner group), and the statistics gain one all-reduce over the
    pure-edge group.

    ``local_active`` is the per-shard window: every edge pass runs over
    the first ``local_active`` slots of the rank's shard (the host sizes
    it from the pow2 bucket of ``stats.high_water``, the max over shards
    of each shard's high-water mark). The window is a VIEW of the shard
    and ``batch_program`` updates it in place, so nothing is spliced
    back. ``None`` runs the whole shard.

    ``freelist`` picks the slot allocator's ranking (``"interleaved"`` |
    ``"hierarchical"``, ``insert.freelist_alloc``); ``frontier_exchange``
    the halo refreshes under ``"range"`` / ``"halo"`` (``"bitmask"``,
    the reference's name for the dense regather, or ``"sparse"`` with a
    static ``frontier_cap`` >= 1: one engine a cap bucket, as a window);
    ``kernel_backend`` the statistics' implementation (``"torch"`` |
    ``"cuda"``: the hand-written kernels compute the LOCAL partials,
    which the layout completes as it does the torch path's, so the
    collectives are the same).
    """
    group = axis_group(mesh, axis, vertex_sharding)
    if frontier_exchange not in ("bitmask", "sparse"):
        raise ValueError(
            f"unknown frontier_exchange {frontier_exchange!r} "
            "(expected 'bitmask' or 'sparse')"
        )
    if frontier_exchange == "sparse" and vertex_sharding not in (
            "range", "halo"):
        raise ValueError(
            "frontier_exchange='sparse' needs vertex_sharding='range' or "
            "'halo' (the replicated layout exchanges no frontier masks)"
        )
    if frontier_exchange == "sparse" and frontier_cap < 1:
        raise ValueError(
            f"frontier_exchange='sparse' needs frontier_cap >= 1, got "
            f"{frontier_cap}"
        )
    if frontier_exchange != "sparse" and frontier_cap != 0:
        raise ValueError(
            f"frontier_cap={frontier_cap} is only consumed by "
            "frontier_exchange='sparse' — the dense halo exchange would "
            "silently ignore it"
        )
    if vertex_sharding not in ("replicated", "range", "halo"):
        raise ValueError(f"unknown vertex layout {vertex_sharding!r}")
    if freelist not in ("interleaved", "hierarchical"):
        raise ValueError(f"unknown freelist {freelist!r}")
    edge_axes = tuple(mesh.get_group(a) for a in mesh.mesh_dim_names
                      if a != axis)
    # table collectives (found flags, counts, the free-list ranking, the
    # high-water mark) complete over EVERY rank the slots are sharded on
    table_axis = table_group(mesh)
    cap = frontier_cap if frontier_exchange == "sparse" else None

    def _win(shard_len: int) -> int:
        if local_active is None:
            return shard_len
        if local_active > shard_len:
            # a window sized from the GLOBAL slot count would run past
            # the shard: refuse instead of corrupting the table
            raise ValueError(
                f"local_active={local_active} exceeds the per-shard "
                f"capacity {shard_len} — the window must be sized from "
                "the PER-SHARD high-water mark (capacity / n_shards at "
                "most), not the global slot count"
            )
        return local_active

    def _program(*args, **kw):
        """The program body for this layout: the replicated one, or the
        halo one on OWNED core/label (``args[3]``, whose device the
        layout's zeros take)."""
        if vertex_sharding == "replicated":
            return batch_program(*args, axis=group, freelist=freelist,
                                 kernel_backend=kernel_backend, **kw)
        layout = make_layout(vertex_sharding, n, group, axis_size(group),
                             cap, edge_axes, device=args[3].device)
        return batch_program_halo(*args, table_axis=table_axis,
                                  layout=layout, freelist=freelist,
                                  kernel_backend=kernel_backend, **kw)

    def apply(src, dst, valid, core, label, n_edges,
              ins_u, ins_v, ins_ok, rm_u, rm_v, rm_ok):
        w = _win(src.shape[0])
        _, _, _, core, label, n_edges, stats = _program(
            src[:w], dst[:w], valid[:w], core, label, n_edges,
            ins_u, ins_v, ins_ok, rm_u, rm_v, rm_ok, n, n_levels,
        )
        return src, dst, valid, core, label, n_edges, stats

    def apply_weighted(src, dst, valid, ew, core, label, n_edges,
                       ins_u, ins_v, ins_w, ins_ok, rm_u, rm_v, rm_ok):
        w = _win(src.shape[0])
        _, _, _, _, core, label, n_edges, stats = _program(
            src[:w], dst[:w], valid[:w], core, label, n_edges,
            ins_u, ins_v, ins_ok, rm_u, rm_v, rm_ok, n, n_levels,
            w=ew[:w], ins_w=ins_w,
        )
        return src, dst, valid, ew, core, label, n_edges, stats

    return apply_weighted if weighted else apply


def make_sharded_remove(mesh, n: int, axis: str = "data"):
    """This rank's removal fixpoint (core numbers only) over ``mesh``:
    ``fn(src, dst, valid, core) -> core`` with ``src``/``dst``/``valid``
    the rank's shard (removals already tombstoned) and ``core``
    replicated."""
    layout = ReplicatedVertices(n, axis_group(mesh, axis))

    def fn(src, dst, valid, core):
        while True:
            mcd = G.count_ge(src, dst, valid, core, n, layout)
            drop = (mcd < core) & (core > 0)
            core = core - drop.to(torch.int32)
            if not bool(drop.any()):
                return core

    return fn


def make_sharded_insert_round(mesh, n: int, axis: str = "data"):
    """One promotion round (seed -> forward -> evict) on this rank:
    ``fn(src, dst, valid, core, label, seed) -> (new_core, promoted)``.
    The caller loops rounds until nothing is promoted."""
    layout = ReplicatedVertices(n, axis_group(mesh, axis))

    def fn(src, dst, valid, core, label, seed):
        hi = G.count_gt(src, dst, valid, core, n, layout)
        dout_same = G.count_same_level_after(src, dst, valid, core, label,
                                             n, layout)
        reach, passing = seed, (hi + dout_same) > core
        while True:
            rp = reach & passing
            din = G.count_same_level_before_in(src, dst, valid, core, label,
                                               rp, n, layout)
            new_passing = (hi + dout_same + din) > core
            new_reach = reach | G.expand_forward(src, dst, valid, core,
                                                 label, rp, n, layout)
            changed = bool((new_reach != reach).any()
                           | (new_passing != passing).any())
            reach, passing = new_reach, new_passing
            if not changed:
                break

        cand = reach & passing
        while True:
            sup = hi + G.count_same_level_in(src, dst, valid, core, cand, n,
                                             layout)
            new_cand = cand & (sup > core)
            changed = bool((new_cand != cand).any())
            cand = new_cand
            if not changed:
                break
        return core + cand.to(torch.int32), cand

    return fn


def shard_edges(mesh, axis, *arrays) -> Tuple[torch.Tensor, ...]:
    """This rank's shard of each global slot column (length divisible by
    the axis size): the contiguous block ``[r * L, (r + 1) * L)`` of rank
    ``r``, as the reference's ``PartitionSpec(axis)`` places it. A
    clone, so the rank's updates never reach the caller's arrays."""
    group = axis_group(mesh, axis)
    nd, r = axis_size(group), axis_index(group)
    out = []
    for a in arrays:
        if a.shape[0] % nd:
            raise ValueError(
                f"slot column of length {a.shape[0]} does not split over "
                f"{nd} shards"
            )
        lc = a.shape[0] // nd
        out.append(a[r * lc:(r + 1) * lc].clone())
    return tuple(out)
