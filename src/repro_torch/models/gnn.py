"""GNN architectures on PyTorch: PNA, GIN, DimeNet, NequIP.

The port of the reference's ``models/gnn.py``. Message passing is a
gather of sender rows and a scatter into receivers over an edge list
(``index_select`` / ``index_add_`` / ``scatter_reduce_``), as the
reference's is ``jax.ops.segment_sum/max/min``: plain PyTorch on the
card, no hand-written kernel (the reference calls none on this path).

* PNA     — 4 aggregators x 3 degree scalers [arXiv:2004.05718]
* GIN     — sum aggregation, learnable eps [arXiv:1810.00826]
* DimeNet — directional edge messages + triplet angular basis
            [arXiv:2003.03123]; spherical basis reduced to
            Legendre(cos angle) x radial Bessel (the reference's
            simplification)
* NequIP  — E(3)-equivariant l<=2 irrep features with explicit
            tensor-product paths [arXiv:2101.03164]; forces by autograd
            with respect to the positions.

Each model is an ``nn.Module`` (``PNA``, ``GIN``, ``DimeNet``,
``NequIP``) whose attributes mirror the reference's parameter pytree
(an MLP is a ``ModuleList`` of ``Dense`` layers holding ``w`` as
``[in, out]`` and ``b``, so ``x @ w + b`` as in the reference) and whose
``forward`` is the reference's function; the functional names are kept
(``pna_init``, ``pna_forward``, ...). ``*_params_from_reference`` carry
the reference's parameter pytree, as numpy arrays, into a module.
Parameters are built with ``requires_grad=False`` (serving takes no
graph); the training loop (``train/loop.py``) makes them trainable with
``requires_grad_``, and every forward, NequIP's energy included, is then
differentiable with respect to them (``launch/steps.py``'s GNN cells).
``nequip_energy_forces`` differentiates the positions alone.

Sharding. A batch placed as DTensors (``parallel.sharding.place`` by
``launch/steps.py``'s specs: nodes, edges and triplets split over the
flattened mesh, parameters replicated) makes the forwards SPMD; a plain
tensor beside a DTensor is taken as replicated (``implicit_replication``).
``shard_axes`` (the pod cells' pin) selects the reference's explicit
regions, each a ``local_map`` over the flattened axes' one process group
(``DeviceMesh._flatten``: rank ``data * |model| + model`` on the 2-D
mesh, the order DTensor splits one dimension over several mesh
dimensions in): ``_sharded_gather`` all-gathers the table (tiled) and
gathers its rows, ``_sharded_seg_sum`` scatters into a full ``n``-row
buffer and reduce-scatters it, both with the autograd collectives, so
the backward reduce-scatters the gathered table's gradient and
all-gathers the scatter's, as the reference's transposes do; ``_pin``
redistributes the leading dimension over the axes. The other gathers
and segment reductions of a sharded batch (``_rows``, ``_seg_sum``,
``_seg_reduce_clamped``, where the reference leaves the layout to
GSPMD) replicate their inputs and compute whole on every rank; a
gather's table gradient then comes back as a partial sum. With plain
tensors every path is the unsharded one.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from ..parallel.sharding import (P, is_dtensor, redistribute, replicated,
                                 replicated_region)

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# sharded regions
# ---------------------------------------------------------------------------
def _axes_tuple(axes) -> Tuple[str, ...]:
    """``shard_axes`` (a name, or a tuple of names and tuples) flattened."""
    return tuple(a for ax in ((axes,) if isinstance(axes, str) else axes)
                 for a in ((ax,) if isinstance(ax, str) else ax))


def _flat_mesh(mesh, axes):
    """The 1-D mesh over ``axes`` of ``mesh`` flattened (one process
    group: its ranks in the order DTensor splits a dimension over those
    mesh dimensions)."""
    names = _axes_tuple(axes)
    sub = mesh if names == tuple(mesh.mesh_dim_names) else mesh[names]
    return sub if sub.ndim == 1 else sub._flatten()


def _lead(mesh, axes) -> list:
    """Placements splitting dimension 0 over ``axes``."""
    from torch.distributed.tensor import Replicate, Shard

    names = set(_axes_tuple(axes))
    return [Shard(0) if n in names else Replicate()
            for n in mesh.mesh_dim_names]


def _all_replicate(mesh) -> list:
    from torch.distributed.tensor import Replicate

    return [Replicate()] * mesh.ndim


def _mesh_of(*xs):
    return next((x.device_mesh for x in xs if is_dtensor(x)), None)


def _whole(fn, *xs):
    """``fn(*xs)`` computed whole on every rank when one of ``xs`` is a
    DTensor (each replicated first; a replicated result), else as it
    is."""
    mesh = _mesh_of(*xs)
    if mesh is None:
        return fn(*xs)
    from torch.distributed.tensor.experimental import local_map

    rep = _all_replicate(mesh)
    xs = [replicated(x, mesh) for x in xs]
    return local_map(fn, out_placements=rep,
                     in_placements=tuple(rep for _ in xs),
                     device_mesh=mesh, redistribute_inputs=True)(*xs)


def _rows(table: Tensor, idx: Tensor) -> Tensor:
    """``table[idx]`` (rows). Sharded: the table replicated, each rank
    gathering the rows of its own ``idx`` shard (the result split as
    ``idx`` is); the table's gradient is each rank's partial sum."""
    mesh = _mesh_of(table, idx)
    if mesh is None:
        return torch.index_select(table, 0, idx)
    from torch.distributed.tensor import Partial
    from torch.distributed.tensor.experimental import local_map

    table, idx = replicated(table, mesh), replicated(idx, mesh)
    rep = _all_replicate(mesh)
    return local_map(
        lambda t, i: torch.index_select(t, 0, i),
        out_placements=list(idx.placements),
        in_placements=(rep, list(idx.placements)),
        in_grad_placements=([Partial()] * mesh.ndim, list(idx.placements)),
        device_mesh=mesh, redistribute_inputs=True)(table, idx)


def _per_row(fn, n_out: int, *rows, params=()):
    """``fn(*rows, *params)`` computed on each rank's rows: ``rows`` share
    their leading (edge or triplet) dimension, split as the first
    DTensor among them is (the others redistributed to that split), and
    ``fn``'s ``n_out`` outputs are split the same way; ``params``
    (weights) are replicated, their gradients each rank's partial sums.
    A region of local tensors (``local_map``), so DTensor propagates no
    op inside it. On plain tensors, ``fn`` as it is."""
    mesh = _mesh_of(*rows, *params)
    if mesh is None:
        return fn(*rows, *params)
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map

    lead = next(x for x in rows if is_dtensor(x))
    pl = [p if p.is_shard(0) else Replicate() for p in lead.placements]
    grad = [Partial() if p.is_shard(0) else Replicate() for p in pl]
    rep = _all_replicate(mesh)
    ins = [replicated(x, mesh) for x in rows + params]
    out = pl if n_out == 1 else tuple(pl for _ in range(n_out))
    return local_map(fn, out_placements=out,
                     in_placements=(pl,) * len(rows) + (rep,) * len(params),
                     in_grad_placements=(pl,) * len(rows)
                     + (grad,) * len(params),
                     device_mesh=mesh, redistribute_inputs=True)(*ins)


def _autograd_collective(name: str):
    """``_functional_collectives``' autograd ``all_gather`` /
    ``reduce_scatter`` (``*_single_autograd`` where torch has it, else
    ``*_tensor_autograd``)."""
    import torch.distributed._functional_collectives as fc

    return getattr(fc, f"{name}_single_autograd", None) or getattr(
        fc, f"{name}_tensor_autograd")


class _ContiguousGrad(torch.autograd.Function):
    """The identity, whose backward hands on a contiguous gradient (the
    autograd collectives' backward takes only contiguous ones; a slice of
    a ``cat``'s gradient is not)."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return grad.contiguous()


def _check_split(n: int, what: str, flat) -> None:
    if n % flat.size() != 0:
        raise ValueError(f"{what}: {n} rows do not split over the "
                         f"{flat.size()} ranks of the sharded axes (the "
                         "cells pad to multiples of 512)")


def _sharded_gather(vals: Tensor, idx: Tensor, axes) -> Tensor:
    """Row gather from a table split over ``axes``: the table
    all-gathered once (tiled) over the axes' group, then each rank
    gathers the rows of its ``idx`` shard; the backward reduce-scatters
    the table's gradient (the reference's transpose). ``vals[idx]``
    when ``axes`` is None or the tensors are plain."""
    mesh = _mesh_of(vals, idx)
    if axes is None or mesh is None:
        return _rows(vals, idx)
    from torch.distributed.tensor.experimental import local_map

    flat = _flat_mesh(mesh, axes)
    _check_split(vals.shape[0], "_sharded_gather's table", flat)
    _check_split(idx.shape[0], "_sharded_gather's index", flat)
    group, all_gather = flat.get_group(), _autograd_collective("all_gather")

    def f(v, i):
        full = _ContiguousGrad.apply(all_gather(v.contiguous(), 0, group))
        return torch.index_select(full, 0, i)

    pl = _lead(mesh, axes)
    vals, idx = replicated(vals, mesh), replicated(idx, mesh)
    return local_map(f, out_placements=pl, in_placements=(pl, pl),
                     device_mesh=mesh, redistribute_inputs=True)(vals, idx)


def _region(*xs):
    """The context a forward over ``xs`` runs in: ``replicated_region``
    when one is a DTensor (plain tensors beside them replicated), else
    none."""
    if _mesh_of(*xs) is not None:
        return replicated_region()
    return contextlib.nullcontext()


def _pin(x, axes):
    """The leading (edge/node/triplet) dimension of DTensor ``x`` split
    over ``axes`` (the reference's ``with_sharding_constraint``); a
    no-op when ``axes`` is None or ``x`` is plain."""
    if axes is None:
        return x
    return redistribute(x, P(axes, *([None] * (x.dim() - 1))))


# ---------------------------------------------------------------------------
# batch container
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class GraphBatch:
    """Padded graph batch. senders/receivers index nodes; masks mark pads."""

    node_feat: Tensor      # [N, F] float
    senders: Tensor        # [E] int
    receivers: Tensor      # [E] int
    edge_mask: Tensor      # [E] bool
    node_mask: Tensor      # [N] bool
    graph_id: Tensor       # [N] int — node -> graph (batched small graphs)
    n_graphs: int
    positions: Optional[Tensor] = None   # [N, 3] for molecular models
    species: Optional[Tensor] = None     # [N] int atom types

    @classmethod
    def from_numpy(cls, n_graphs: int, **arrays) -> "GraphBatch":
        """A batch of CPU tensors copied from numpy arrays (dtypes kept)."""
        return cls(n_graphs=n_graphs, **{
            k: None if v is None else torch.from_numpy(np.array(v))
            for k, v in arrays.items()})

    @classmethod
    def from_block(cls, block, node_feat, device=None) -> "GraphBatch":
        """A ``graph.sampler.SampledBlock`` as one graph over
        ``node_feat`` ([N_cap, F], a tensor or numpy array) on ``device``
        (``None``: the card)."""
        n_cap = block.node_ids.shape[0]
        feat = torch.as_tensor(node_feat)
        if feat.shape[0] != n_cap:
            raise ValueError(f"node_feat has {feat.shape[0]} rows, the "
                             f"block {n_cap}")
        return cls(
            node_feat=feat, senders=torch.from_numpy(block.senders),
            receivers=torch.from_numpy(block.receivers),
            edge_mask=torch.from_numpy(block.edge_mask),
            node_mask=torch.from_numpy(block.node_mask),
            graph_id=torch.zeros(n_cap, dtype=torch.int32), n_graphs=1,
        ).to(device)

    def to(self, device=None) -> "GraphBatch":
        """The batch on ``device`` (``None``: the card; raises without
        one), its index columns as the int64 that torch's index ops
        take."""
        dev = resolve_device(device)
        out = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, Tensor):
                if f.name in ("senders", "receivers", "graph_id", "species"):
                    v = v.to(device=dev, dtype=torch.int64)
                else:
                    v = v.to(dev)
            out[f.name] = v
        return GraphBatch(**out)


def _seg_sum(x: Tensor, ids: Tensor, n: int) -> Tensor:
    if _mesh_of(x, ids) is not None:
        return _whole(lambda a, i: _seg_sum(a, i, n), x, ids)
    return x.new_zeros((n,) + tuple(x.shape[1:])).index_add_(0, ids, x)


def _sharded_seg_sum(x: Tensor, ids: Tensor, n: int, axes) -> Tensor:
    """``segment_sum`` with its output split over ``axes``: each rank
    scatters its ``x`` / ``ids`` shard into a full ``n``-row buffer,
    then one reduce-scatter over the axes' group (the backward
    all-gathers). Needs ``n`` divisible by the group's size (the cells
    pad to 512). ``_seg_sum`` when ``axes`` is None or the tensors are
    plain."""
    mesh = _mesh_of(x, ids)
    if axes is None or mesh is None:
        return _seg_sum(x, ids, n)
    from torch.distributed.tensor.experimental import local_map

    flat = _flat_mesh(mesh, axes)
    _check_split(n, "_sharded_seg_sum's output", flat)
    group = flat.get_group()
    reduce_scatter = _autograd_collective("reduce_scatter")

    def f(xs, is_):
        buf = xs.new_zeros((n,) + tuple(xs.shape[1:])).index_add_(0, is_,
                                                                   xs)
        return _ContiguousGrad.apply(reduce_scatter(buf, "sum", 0, group))

    pl = _lead(mesh, axes)
    x, ids = replicated(x, mesh), replicated(ids, mesh)
    return local_map(f, out_placements=pl, in_placements=(pl, pl),
                     device_mesh=mesh, redistribute_inputs=True)(x, ids)


def _seg_reduce_clamped(x: Tensor, ids: Tensor, n: int, fill: float,
                        reduce: str) -> Tensor:
    """``max(segment_max(x), fill)`` (``reduce="amax"``) or
    ``min(segment_min(x), fill)`` (``"amin"``): an empty segment gives
    ``fill``. A scatter over the ids broadcast along the feature axes (a
    view), which the card runs in half the time of ``index_reduce_``."""
    if _mesh_of(x, ids) is not None:
        return _whole(lambda a, i: _seg_reduce_clamped(a, i, n, fill,
                                                       reduce), x, ids)
    out = x.new_full((n,) + tuple(x.shape[1:]), fill)
    idx = ids.view((-1,) + (1,) * (x.dim() - 1)).expand_as(x)
    return out.scatter_reduce_(0, idx, x, reduce, include_self=True)


class Dense(nn.Module):
    """One MLP layer in the reference's layout: ``x @ w + b``."""

    def __init__(self, a: int, b: int, device):
        super().__init__()
        self.w = nn.Parameter(torch.empty(a, b, device=device),
                              requires_grad=False)
        self.b = nn.Parameter(torch.zeros(b, device=device),
                              requires_grad=False)


def _mlp(sizes: Sequence[int], device) -> nn.ModuleList:
    return nn.ModuleList(Dense(a, b, device)
                         for a, b in zip(sizes[:-1], sizes[1:]))


def _mlp_apply(params, x: Tensor, act=F.silu, final_act: bool = False,
               dtype: Optional[torch.dtype] = None) -> Tensor:
    """``params`` a sequence of ``Dense``; ``dtype`` casts each weight
    (the reference's block cast under ``msg_dtype``)."""
    last = len(params) - 1
    for i, lyr in enumerate(params):
        w, b = lyr.w, lyr.b
        if dtype is not None:
            w, b = w.to(dtype), b.to(dtype)
        x = x @ w + b
        if i < last or final_act:
            x = act(x)
    return x


def _param(shape, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, device=device),
                        requires_grad=False)


# ---------------------------------------------------------------------------
# init and carry-over, shared
# ---------------------------------------------------------------------------
def _generator(generator: Optional[torch.Generator]) -> torch.Generator:
    return torch.Generator().manual_seed(0) if generator is None else generator


def _normal_(p: Tensor, gen: torch.Generator, div: float) -> None:
    """``p`` <- standard normal / ``div``, drawn on the generator's device
    (so the numbers depend on the generator alone)."""
    draw = torch.empty(p.shape, dtype=torch.float32, device=gen.device)
    p.copy_(draw.normal_(generator=gen).div_(div))


def _init_mlp(mlp: nn.ModuleList, gen: torch.Generator) -> None:
    """The reference's ``_mlp_init`` law: w ~ N(0, 1) / sqrt(in), b = 0."""
    for lyr in mlp:
        _normal_(lyr.w, gen, math.sqrt(lyr.w.shape[0]))
        lyr.b.zero_()


def _load_tree(node, tree, where: str = "params") -> int:
    """Copy the reference's pytree ``tree`` (dicts, lists, arrays) into the
    module tree ``node`` by the same names; returns the leaves copied."""
    if isinstance(tree, Mapping):
        return sum(_load_tree(getattr(node, k), v, f"{where}.{k}")
                   for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        if len(tree) != len(node):
            raise ValueError(f"{where}: {len(tree)} entries, the config "
                             f"gives {len(node)}")
        return sum(_load_tree(m, v, f"{where}[{i}]")
                   for i, (m, v) in enumerate(zip(node, tree)))
    src = torch.from_numpy(np.array(tree, dtype=np.float32))
    if tuple(src.shape) != tuple(node.shape):
        raise ValueError(f"{where}: shape {tuple(src.shape)} != "
                         f"{tuple(node.shape)}")
    node.copy_(src)
    return 1


def _from_reference(model: nn.Module, params: Mapping[str, Any]):
    n = _load_tree(model, params)
    want = len(list(model.parameters()))
    if n != want:
        raise ValueError(f"the pytree holds {n} arrays, the module {want}")
    return model


# ---------------------------------------------------------------------------
# PNA
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class PNAConfig:
    name: str = "pna"
    n_layers: int = 4
    d_hidden: int = 75
    d_in: int = 1433
    n_classes: int = 7
    delta: float = 2.5  # mean log-degree normalizer (dataset statistic)
    shard_axes: Any = None



class _PNALayer(nn.Module):
    def __init__(self, d_in: int, d: int, device):
        super().__init__()
        self.pre = _mlp([d_in, d], device)
        # 4 aggregators x 3 scalers + self
        self.post = _mlp([12 * d + d_in, d, d], device)


class PNA(nn.Module):
    """PNA parameters; ``forward(batch)`` is ``pna_forward`` (node
    logits). Left uninitialised: build one with ``pna_init`` or
    ``pna_params_from_reference``. ``device`` ``None`` means the card."""

    def __init__(self, cfg: PNAConfig, device=None):
        super().__init__()
        self.cfg = cfg
        dev = resolve_device(device)
        self.layers = nn.ModuleList(
            _PNALayer(cfg.d_in if i == 0 else cfg.d_hidden, cfg.d_hidden,
                      dev) for i in range(cfg.n_layers))
        self.readout = _mlp([cfg.d_hidden, cfg.n_classes], dev)

    def forward(self, batch: GraphBatch) -> Tensor:
        return pna_forward(self.cfg, self, batch)


def pna_init(cfg: PNAConfig, generator: Optional[torch.Generator] = None,
             device=None) -> PNA:
    model = PNA(cfg, device)
    gen = _generator(generator)
    for lyr in model.layers:
        _init_mlp(lyr.pre, gen)
        _init_mlp(lyr.post, gen)
    _init_mlp(model.readout, gen)
    return model


def pna_params_from_reference(params: Mapping[str, Any], cfg: PNAConfig,
                              device=None) -> PNA:
    return _from_reference(PNA(cfg, device), params)


def _refill(x: Tensor, dead: Tensor, value: float) -> Tensor:
    """``x`` with the ``dead`` rows set to ``value``: in place, unless a
    graph is being recorded (the backward of ``msg * msg`` and of the
    max scatter reads the messages as they were)."""
    if x.requires_grad:
        return x.masked_fill(dead, value)
    return x.masked_fill_(dead, value)


def _pna_layer(lyr, h: Tensor, batch: GraphBatch, deg: Tensor,
               scalers: Tuple[Tensor, Tensor], axes=None) -> Tensor:
    """One PNA layer. Serving holds at most two ``[E, d_hidden]``
    tensors live at once (the masked messages, overwritten in place by
    their max and min fills, and ``msg * msg``), and none of the layer's
    ``[N, ...]`` temporaries outlives it; under autograd the fills are
    copies."""
    n = h.shape[0]
    recv = batch.receivers
    dead = ~batch.edge_mask[:, None]
    msg = _sharded_gather(_mlp_apply(lyr.pre, h), batch.senders, axes)
    msg.masked_fill_(dead, 0.0)
    mean = _sharded_seg_sum(msg, recv, n, axes) / deg[:, None]
    sq = _sharded_seg_sum(msg * msg, recv, n, axes) / deg[:, None]
    mx = _seg_reduce_clamped(_refill(msg, dead, -1e30), recv, n, -1e30,
                             "amax")
    mn = _seg_reduce_clamped(_refill(msg, dead, 1e30), recv, n, 1e30,
                             "amin")
    del msg
    live = deg[:, None] > 1e-5
    mx = torch.where(live, mx, 0.0)
    mn = torch.where(live, mn, 0.0)
    std = torch.sqrt(torch.clamp(sq - mean * mean, min=0.0) + 1e-6)
    aggs = torch.cat([mean, mx, mn, std], dim=-1)  # [N, 4D]
    del mean, mx, mn, std, sq
    amp, att = scalers
    x = torch.cat([h, aggs, aggs * amp, aggs * att], dim=-1)
    del aggs
    return _mlp_apply(lyr.post, x) * batch.node_mask[:, None]


def pna_forward(cfg: PNAConfig, params, batch: GraphBatch) -> Tensor:
    """Node logits ``[N, n_classes]``."""
    with _region(batch.node_feat):
        n = batch.node_feat.shape[0]
        deg = _seg_sum(batch.edge_mask.to(torch.float32), batch.receivers,
                       n) + 1e-6
        log_deg = torch.log(deg + 1.0)
        amp = (log_deg / cfg.delta)[:, None]
        att = (cfg.delta / torch.clamp(log_deg, min=1e-6))[:, None]
        h = batch.node_feat
        for lyr in params.layers:
            h = _pna_layer(lyr, h, batch, deg, (amp, att), cfg.shard_axes)
        return _mlp_apply(params.readout, h)  # node logits


def pna_conditioned_rows(batch: GraphBatch, n_layers: int) -> Tensor:
    """``[N]`` bool: the rows of ``pna_forward``'s logits that float32
    computes to within rounding, those that no node of live in-degree
    below 2 reaches within ``n_layers - 1`` live hops (the row's own node
    included). At in-degree 1 the std aggregate subtracts two equal
    terms, and at 0 the attenuation scaler is 2.5e6, so one rounding
    difference in a message moves such a node's state, and every state
    it feeds, by up to 1e-3 of its scale."""
    n = batch.node_feat.shape[0]
    snd, rcv, live = batch.senders, batch.receivers, batch.edge_mask
    bad = _seg_sum(live.to(torch.float32), rcv, n) < 2
    for _ in range(n_layers - 1):
        fed = _seg_sum((bad[snd] & live).to(torch.float32), rcv, n)
        bad = bad | (fed > 0)
    return ~bad


# ---------------------------------------------------------------------------
# GIN
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class GINConfig:
    name: str = "gin-tu"
    n_layers: int = 5
    d_hidden: int = 64
    d_in: int = 8
    n_classes: int = 2
    shard_axes: Any = None



class _GINLayer(nn.Module):
    def __init__(self, d_in: int, d: int, device):
        super().__init__()
        self.mlp = _mlp([d_in, d, d], device)
        self.eps = nn.Parameter(torch.zeros((), device=device),
                                requires_grad=False)


class GIN(nn.Module):
    """GIN parameters; ``forward(batch)`` is ``gin_forward`` (graph
    logits ``[G, n_classes]``). ``device`` ``None`` means the card."""

    def __init__(self, cfg: GINConfig, device=None):
        super().__init__()
        self.cfg = cfg
        dev = resolve_device(device)
        self.layers = nn.ModuleList(
            _GINLayer(cfg.d_in if i == 0 else cfg.d_hidden, cfg.d_hidden,
                      dev) for i in range(cfg.n_layers))
        self.readout = _mlp([cfg.n_layers * cfg.d_hidden, cfg.d_hidden,
                             cfg.n_classes], dev)

    def forward(self, batch: GraphBatch) -> Tensor:
        return gin_forward(self.cfg, self, batch)


def gin_init(cfg: GINConfig, generator: Optional[torch.Generator] = None,
             device=None) -> GIN:
    model = GIN(cfg, device)
    gen = _generator(generator)
    for lyr in model.layers:
        _init_mlp(lyr.mlp, gen)
        lyr.eps.zero_()
    _init_mlp(model.readout, gen)
    return model


def gin_params_from_reference(params: Mapping[str, Any], cfg: GINConfig,
                              device=None) -> GIN:
    return _from_reference(GIN(cfg, device), params)


def gin_forward(cfg: GINConfig, params, batch: GraphBatch) -> Tensor:
    with _region(batch.node_feat):
        n = batch.node_feat.shape[0]
        h = batch.node_feat
        dead = ~batch.edge_mask[:, None]
        axes = cfg.shard_axes
        pooled = []
        for lyr in params.layers:
            msg = _sharded_gather(h, batch.senders, axes).masked_fill_(
                dead, 0.0)
            agg = _sharded_seg_sum(msg, batch.receivers, n, axes)
            del msg
            h = _mlp_apply(lyr.mlp, (1.0 + lyr.eps) * h + agg,
                           final_act=True)
            h = h * batch.node_mask[:, None]
            # graph sum-pool per layer (GIN readout)
            pooled.append(_seg_sum(h, batch.graph_id, batch.n_graphs))
        z = torch.cat(pooled, dim=-1)
        return _mlp_apply(params.readout, z)  # [G, n_classes]


# ---------------------------------------------------------------------------
# DimeNet (directional message passing)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class DimeNetConfig:
    name: str = "dimenet"
    n_blocks: int = 6
    d_hidden: int = 128
    n_bilinear: int = 8
    n_spherical: int = 7
    n_radial: int = 6
    cutoff: float = 5.0
    n_species: int = 16
    shard_axes: Any = None
    msg_dtype: Any = torch.float32  # bfloat16: blocks computed in bf16



def _bessel_basis(d: Tensor, n_radial: int, cutoff: float) -> Tensor:
    """Radial Bessel basis [*, n_radial]."""
    d = torch.clamp(d, min=1e-6)
    n = torch.arange(1, n_radial + 1, dtype=torch.float32, device=d.device)
    return (math.sqrt(2.0 / cutoff)
            * torch.sin(n * math.pi * d[..., None] / cutoff) / d[..., None])


def _legendre_cos(cos_a: Tensor, n: int) -> Tensor:
    """First n Legendre polynomials of cos(angle) — the angular factor of
    the spherical basis (the reference's simplification)."""
    outs = [torch.ones_like(cos_a), cos_a]
    for l in range(2, n):
        outs.append(((2 * l - 1) * cos_a * outs[-1]
                     - (l - 1) * outs[-2]) / l)
    return torch.stack(outs[:n], dim=-1)


class _DimeNetBlock(nn.Module):
    def __init__(self, cfg: DimeNetConfig, device):
        super().__init__()
        d = cfg.d_hidden
        self.w_rbf = _mlp([cfg.n_radial, d], device)
        self.w_sbf = _mlp([cfg.n_spherical * cfg.n_radial, cfg.n_bilinear],
                          device)
        self.bilinear = _param((cfg.n_bilinear, d, d), device)
        self.msg_mlp = _mlp([d, d, d], device)
        self.upd_mlp = _mlp([2 * d, d, d], device)


class DimeNet(nn.Module):
    """DimeNet parameters; ``forward(batch, triplet_kj, triplet_ji,
    triplet_mask)`` is ``dimenet_forward`` (per-graph energy ``[G]``).
    ``device`` ``None`` means the card."""

    def __init__(self, cfg: DimeNetConfig, device=None):
        super().__init__()
        self.cfg = cfg
        dev = resolve_device(device)
        d = cfg.d_hidden
        self.species_embed = _param((cfg.n_species, d), dev)
        self.rbf_embed = _mlp([cfg.n_radial, d], dev)
        self.msg_embed = _mlp([3 * d, d], dev)
        self.blocks = nn.ModuleList(_DimeNetBlock(cfg, dev)
                                    for _ in range(cfg.n_blocks))
        self.out = _mlp([d, d, 1], dev)

    def forward(self, batch: GraphBatch, triplet_kj: Tensor,
                triplet_ji: Tensor, triplet_mask: Tensor) -> Tensor:
        return dimenet_forward(self.cfg, self, batch, triplet_kj,
                               triplet_ji, triplet_mask)


def dimenet_init(cfg: DimeNetConfig,
                 generator: Optional[torch.Generator] = None,
                 device=None) -> DimeNet:
    model = DimeNet(cfg, device)
    gen = _generator(generator)
    d = cfg.d_hidden
    _normal_(model.species_embed, gen, math.sqrt(d))
    _init_mlp(model.rbf_embed, gen)
    _init_mlp(model.msg_embed, gen)
    for blk in model.blocks:
        _init_mlp(blk.w_rbf, gen)
        _init_mlp(blk.w_sbf, gen)
        _normal_(blk.bilinear, gen, d)
        _init_mlp(blk.msg_mlp, gen)
        _init_mlp(blk.upd_mlp, gen)
    _init_mlp(model.out, gen)
    return model


def dimenet_params_from_reference(params: Mapping[str, Any],
                                  cfg: DimeNetConfig,
                                  device=None) -> DimeNet:
    return _from_reference(DimeNet(cfg, device), params)


def dimenet_forward(
    cfg: DimeNetConfig,
    params,
    batch: GraphBatch,
    triplet_kj: Tensor,    # [T] edge ids (k->j)
    triplet_ji: Tensor,    # [T] edge ids (j->i)
    triplet_mask: Tensor,  # [T] bool
) -> Tensor:
    """Returns per-graph energy [G]."""
    with _region(batch.positions, triplet_kj):
        return _dimenet_forward(cfg, params, batch, triplet_kj, triplet_ji,
                                triplet_mask)


def _dimenet_forward(cfg, params, batch, triplet_kj, triplet_ji,
                     triplet_mask):
    dt = cfg.msg_dtype
    cast = None if dt == torch.float32 else dt
    axes = cfg.shard_axes
    emask = batch.edge_mask[:, None]
    pos = batch.positions
    sp = _rows(params.species_embed, batch.species)
    vec = _rows(pos, batch.senders) - _rows(pos, batch.receivers)
    dist = torch.linalg.norm(vec + 1e-12, dim=-1)
    rbf = _bessel_basis(dist, cfg.n_radial, cfg.cutoff)  # [E, R]
    # initial edge message from endpoint species + rbf
    m = _mlp_apply(
        params.msg_embed,
        torch.cat([_rows(sp, batch.senders), _rows(sp, batch.receivers),
                   _mlp_apply(params.rbf_embed, rbf)], dim=-1),
        final_act=True,
    )
    m = _pin((m * emask).to(dt), axes)
    n_edges = m.shape[0]

    # triplet angles: edge kj = (k->j), edge ji = (j->i): angle at j
    def spherical(v1, v2, d_kj):
        cos_a = torch.sum(v1 * v2, dim=-1) / (
            torch.linalg.norm(v1 + 1e-12, dim=-1)
            * torch.linalg.norm(v2 + 1e-12, dim=-1)
            + 1e-9
        )
        ang = _legendre_cos(torch.clamp(cos_a, -1.0, 1.0), cfg.n_spherical)
        return (ang[:, :, None] * _bessel_basis(
            d_kj, cfg.n_radial, cfg.cutoff)[:, None, :]
        ).reshape(ang.shape[0], -1).to(dt)  # [T, S*R]

    sbf = _pin(_per_row(spherical, 1,
                        -_rows(vec, triplet_kj),  # j->k
                        _rows(vec, triplet_ji),   # j->i (pos_j - pos_i)
                        _rows(dist, triplet_kj)), axes)
    tmask = triplet_mask[:, None]

    for blk in params.blocks:
        # under msg_dtype the whole block runs in it (every weight cast)
        bil = blk.bilinear if cast is None else blk.bilinear.to(cast)
        g_rbf = _mlp_apply(blk.w_rbf, rbf.to(dt), dtype=cast)  # [E, D]
        g_sbf = _pin(_mlp_apply(blk.w_sbf, sbf, dtype=cast), axes)  # [T, B]
        m_kj = _sharded_gather(
            _mlp_apply(blk.msg_mlp, m, final_act=True, dtype=cast),
            triplet_kj, axes)
        # bilinear: combine angular basis with incoming messages
        inter = _per_row(lambda g, mk, b: torch.einsum("tb,bdf,td->tf", g,
                                                       b, mk),
                         1, g_sbf, m_kj, params=(bil,))
        inter = _pin(inter * tmask, axes)
        agg = _sharded_seg_sum(inter.to(dt), triplet_ji, n_edges, axes)
        upd = _mlp_apply(blk.upd_mlp,
                         torch.cat([m * g_rbf, agg], dim=-1).to(dt),
                         final_act=True, dtype=cast)
        m = m + upd.to(dt)
        m = _pin(m * emask, axes)

    n = batch.node_feat.shape[0]
    atom = _sharded_seg_sum(m.to(torch.float32), batch.receivers, n,
                            axes)  # edge->atom
    e_atom = _mlp_apply(params.out, atom)[:, 0] * batch.node_mask
    return _seg_sum(e_atom, batch.graph_id, batch.n_graphs)


def build_triplets(
    senders, receivers, edge_mask, max_triplets: int
) -> Tuple[Any, Any, Any]:
    """Host-side triplet construction: pairs (edge k->j, edge j->i), k != i.

    A numpy copy of the reference's: the same inputs give the same
    ``(kj, ji, mask)`` arrays (int32, int32, bool)."""
    senders = np.asarray(senders)
    receivers = np.asarray(receivers)
    mask = np.asarray(edge_mask)
    by_receiver: Dict[int, list] = {}
    for e, (s, r) in enumerate(zip(senders, receivers)):
        if mask[e]:
            by_receiver.setdefault(int(r), []).append(e)
    kj, ji = [], []
    for e_ji, (j, i) in enumerate(zip(senders, receivers)):
        if not mask[e_ji]:
            continue
        for e_kj in by_receiver.get(int(j), []):
            if senders[e_kj] != i:  # k != i
                kj.append(e_kj)
                ji.append(e_ji)
    t = len(kj)
    if t > max_triplets:
        kj, ji, t = kj[:max_triplets], ji[:max_triplets], max_triplets
    out_kj = np.zeros(max_triplets, dtype=np.int32)
    out_ji = np.zeros(max_triplets, dtype=np.int32)
    out_m = np.zeros(max_triplets, dtype=bool)
    out_kj[:t] = kj
    out_ji[:t] = ji
    out_m[:t] = True
    return out_kj, out_ji, out_m


def triplet_tensors(triplets, device=None) -> Tuple[Tensor, Tensor, Tensor]:
    """``build_triplets``' arrays on ``device`` (``None``: the card), the
    edge ids as int64."""
    dev = resolve_device(device)
    kj, ji, m = triplets
    return (torch.from_numpy(np.asarray(kj)).to(dev, torch.int64),
            torch.from_numpy(np.asarray(ji)).to(dev, torch.int64),
            torch.from_numpy(np.asarray(m)).to(dev))


# ---------------------------------------------------------------------------
# NequIP (E(3)-equivariant, l <= 2)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class NequIPConfig:
    name: str = "nequip"
    n_layers: int = 5
    d_hidden: int = 32
    l_max: int = 2
    n_rbf: int = 8
    cutoff: float = 5.0
    n_species: int = 16
    shard_axes: Any = None



_SQRT3 = math.sqrt(3.0)


def _sph_harmonics(unit: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """Real spherical harmonics l=0,1,2 of unit vectors [*, 3]."""
    x, y, z = unit[..., 0], unit[..., 1], unit[..., 2]
    y0 = torch.ones_like(x)[..., None]  # [*, 1]
    y1 = unit  # [*, 3]
    y2 = torch.stack(
        [
            _SQRT3 * x * y,
            _SQRT3 * y * z,
            0.5 * (2 * z * z - x * x - y * y),
            _SQRT3 * x * z,
            _SQRT3 / 2.0 * (x * x - y * y),
        ],
        dim=-1,
    )  # [*, 5]
    return y0, y1, y2


def _vec5_to_mat(v5: Tensor) -> Tensor:
    """Inverse map of the l=2 component basis to symmetric traceless 3x3."""
    a = v5[..., 0] / _SQRT3
    b = v5[..., 1] / _SQRT3
    c = v5[..., 2]
    d = v5[..., 3] / _SQRT3
    e = v5[..., 4] * 2.0 / _SQRT3
    xx = (e - c / 1.5) / 2.0
    yy = (-e - c / 1.5) / 2.0
    # xx + yy + zz = 0 and c = 0.5 (2 zz - xx - yy) = 1.5 zz
    zz = c / 1.5
    return torch.stack(
        [
            torch.stack([xx, a, d], dim=-1),
            torch.stack([a, yy, b], dim=-1),
            torch.stack([d, b, zz], dim=-1),
        ],
        dim=-2,
    )


def _mat_to_vec5(m: Tensor) -> Tensor:
    return torch.stack(
        [
            _SQRT3 * m[..., 0, 1],
            _SQRT3 * m[..., 1, 2],
            1.5 * m[..., 2, 2],
            _SQRT3 * m[..., 0, 2],
            _SQRT3 / 2.0 * (m[..., 0, 0] - m[..., 1, 1]),
        ],
        dim=-1,
    )


_N_PATHS = 11  # tensor-product paths of nequip_energy


def _tensor_products(w, s0, s1, s2, y1, y2):
    """NequIP's messages an edge: the 11 tensor-product paths (sender
    feature x edge harmonic -> receiver l), weighted by ``w`` ``[E, 11,
    C]`` and summed by output order: ``(l=0 [E, C], l=1 [E, C, 3], l=2
    [E, C, 5])``."""
    eye = torch.eye(3, dtype=s1.dtype, device=s1.device)
    y1e = y1[:, None, :]                                         # [E,1,3]
    p0 = w[:, 0] * s0                                            # 0x0->0
    p1 = (w[:, 1] * s0)[..., None] * y1e                         # 0x1->1
    p2 = w[:, 2, :, None] * s0[..., None] * y2[:, None, :]       # 0x2->2
    p3 = w[:, 3, :, None] * s1                                   # 1x0->1
    p4 = w[:, 4] * torch.einsum("ecd,ed->ec", s1, y1)            # 1x1->0
    p5 = w[:, 5, :, None] * torch.linalg.cross(
        s1, y1e.expand_as(s1), dim=-1)                           # 1x1->1
    outer = (s1[..., :, None] * y1[:, None, None, :]
             + s1[..., None, :] * y1[:, None, :, None]) * 0.5
    tr = (outer[..., 0, 0] + outer[..., 1, 1] + outer[..., 2, 2]) / 3.0
    outer = outer - tr[..., None, None] * eye
    p6 = w[:, 6, :, None] * _mat_to_vec5(outer)                  # 1x1->2
    m2 = _vec5_to_mat(s2)
    p7 = w[:, 7, :, None] * torch.einsum("ecij,ej->eci", m2, y1)  # 2x1->1
    p8 = w[:, 8, :, None] * s2                                   # 2x0->2
    y2b = _vec5_to_mat(y2)[:, None].expand_as(m2)
    p9 = w[:, 9] * torch.einsum("ecij,ecij->ec", m2, y2b)        # 2x2->0
    p10 = w[:, 10, :, None] * _mat_to_vec5(
        torch.matmul(m2, y2b) + torch.matmul(y2b, m2)) * 0.5     # 2x2->2*
    return (p0 + p4 + p9, p1 + p3 + p5 + p7, p2 + p6 + p8 + p10)


class _NequIPLayer(nn.Module):
    def __init__(self, cfg: NequIPConfig, device):
        super().__init__()
        c = cfg.d_hidden
        self.radial = _mlp([cfg.n_rbf, c, _N_PATHS * c], device)
        self.self0 = _param((c, c), device)
        self.self1 = _param((c, c), device)
        self.self2 = _param((c, c), device)
        self.gate = _mlp([c, 2 * c], device)


class NequIP(nn.Module):
    """NequIP parameters; ``forward(batch)`` is ``nequip_energy``
    (per-graph energy ``[G]`` at ``batch.positions``),
    ``energy_forces(batch)`` is ``nequip_energy_forces``.
    ``device`` ``None`` means the card."""

    def __init__(self, cfg: NequIPConfig, device=None):
        super().__init__()
        self.cfg = cfg
        dev = resolve_device(device)
        c = cfg.d_hidden
        self.species_embed = _param((cfg.n_species, c), dev)
        self.layers = nn.ModuleList(_NequIPLayer(cfg, dev)
                                    for _ in range(cfg.n_layers))
        self.out = _mlp([c, c, 1], dev)

    def forward(self, batch: GraphBatch) -> Tensor:
        return nequip_energy(self.cfg, self, batch.positions, batch)

    def energy_forces(self, batch: GraphBatch) -> Tuple[Tensor, Tensor]:
        return nequip_energy_forces(self.cfg, self, batch)


def nequip_init(cfg: NequIPConfig,
                generator: Optional[torch.Generator] = None,
                device=None) -> NequIP:
    model = NequIP(cfg, device)
    gen = _generator(generator)
    c = cfg.d_hidden
    _normal_(model.species_embed, gen, math.sqrt(c))
    for lyr in model.layers:
        _init_mlp(lyr.radial, gen)
        for w in (lyr.self0, lyr.self1, lyr.self2):
            _normal_(w, gen, math.sqrt(c))
        _init_mlp(lyr.gate, gen)
    _init_mlp(model.out, gen)
    return model


def nequip_params_from_reference(params: Mapping[str, Any],
                                 cfg: NequIPConfig, device=None) -> NequIP:
    return _from_reference(NequIP(cfg, device), params)


def nequip_energy(cfg: NequIPConfig, params, positions: Tensor,
                  batch: GraphBatch) -> Tensor:
    """Per-graph energy. ``positions`` is separated out for the forces."""
    with _region(positions, batch.senders):
        return _nequip_energy(cfg, params, positions, batch)


def _nequip_energy(cfg, params, positions, batch):
    n = batch.node_feat.shape[0]
    c = cfg.d_hidden
    axes = cfg.shard_axes
    snd, rcv = batch.senders, batch.receivers
    h0 = _rows(params.species_embed, batch.species)  # [N, C] scalars
    zeros = lambda *shape: torch.zeros(  # noqa: E731
        shape, dtype=positions.dtype, device=positions.device)
    h1, h2 = zeros(n, c, 3), zeros(n, c, 5)
    if is_dtensor(positions):
        h1 = replicated(h1, positions.device_mesh)
        h2 = replicated(h2, positions.device_mesh)

    def geometry(vec, edge_mask):
        dist = torch.linalg.norm(vec + 1e-9, dim=-1)
        unit = vec / (dist[..., None] + 1e-9)
        _, y1, y2 = _sph_harmonics(unit)
        rbf = _bessel_basis(dist, cfg.n_rbf, cfg.cutoff)  # [E, R]
        # smooth cutoff envelope
        env = torch.where(dist < cfg.cutoff,
                          0.5 * (torch.cos(math.pi * dist / cfg.cutoff)
                                 + 1.0), 0.0)
        return y1, y2, rbf, edge_mask * env

    y1, y2, rbf, emask = _per_row(
        geometry, 4, _rows(positions, snd) - _rows(positions, rcv),
        batch.edge_mask)

    for lyr in params.layers:
        w = _mlp_apply(lyr.radial, rbf)  # [E, 11C]
        w = (w * emask[:, None]).reshape(-1, _N_PATHS, c)
        s0, s1, s2 = (_sharded_gather(h, snd, axes) for h in (h0, h1, h2))
        msg0, msg1, msg2 = _per_row(_tensor_products, 3, w, s0, s1, s2, y1,
                                    y2)
        a0 = _sharded_seg_sum(msg0, rcv, n, axes)
        a1 = _sharded_seg_sum(msg1, rcv, n, axes)
        a2 = _sharded_seg_sum(msg2, rcv, n, axes)
        # self interaction + gated nonlinearity
        h0n = h0 @ lyr.self0 + a0
        h1n = torch.einsum("ncd,ce->ned", h1 + a1, lyr.self1)
        h2n = torch.einsum("ncd,ce->ned", h2 + a2, lyr.self2)
        gates = _mlp_apply(lyr.gate, h0n)
        g1 = torch.sigmoid(gates[..., :c])[..., None]
        g2 = torch.sigmoid(gates[..., c:])[..., None]
        h0 = F.silu(h0n)
        h1 = h1n * g1
        h2 = h2n * g2

    e_atom = _mlp_apply(params.out, h0)[:, 0] * batch.node_mask
    return _seg_sum(e_atom, batch.graph_id, batch.n_graphs)


def nequip_energy_forces(cfg: NequIPConfig, params, batch: GraphBatch
                         ) -> Tuple[Tensor, Tensor]:
    """Per-graph energy [G] and forces [N, 3] = -dE/dpositions, from one
    forward and one backward with respect to the positions alone."""
    with torch.enable_grad():
        pos = batch.positions.detach().requires_grad_(True)
        energy = nequip_energy(cfg, params, pos, batch)
        (grad,) = torch.autograd.grad(energy.sum(), pos)
    return energy.detach(), -grad

