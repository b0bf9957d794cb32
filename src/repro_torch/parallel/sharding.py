"""Sharding rules: parameter and activation specs per architecture family.

The port of the reference's ``parallel/sharding.py``. A spec is a ``P``:
one entry per tensor dimension, each ``None`` (replicated), a mesh axis
name or a tuple of names (the dimension split over those axes, the
first the major one). ``to_placements`` turns a spec into the
per-mesh-dimension placements of a DTensor (``Shard(d)`` or
``Replicate()``), and ``shard_params`` places a model's parameters by
their specs as ``distribute_tensor`` parameters.

Logical layout (mesh axes: optional "pod", "data", "model"):
  * LM params: FSDP over "data" on the d_model/ff dimension that is NOT
    tensor-parallel; TP over "model" on heads/ff; embeddings sharded
    (vocab on "model", d on "data"); MoE experts sharded over "model"
    (expert parallelism).
  * LM activations: batch over ("pod","data") — per-shape overrides below.
  * GNN/recsys: see the per-family spec functions.

"pod" is pure data parallelism: every param spec leaves it unsharded; the
gradient all-reduce over pods is where optim/compression applies.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, List

import torch
from torch import nn


class P(tuple):
    """A partition spec: ``P(*entries)``, a tuple of one entry a tensor
    dimension (``None``, an axis name or a tuple of names); dimensions
    past its length are replicated. ``P(...) == tuple(reference_spec)``
    compares it with the reference's ``PartitionSpec``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def _axes(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def to_placements(spec, mesh) -> List[Any]:
    """The DTensor placements of ``spec`` on ``mesh``: for each mesh
    dimension ``Shard(d)`` when its name is in the entry of tensor
    dimension ``d``, else ``Replicate()``. A tuple entry puts ``Shard(d)``
    on each of its axes; they must follow the mesh's order (major
    first, as GSPMD splits a dimension over an axis tuple). An axis the
    mesh lacks, or one named twice, raises ``ValueError``."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.mesh_dim_names or ())
    out: List[Any] = [Replicate()] * len(names)
    seen = set()
    for d, entry in enumerate(spec):
        axes = _axes(entry)
        dims = []
        for ax in axes:
            if ax not in names:
                raise ValueError(f"spec {tuple(spec)!r}: the mesh has no "
                                 f"axis {ax!r} (axes {names})")
            if ax in seen:
                raise ValueError(f"spec {tuple(spec)!r}: axis {ax!r} is "
                                 "named twice")
            seen.add(ax)
            dims.append(names.index(ax))
        if dims != sorted(dims):
            raise ValueError(f"spec {tuple(spec)!r}: the axes {axes} of "
                             f"dimension {d} must follow the mesh's order "
                             f"{names}")
        for m in dims:
            out[m] = Shard(d)
    return out


def lm_param_specs(cfg, mesh=None, model_size: int = 16) -> Dict[str, Any]:
    """The specs of the LM's parameters, by the reference's names:
    ``embed``, ``unembed``, ``final_norm`` and ``layers`` (a dict of the
    stacked ``[L, ...]`` tensors' specs).

    Head dimensions are tensor-parallel only when the head count divides the
    model axis (qwen2: 28 q / 4 kv heads, yi: 56 heads do not divide 16 —
    those fall back to FSDP-only attention)."""
    fsdp = "data"
    tp = "model"

    def htp(n_heads):
        return tp if n_heads % model_size == 0 else None

    lay: Dict[str, Any] = {
        "ln_attn": P(None, None),
        "ln_ffn": P(None, None),
    }
    if cfg.attention == "mla":
        m = cfg.mla
        h = htp(cfg.n_heads)
        if m and m.q_lora:
            lay["w_dq"] = P(None, fsdp, tp)
            lay["q_ln"] = P(None, None)
        lay["w_uq"] = P(None, fsdp, h, None)
        lay["w_dkv"] = P(None, fsdp, None)
        lay["kv_ln"] = P(None, None)
        lay["w_uk"] = P(None, None, h, None)
        lay["w_uv"] = P(None, None, h, None)
        lay["w_o"] = P(None, h, None, fsdp)
    else:
        hq = htp(cfg.n_heads)
        hkv = htp(cfg.n_kv_heads)
        lay["w_q"] = P(None, fsdp, hq, None)
        lay["w_k"] = P(None, fsdp, hkv, None)
        lay["w_v"] = P(None, fsdp, hkv, None)
        lay["w_o"] = P(None, hq, None, fsdp)
        if cfg.qkv_bias:
            lay["b_q"] = P(None, hq, None)
            lay["b_k"] = P(None, hkv, None)
            lay["b_v"] = P(None, hkv, None)
        if cfg.qk_norm:
            lay["q_norm"] = P(None, None)
            lay["k_norm"] = P(None, None)
    if cfg.moe:
        lay["router"] = P(None, fsdp, None)
        lay["w_gate"] = P(None, tp, fsdp, None)   # experts over model axis
        lay["w_up"] = P(None, tp, fsdp, None)
        lay["w_down"] = P(None, tp, None, fsdp)
        if cfg.moe.n_shared:
            lay["ws_gate"] = P(None, fsdp, tp)
            lay["ws_up"] = P(None, fsdp, tp)
            lay["ws_down"] = P(None, tp, fsdp)
    else:
        lay["w_gate"] = P(None, fsdp, tp)
        lay["w_up"] = P(None, fsdp, tp)
        lay["w_down"] = P(None, tp, fsdp)
    return {
        "embed": P(tp, fsdp),
        "unembed": P(fsdp, tp),
        "final_norm": P(None),
        "layers": lay,
    }


def lm_batch_spec(multi_pod: bool) -> P:
    return P(("pod", "data") if multi_pod else "data", None)


def lm_cache_specs(
    cfg,
    multi_pod: bool,
    batch: int = 0,
    data_size: int = 16,
    model_size: int = 16,
) -> Dict[str, Any]:
    """KV cache layout. Two regimes:

    * batch >= data axis: batch-sharded cache (decode_32k), heads/latent
      over model where divisible.
    * batch < data axis (long_500k, batch=1): SEQUENCE-sharded cache —
      the masked softmax over the sharded length axis needs only
      all-reduces of the running max/sum (flash-decoding layout).
    """
    pods = 2 if multi_pod else 1
    batch_ax = ("pod", "data") if multi_pod else "data"
    seq_shard = batch % (data_size * pods) != 0
    b_ax = None if seq_shard else batch_ax
    s_ax = batch_ax if seq_shard else None
    if cfg.attention == "mla":
        m = cfg.mla
        lat = "model" if (m and m.kv_lora % model_size == 0) else None
        return {
            "c_kv": P(None, b_ax, s_ax, lat),
            "k_rope": P(None, b_ax, s_ax, None, None),
            "length": P(),
        }
    if cfg.n_kv_heads % model_size == 0:
        hkv, s2_ax = "model", s_ax
    else:
        # too few KV heads for TP (yi: 8, qwen2: 4): shard the cache
        # LENGTH over "model" instead (flash-decoding layout)
        hkv = None
        if s_ax:
            base = s_ax if isinstance(s_ax, tuple) else (s_ax,)
            s2_ax = base + ("model",)
        else:
            s2_ax = "model"
    return {
        "k": P(None, b_ax, s2_ax, hkv, None),
        "v": P(None, b_ax, s2_ax, hkv, None),
        "length": P(),
    }


def opt_state_specs(param_specs) -> Dict[str, Any]:
    return {
        "m": param_specs,
        "v": param_specs,
        "count": P(),
    }


def gnn_specs(multi_pod: bool):
    """Full-graph GNN: nodes and edges 1D-sharded over the whole mesh."""
    flat = ("pod", "data", "model") if multi_pod else ("data", "model")
    return {
        "node_feat": P(flat, None),
        "senders": P(flat),
        "receivers": P(flat),
        "edge_mask": P(flat),
        "node_mask": P(flat),
        "graph_id": P(flat),
    }


def recsys_specs(multi_pod: bool):
    flat = ("pod", "data", "model") if multi_pod else ("data", "model")
    return {
        "embed": P(flat, None),    # rows over the whole mesh
        "w1": P(flat),
        "batch": P(flat),
    }


# ---------------------------------------------------------------------------
# placing tensors
# ---------------------------------------------------------------------------
def is_spec(x) -> bool:
    return isinstance(x, P)


# an ``nn.Linear``'s tensors under the reference's names
_LINEAR = {"weight": "w", "bias": "b"}


def param_tree(module: nn.Module, leaf) -> Any:
    """``module``'s parameters as the reference's pytree: a dict by
    attribute name (an ``nn.Linear``'s ``weight`` / ``bias`` as ``w`` /
    ``b``), a list for a ``ModuleList``, ``leaf(name, tensor)`` at each
    parameter (``name`` dotted, as ``named_parameters`` gives it). The
    GNN and DeepFM modules mirror the reference's trees, so
    ``param_tree(m, lambda *_: P())`` is the reference's ``jax.tree.map(
    lambda _: P(), params)``."""
    def walk(mod: nn.Module, prefix: str):
        if isinstance(mod, (nn.ModuleList, nn.Sequential)):
            return [walk(c, f"{prefix}{i}.") for i, c in enumerate(mod)]
        out = {_LINEAR.get(k, k) if isinstance(mod, nn.Linear) else k:
               leaf(prefix + k, p)
               for k, p in mod.named_parameters(recurse=False)}
        out.update({k: walk(c, f"{prefix}{k}.")
                    for k, c in mod.named_children()})
        return out
    return walk(module, "")


def spec_at(specs, name: str):
    """The spec of parameter ``name`` (``layers.w_q``, ``layers.0.pre.0.w``)
    in the tree ``specs`` (dicts by key, lists by index), a ``P`` met on
    the way standing for every tensor under it."""
    node = specs
    for part in name.split("."):
        if is_spec(node):
            return node
        try:
            if isinstance(node, list):
                node = node[int(part)]
            else:
                node = node[part if part in node else _LINEAR[part]]
        except (KeyError, IndexError, ValueError, TypeError):
            raise KeyError(f"no spec for parameter {name!r}") from None
    if not is_spec(node):
        raise KeyError(f"no spec for parameter {name!r}: {node!r}")
    return node


def distribute(t: torch.Tensor, spec, mesh) -> torch.Tensor:
    """``t`` as a DTensor on ``mesh`` placed by ``spec``. Every rank passes
    the same global ``t`` and keeps its own shard of it (no collective:
    the ranks drew ``t`` from one seed; a meta ``t`` gives meta
    shards)."""
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(t, mesh, to_placements(spec, mesh),
                             src_data_rank=None)


def shard_params(params, specs, mesh):
    """``params`` placed on ``mesh`` by ``specs``, in place, and returned.

    ``params`` is an ``nn.Module`` (the port's ``LM``: ``embed``,
    ``unembed``, ``final_norm`` and ``layers.<name>`` by the reference's
    names; a GNN or ``DeepFM``) or a mapping of name to tensor. Each
    parameter becomes a ``distribute_tensor`` parameter (its
    ``requires_grad`` kept); ``specs`` is the reference's tree of specs
    by the same names (``spec_at``)."""
    if isinstance(params, nn.Module):
        for name, p in list(params.named_parameters()):
            owner = params
            *path, leaf = name.split(".")
            for part in path:
                owner = getattr(owner, part)
            t = distribute(p.detach(), spec_at(specs, name), mesh)
            setattr(owner, leaf, nn.Parameter(
                t, requires_grad=p.requires_grad))
        return params
    for name in list(params):
        params[name] = distribute(params[name], spec_at(specs, name), mesh)
    return params


def place(x, spec, mesh):
    """A cell's input ``x`` placed by its spec tree ``spec`` (the
    ``in_specs`` entry of ``launch/steps.py``) and returned: a module,
    or a mapping of parameter names (an optimizer state's moments), by
    ``shard_params`` (in place); any other dict entry by entry (in
    place); a tuple or a dataclass (``GraphBatch``) field by field; a
    tensor by ``distribute``; anything else (an int) as it is."""
    if isinstance(x, nn.Module) or (isinstance(x, dict) and (
            is_spec(spec) or not set(x) <= set(spec))):
        return shard_params(x, spec, mesh)
    if isinstance(x, torch.Tensor):
        return distribute(x, spec, mesh)
    if isinstance(x, dict):
        for k in x:
            x[k] = place(x[k], spec[k], mesh)
        return x
    if isinstance(x, (tuple, list)):
        return type(x)(place(v, s, mesh) for v, s in zip(x, spec))
    if dataclasses.is_dataclass(x):
        return dataclasses.replace(x, **{
            f.name: place(getattr(x, f.name), getattr(spec, f.name), mesh)
            for f in dataclasses.fields(x)
            if isinstance(getattr(x, f.name), torch.Tensor)})
    return x


def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor (the sharded paths' test)."""
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def redistribute(x, spec):
    """DTensor ``x`` redistributed to ``spec`` on its own mesh (the
    reference's ``with_sharding_constraint``); a plain tensor as it is."""
    if not is_dtensor(x):
        return x
    mesh = x.device_mesh
    return x.redistribute(mesh, to_placements(spec, mesh))


@contextlib.contextmanager
def replicated_region():
    """The context the sharded model paths run in: a plain tensor met
    beside a DTensor (a scalar, a learning rate, a table) is taken as
    replicated (``implicit_replication``, restored to its previous state
    on exit, so regions nest). The flag is the calling thread's: a
    backward that autograd runs on a device thread does not see it, so
    a plain tensor that a backward reads (a mask, an index) is made a
    replicated DTensor where it is built (``replicate_like``)."""
    from torch.distributed.tensor import DTensor

    dispatcher = DTensor._op_dispatcher
    before = dispatcher._allow_implicit_replication
    dispatcher._allow_implicit_replication = True
    try:
        yield
    finally:
        dispatcher._allow_implicit_replication = before


def replicated(x, mesh):
    """Tensor ``x`` on ``mesh``: a DTensor (or ``None``) as it is, a plain
    tensor (the same global value on every rank) as a replicated
    DTensor."""
    if x is None or is_dtensor(x):
        return x
    from torch.distributed.tensor import DTensor, Replicate

    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def replicate_like(x, ref):
    """``replicated(x, ref's mesh)`` when ``ref`` is a DTensor; else
    ``x``."""
    return replicated(x, ref.device_mesh) if is_dtensor(ref) else x
