"""Cell programs: (arch x shape) -> step function + inputs.

The reference's ``launch/steps.py`` for one card. A ``CellProgram``
holds the step function of a cell (a training step for the ``train``,
GNN and coremaint cells, the serving call for ``prefill``, ``decode``,
``serve`` and ``retrieval``), its inputs as meta-device tensors of the
concrete inputs' shapes and dtypes (``abstract_inputs``: an ``LM(cfg,
"meta")``, ``adamw_init`` of it, meta batches), and ``concrete_inputs``
(``seed`` -> the inputs on the program's device; the reference gives
them to smoke cells only, the port to every cell, so the card can run
the full ones). One code path builds the function; only the input source
differs.

Training steps are the reference's: the loss's gradients by
``torch.autograd.grad``, ``clip_by_global_norm(grads, 1.0)`` and
``adamw_update`` at a fixed learning rate (1e-4 for the LMs, 1e-3
otherwise), parameters and optimizer state updated in place (the
reference donates them). The LM loss runs the plain attention
(``kernel_backend="torch"``: the reference trains through XLA, and the
attention kernel is forward-only); DeepFM trains with
``use_pallas_fm=False``, its config's default.

The GNN batches are the reference's ``_concrete_graph_batch`` draws, bit
for bit (numpy, seeded), with the index columns as int64; LM tokens and
model parameters are drawn from a ``torch.Generator`` seeded ``seed``
(the numbers differ from ``jax.random``'s). The full (non-smoke) LM
cells take the reference's streaming attention pin, ``attn_chunk=2048``
(not with ``REPRO_NO_PIN`` set, as in the reference). Its sharding pins
(``batch_axes``, ``tp_axis``, the GNN ``shard_axes`` with DimeNet's
``msg_dtype``), ``in_specs`` / ``out_specs`` (``None`` here) and
``multi_pod=True`` come with the pod dry-run: ROADMAP Queue 1 E.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch

from ..configs import get_arch
from ..configs.common import ShapeCell
from ..device import resolve_device
from ..models import gnn as gnn_mod
from ..models import recsys as rec_mod
from ..models import transformer as tf_mod
from ..models.gnn import GraphBatch
from ..optim.adamw import adamw_init, adamw_update, clip_by_global_norm
from ..optim.params import trainable

Tensor = torch.Tensor
META = "meta"
NOT_PORTED = ("the pod dry-run's sharding (multi_pod, batch_axes / tp_axis "
              "/ shard_axes pins, in_specs / out_specs) is ROADMAP Queue 1 E")


@dataclasses.dataclass
class CellProgram:
    """Everything needed to run one (arch x shape) cell."""

    name: str
    fn: Callable[..., Any]
    abstract_inputs: Tuple[Any, ...]
    in_specs: Optional[Tuple[Any, ...]]      # None: ROADMAP Queue 1 E
    out_specs: Optional[Any]
    concrete_inputs: Optional[Callable[..., Tuple[Any, ...]]] = None
    donate: Tuple[int, ...] = ()


def _generator(seed: int, device: torch.device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def _train_step(loss_fn: Callable[..., Tensor], lr: float):
    """A cell's training step ``step(params, opt_state, *batch) ->
    (params, opt_state, {"loss", "grad_norm"})``: the reference's
    ``value_and_grad`` of ``loss_fn(params, *batch)`` (a parameter the
    loss does not use gets a zero gradient, as in jax), the clip at 1.0
    and AdamW at ``lr``, in place."""
    def step(params, opt_state, *batch):
        named = trainable(params)
        with torch.enable_grad():
            loss = loss_fn(params, *batch)
            grads = torch.autograd.grad(loss, list(named.values()),
                                        allow_unused=True,
                                        materialize_grads=True)
        grads, gn = clip_by_global_norm(dict(zip(named, grads)), 1.0)
        adamw_update(named, grads, opt_state, lr)
        return params, opt_state, {"loss": loss.detach(), "grad_norm": gn}

    return step


# ---------------------------------------------------------------------------
# LM cells
# ---------------------------------------------------------------------------
def _lm_train_step(cfg):
    return _train_step(lambda p, tokens, targets: tf_mod.loss_fn(
        cfg, p, tokens, targets, kernel_backend="torch"), 1e-4)


def _lm_cell(arch_name: str, cfg, cell: ShapeCell, for_smoke: bool,
             dev: torch.device) -> CellProgram:
    if not for_smoke and not os.environ.get("REPRO_NO_PIN"):
        cfg = dataclasses.replace(cfg, attn_chunk=2048)  # streaming (D2)
    p_abs = tf_mod.LM(cfg, META)
    tok_abs = lambda *shape: torch.empty(shape, dtype=torch.int32,  # noqa
                                         device=META)

    def init(gen):
        return tf_mod.init_params(cfg, gen, device=dev)

    def tokens(gen, *shape):
        return torch.randint(0, cfg.vocab, shape, generator=gen, device=dev,
                             dtype=torch.int32)

    if cell.kind == "train":
        b, s = cell.params["batch"], cell.params["seq"]
        fn = _lm_train_step(cfg)
        abstract = (p_abs, adamw_init(p_abs), tok_abs(b, s), tok_abs(b, s))
        donate = (0, 1)

        def concrete(seed: int = 0):
            gen = _generator(seed, dev)
            params = init(gen)
            toks = tokens(gen, b, s)
            return params, adamw_init(params), toks, toks

    elif cell.kind == "prefill":
        b, s = cell.params["batch"], cell.params["seq"]

        @torch.no_grad()
        def fn(params, tokens):
            return tf_mod.prefill(cfg, params, tokens)

        abstract = (p_abs, tok_abs(b, s))
        donate = ()

        def concrete(seed: int = 0):
            gen = _generator(seed, dev)
            return init(gen), tokens(gen, b, s)

    elif cell.kind == "decode":
        b, t = cell.params["batch"], cell.params["cache"]

        @torch.no_grad()
        def fn(params, cache, token):
            return tf_mod.decode_step(cfg, params, cache, token)

        abstract = (p_abs, tf_mod.init_cache(cfg, b, t, device=META),
                    tok_abs(b))
        donate = (1,)

        def concrete(seed: int = 0):
            gen = _generator(seed, dev)
            params = init(gen)
            cache = tf_mod.init_cache(cfg, b, t, device=dev)
            cache["length"] = torch.tensor(t // 2, dtype=torch.int32,
                                           device=dev)
            return params, cache, tokens(gen, b)

    else:
        raise ValueError(cell.kind)
    return CellProgram(
        name=f"{arch_name}:{cell.name}", fn=fn, abstract_inputs=abstract,
        in_specs=None, out_specs=None,
        concrete_inputs=concrete, donate=donate,
    )


# ---------------------------------------------------------------------------
# GNN cells
# ---------------------------------------------------------------------------
def _log_probs(logits: Tensor, labels: Tensor) -> Tensor:
    logp = torch.log_softmax(logits, dim=-1)
    return torch.gather(logp, -1, labels.long()[:, None])[:, 0]


def _gnn_fwd_and_loss(arch_name: str, cfg):
    if arch_name.startswith("pna"):
        def loss(params, batch, labels):
            logits = gnn_mod.pna_forward(cfg, params, batch)
            nll = -_log_probs(logits, labels)
            mask = batch.node_mask.to(nll.dtype)
            return torch.sum(nll * mask) / torch.clamp(torch.sum(mask),
                                                       min=1.0)
        return gnn_mod.pna_init, gnn_mod.PNA, loss, "node_labels"
    if arch_name.startswith("gin"):
        def loss(params, batch, labels):
            logits = gnn_mod.gin_forward(cfg, params, batch)
            return -torch.mean(_log_probs(logits, labels))
        return gnn_mod.gin_init, gnn_mod.GIN, loss, "graph_labels"
    if arch_name.startswith("dimenet"):
        def loss(params, batch_and_tri, energies):
            batch, tkj, tji, tm = batch_and_tri
            e = gnn_mod.dimenet_forward(cfg, params, batch, tkj, tji, tm)
            return torch.mean((e - energies) ** 2)
        return gnn_mod.dimenet_init, gnn_mod.DimeNet, loss, "energies"
    if arch_name.startswith("nequip"):
        def loss(params, batch, energies):
            e = gnn_mod.nequip_energy(cfg, params, batch.positions, batch)
            return torch.mean((e - energies) ** 2)
        return gnn_mod.nequip_init, gnn_mod.NequIP, loss, "energies"
    raise ValueError(arch_name)


def _pad512(x: int) -> int:
    return -(-x // 512) * 512


def _graph_shapes_for_cell(cell: ShapeCell) -> Tuple[int, int, int, int]:
    """(n_nodes, n_edges_directed, d_feat, n_graphs) for a GNN cell, the
    node/edge capacities padded to multiples of 512 as the reference
    pads them (pads are masked)."""
    p = cell.params
    if cell.kind == "full_graph":
        return _pad512(p["n_nodes"]), _pad512(p["n_edges"]), p["d_feat"], 1
    if cell.kind == "minibatch":
        mult = 1
        for f in p["fanout"]:
            mult *= f + 1
        n_cap = _pad512(p["batch_nodes"] * mult)
        return n_cap, 2 * n_cap, p["d_feat"], 1
    if cell.kind == "molecule":
        return (
            _pad512(p["n_nodes"] * p["batch"]),
            _pad512(p["n_edges"] * p["batch"]),
            1,
            p["batch"],
        )
    raise ValueError(cell.kind)


def _abstract_graph_batch(n, e, f, g, molecular: bool) -> GraphBatch:
    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device=META)

    i64, f32 = torch.int64, torch.float32
    return GraphBatch(
        node_feat=meta((n, f), f32), senders=meta((e,), i64),
        receivers=meta((e,), i64), edge_mask=meta((e,), torch.bool),
        node_mask=meta((n,), torch.bool), graph_id=meta((n,), i64),
        n_graphs=g,
        positions=meta((n, 3), f32) if molecular else None,
        species=meta((n,), i64) if molecular else None,
    )


def _concrete_graph_batch(n, e, f, g, molecular: bool, device
                          ) -> GraphBatch:
    """The reference's draws (``default_rng(0)``), bit for bit."""
    rng = np.random.default_rng(0)
    senders = rng.integers(0, n, size=e).astype(np.int32)
    receivers = rng.integers(0, n, size=e).astype(np.int32)
    node_feat = rng.normal(size=(n, f)).astype(np.float32)
    positions = ((rng.normal(size=(n, 3)) * 2).astype(np.float32)
                 if molecular else None)
    species = (rng.integers(0, 8, size=n).astype(np.int32)
               if molecular else None)
    return GraphBatch.from_numpy(
        g, node_feat=node_feat, senders=senders, receivers=receivers,
        edge_mask=senders != receivers, node_mask=np.ones((n,), bool),
        graph_id=np.minimum(np.arange(n) * g // max(n, 1),
                            g - 1).astype(np.int32),
        positions=positions, species=species,
    ).to(device)


def _gnn_labels(label_kind: str, cfg, n: int, g: int, device) -> Tensor:
    rng = np.random.default_rng(1)
    if label_kind == "node_labels":
        lab = rng.integers(0, cfg.n_classes, size=n).astype(np.int32)
    elif label_kind == "graph_labels":
        lab = rng.integers(0, cfg.n_classes, size=g).astype(np.int32)
    else:
        lab = rng.normal(size=g).astype(np.float32)
    return torch.from_numpy(lab).to(device)


def _gnn_cell(arch_name: str, cfg, cell: ShapeCell, for_smoke: bool,
              dev: torch.device) -> CellProgram:
    molecular = arch_name.startswith(("dimenet", "nequip"))
    n, e, f, g = _graph_shapes_for_cell(cell)
    if hasattr(cfg, "d_in") and cfg.d_in != f:
        cfg = dataclasses.replace(cfg, d_in=f)  # shape dictates input width
    init, model_cls, loss, label_kind = _gnn_fwd_and_loss(arch_name, cfg)
    p_abs = model_cls(cfg, META)
    is_dimenet = arch_name.startswith("dimenet")
    t_cap = 2 * e if is_dimenet else 0

    step = _train_step(lambda p, batch, labels, *tri: loss(
        p, (batch,) + tri if is_dimenet else batch, labels), 1e-3)

    lab_shape, lab_dt = {"node_labels": ((n,), torch.int32),
                         "graph_labels": ((g,), torch.int32),
                         "energies": ((g,), torch.float32)}[label_kind]
    abstract = [p_abs, adamw_init(p_abs),
                _abstract_graph_batch(n, e, f, g, molecular),
                torch.empty(lab_shape, dtype=lab_dt, device=META)]
    if is_dimenet:
        abstract += [torch.empty((t_cap,), dtype=torch.int64, device=META),
                     torch.empty((t_cap,), dtype=torch.int64, device=META),
                     torch.empty((t_cap,), dtype=torch.bool, device=META)]

    def concrete(seed: int = 0):
        params = init(cfg, _generator(seed, dev), device=dev)
        batch = _concrete_graph_batch(n, e, f, g, molecular, dev)
        out = [params, adamw_init(params), batch,
               _gnn_labels(label_kind, cfg, n, g, dev)]
        if is_dimenet:
            tri = gnn_mod.build_triplets(
                batch.senders.cpu().numpy(), batch.receivers.cpu().numpy(),
                batch.edge_mask.cpu().numpy(), t_cap)
            out += list(gnn_mod.triplet_tensors(tri, dev))
        return tuple(out)

    return CellProgram(
        name=f"{arch_name}:{cell.name}", fn=step,
        abstract_inputs=tuple(abstract), in_specs=None, out_specs=None,
        concrete_inputs=concrete, donate=(0, 1),
    )


# ---------------------------------------------------------------------------
# recsys cells
# ---------------------------------------------------------------------------
def _recsys_cell(arch_name: str, cfg, cell: ShapeCell, for_smoke: bool,
                 dev: torch.device) -> CellProgram:
    p_abs = rec_mod.DeepFM(cfg, device=META)
    b = cell.params["batch"]
    ids_abs = torch.empty((b, cfg.n_sparse), dtype=torch.int32, device=META)

    def init(seed: int):
        return rec_mod.deepfm_init(cfg, _generator(seed, dev), device=dev)

    def ids(rng):
        return torch.from_numpy(rng.integers(
            0, cfg.rows_per_field, size=(b, cfg.n_sparse)).astype(
                np.int32)).to(dev)

    if cell.kind == "train":
        step = _train_step(lambda p, sparse, labels: rec_mod.deepfm_loss(
            cfg, p, sparse, labels), 1e-3)

        abstract = (p_abs, adamw_init(p_abs), ids_abs,
                    torch.empty((b,), dtype=torch.float32, device=META))
        donate = (0, 1)

        def concrete(seed: int = 0):
            params = init(seed)
            rng = np.random.default_rng(0)
            sparse = ids(rng)
            lab = torch.from_numpy(rng.integers(0, 2, size=b).astype(
                np.float32)).to(dev)
            return params, adamw_init(params), sparse, lab

    elif cell.kind == "serve":
        @torch.no_grad()
        def step(params, sparse):
            return rec_mod.deepfm_forward(cfg, params, sparse)

        abstract = (p_abs, ids_abs)
        donate = ()

        def concrete(seed: int = 0):
            return init(seed), ids(np.random.default_rng(0))

    elif cell.kind == "retrieval":
        nc = _pad512(cell.params["n_candidates"])

        @torch.no_grad()
        def step(params, sparse, cand):
            return rec_mod.retrieval_score(cfg, params, sparse, cand)

        abstract = (p_abs, ids_abs,
                    torch.empty((nc, cfg.embed_dim), dtype=torch.float32,
                                device=META))
        donate = ()

        def concrete(seed: int = 0):
            rng = np.random.default_rng(0)
            sparse = ids(rng)
            cand = torch.from_numpy(rng.normal(
                size=(nc, cfg.embed_dim)).astype(np.float32)).to(dev)
            return init(seed), sparse, cand
    else:
        raise ValueError(cell.kind)
    return CellProgram(
        name=f"{arch_name}:{cell.name}", fn=step,
        abstract_inputs=abstract, in_specs=None, out_specs=None,
        concrete_inputs=concrete, donate=donate,
    )


# ---------------------------------------------------------------------------
# coremaint cells (the paper's own workload)
# ---------------------------------------------------------------------------
def coremaint_graph(cfg):
    """The coremaint cells' graph, the reference's
    ``erdos_renyi(n, min(cap // 4, 3 n), seed=0)``."""
    from ..graph.generators import erdos_renyi

    cap = _pad512(cfg.edge_capacity)
    return erdos_renyi(cfg.n_vertices, min(cap // 4, 3 * cfg.n_vertices),
                       seed=0)


def coremaint_inputs(cfg, cell: ShapeCell, device) -> Tuple[Any, ...]:
    """A coremaint cell's inputs on ``device``: ``coremaint_graph(cfg)``
    in a maintainer of capacity ``cap`` built as the reference builds
    it (``init="host-bz"``), then ``coremaint_batch``."""
    from ..core.api import CoreMaintainer

    m = CoreMaintainer.from_graph(coremaint_graph(cfg),
                                  capacity=_pad512(cfg.edge_capacity),
                                  device=resolve_device(device))
    return coremaint_batch(cfg, cell, m)


def coremaint_batch(cfg, cell: ShapeCell, m) -> Tuple[Any, ...]:
    """A coremaint cell's inputs from maintainer ``m``'s tensors (the
    cells' steps leave them as they are): the removal slots (the first
    ``batch_edges`` live slots, the reference's first ``edge_slot``
    values) or the seeded insertions."""
    n, b, dev = cfg.n_vertices, cell.params["batch_edges"], m.src.device
    if cell.kind == "coremaint_remove":
        live = torch.nonzero(m.valid).flatten()[:b].to(torch.int32)
        slots = torch.full((b,), -1, dtype=torch.int32, device=dev)
        slots[: live.shape[0]] = live
        return m.src, m.dst, m.valid, m.core, m.label, slots
    rng = np.random.default_rng(1)
    ns = rng.integers(0, n, size=b).astype(np.int32)
    nd = (ns + 1 + rng.integers(0, n - 1, size=b)).astype(np.int32) % n
    ok = ns != nd
    put = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    return (m.src, m.dst, m.valid, m.core, m.label, put(ns), put(nd),
            put(ok), m.n_edges)


def _coremaint_cell(arch_name: str, cfg, cell: ShapeCell, for_smoke: bool,
                    dev: torch.device) -> CellProgram:
    from ..core.insert import insert_batch
    from ..core.remove import remove_batch

    n = cfg.n_vertices
    cap = _pad512(cfg.edge_capacity)
    b = cell.params["batch_edges"]
    n_levels = 512  # max core bound for label segments at this scale
    meta = lambda shape, dt: torch.empty(shape, dtype=dt,  # noqa: E731
                                         device=META)
    table = (meta((cap,), torch.int32), meta((cap,), torch.int32),
             meta((cap,), torch.bool), meta((n,), torch.int32),
             meta((n,), torch.int64))

    if cell.kind == "coremaint_remove":
        def step(src, dst, valid, core, label, slots):
            return remove_batch(src, dst, valid, core, label, slots, n,
                                n_levels)

        abstract = table + (meta((b,), torch.int32),)
    else:
        def step(src, dst, valid, core, label, ns, nd, ok, ne):
            return insert_batch(src, dst, valid, core, label, ns, nd, ok,
                                ne, n, n_levels)

        abstract = table + (meta((b,), torch.int32),
                            meta((b,), torch.int32),
                            meta((b,), torch.bool), meta((), torch.int32))

    def concrete(seed: int = 0):
        return coremaint_inputs(cfg, cell, dev)

    return CellProgram(
        name=f"{arch_name}:{cell.name}", fn=step,
        abstract_inputs=abstract, in_specs=None, out_specs=None,
        concrete_inputs=concrete,
    )


# ---------------------------------------------------------------------------
# public entry
# ---------------------------------------------------------------------------
def build_cell(
    arch_name: str,
    shape_name: str,
    smoke: bool = False,
    multi_pod: bool = False,
    unroll: bool = False,
    device=None,
) -> CellProgram:
    """The cell program of ``arch_name`` at ``shape_name`` (``smoke``:
    the reduced config and shapes, with ``concrete_inputs``); inputs are
    made on ``device`` (``None``: the card; raises without one)."""
    if multi_pod:
        raise NotImplementedError(f"build_cell(multi_pod=True): {NOT_PORTED}")
    dev = resolve_device(device)
    mod = get_arch(arch_name)
    cfg = mod.smoke() if smoke else mod.full()
    if unroll and hasattr(cfg, "scan_unroll"):
        cfg = dataclasses.replace(cfg, scan_unroll=cfg.n_layers)
    shapes = mod.SHAPES_SMOKE if smoke else mod.SHAPES
    cell = next(c for c in shapes if c.name == shape_name)
    build = {"lm": _lm_cell, "gnn": _gnn_cell, "recsys": _recsys_cell,
             "coremaint": _coremaint_cell}.get(mod.FAMILY)
    if build is None:
        raise ValueError(mod.FAMILY)
    return build(arch_name, cfg, cell, smoke, dev)


def cell_names(arch_name: str, smoke: bool = False):
    mod = get_arch(arch_name)
    shapes = mod.SHAPES_SMOKE if smoke else mod.SHAPES
    return [c.name for c in shapes]
