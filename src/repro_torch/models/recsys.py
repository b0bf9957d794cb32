"""DeepFM [arXiv:1703.04247] with a hand-built EmbeddingBag, on PyTorch.

The port of the reference's ``models/recsys.py``. The model is an
``nn.Module``, ``DeepFM``, holding the embedding table (one
``[vocab_total, embed_dim]`` matrix with per-field row offsets), the
first-order weights ``w1``, the scalar ``bias`` and the MLP; its
``forward`` is ``deepfm_forward``. The reference's functional names are
kept (``deepfm_init``, ``deepfm_forward``, ``deepfm_loss``,
``retrieval_score``, ``embedding_bag``) so the two packages compare like
with like, and ``deepfm_params_from_reference`` carries the reference's
parameter pytree (as numpy arrays) over into a module.

Branches: first-order (scalar weight per feature), second-order FM
interaction (with ``use_pallas_fm=True`` the hand-written kernel of
``kernels/fm_interaction.py`` on a CUDA device, its plain version on the
CPU; else plain PyTorch, the reference's own second branch), deep MLP on
the concatenated field embeddings. Retrieval scoring (1 query x 1M
candidates) is a batched dot against a candidate embedding matrix.

The parameters are created with ``requires_grad=False`` (serving takes
no graph); the training loop (``train/loop.py``) makes them trainable
with ``requires_grad_`` and differentiates ``deepfm_loss``. Training runs
``use_pallas_fm=False``, the reference's default: the FM kernel, like
the reference's Pallas kernel, has no backward and refuses a CUDA input
that requires grad.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from ..parallel.sharding import is_dtensor, replicate_like


@dataclasses.dataclass(frozen=True)
class DeepFMConfig:
    name: str = "deepfm"
    n_sparse: int = 39
    embed_dim: int = 10
    mlp_dims: Tuple[int, ...] = (400, 400, 400)
    rows_per_field: int = 1_000_000   # hashed vocab per field
    n_dense: int = 0
    dtype: Any = torch.float32
    use_pallas_fm: bool = False

    @property
    def vocab_total(self) -> int:
        # padded to a multiple of 4096 so the row-sharded table divides any
        # mesh up to 4096 chips (standard vocab padding)
        raw = self.n_sparse * self.rows_per_field
        return -(-raw // 4096) * 4096

    @property
    def n_params(self) -> int:
        n = self.vocab_total * (self.embed_dim + 1)
        d_in = self.n_sparse * self.embed_dim + self.n_dense
        dims = (d_in,) + self.mlp_dims + (1,)
        for a, b in zip(dims[:-1], dims[1:]):
            n += a * b + b
        return n

    def mlp_shapes(self):
        """The MLP's ``(in, out)`` pairs, input to the scalar output."""
        d_in = self.n_sparse * self.embed_dim + self.n_dense
        dims = (d_in,) + self.mlp_dims + (1,)
        return list(zip(dims[:-1], dims[1:]))


class DeepFM(nn.Module):
    """The DeepFM parameters; ``forward(sparse, dense=None)`` is
    ``deepfm_forward``. The tensors are left uninitialised: build one
    with ``deepfm_init`` or ``deepfm_params_from_reference``. ``device``
    ``None`` means the card (raises without one)."""

    def __init__(self, cfg: DeepFMConfig, device=None):
        super().__init__()
        self.cfg = cfg
        kw = dict(dtype=cfg.dtype, device=resolve_device(device))
        v, e = cfg.vocab_total, cfg.embed_dim
        self.embed = nn.Parameter(torch.empty(v, e, **kw))
        self.w1 = nn.Parameter(torch.empty(v, **kw))
        self.bias = nn.Parameter(torch.zeros((), **kw))
        self.mlp = nn.ModuleList(nn.Linear(a, b, **kw)
                                 for a, b in cfg.mlp_shapes())
        self.requires_grad_(False)

    def forward(self, sparse: torch.Tensor,
                dense: Optional[torch.Tensor] = None) -> torch.Tensor:
        return deepfm_forward(self.cfg, self, sparse, dense)


def deepfm_init(cfg: DeepFMConfig, generator: torch.Generator,
                device=None) -> DeepFM:
    """Random DeepFM parameters with the reference's laws: embed and
    ``w1`` normal times 0.01, MLP weights normal over ``sqrt(in)``,
    biases 0. ``device`` ``None`` means the card (raises without one).
    The numbers are drawn on the generator's device and copied to
    ``device``, so they depend on the generator alone."""
    model = DeepFM(cfg, device=device)
    draw = generator.device

    def normal(x: torch.Tensor, scale: float) -> None:
        x.copy_(torch.empty(x.shape, dtype=torch.float32, device=draw)
                .normal_(generator=generator).mul_(scale))

    normal(model.embed, 0.01)
    normal(model.w1, 0.01)
    for lin, (a, b) in zip(model.mlp, cfg.mlp_shapes()):
        w = torch.empty((a, b), dtype=torch.float32, device=draw)
        w.normal_(generator=generator).div_(math.sqrt(a))
        lin.weight.copy_(w.t())  # the reference's [in, out] layout
        lin.bias.zero_()
    return model


def deepfm_params_from_reference(params: Mapping[str, Any],
                                 cfg: DeepFMConfig, device=None) -> DeepFM:
    """The reference's parameter pytree (``embed``, ``w1``, ``bias``,
    ``mlp`` as a list of ``{"w": [in, out], "b": [out]}``, any arrays
    numpy can read) as a ``DeepFM`` module on ``device`` (``None``: the
    card; raises without one)."""
    model = DeepFM(cfg, device=device)

    def put(dst: torch.Tensor, x) -> None:
        src = torch.from_numpy(np.array(x, dtype=np.float32))
        if tuple(src.shape) != tuple(dst.shape):
            raise ValueError(f"shape {tuple(src.shape)} != "
                             f"{tuple(dst.shape)}")
        dst.copy_(src)

    put(model.embed, params["embed"])
    put(model.w1, params["w1"])
    put(model.bias, params["bias"])
    if len(params["mlp"]) != len(model.mlp):
        raise ValueError("the MLP depth differs from the config's")
    for lin, lyr in zip(model.mlp, params["mlp"]):
        put(lin.weight, np.asarray(lyr["w"], dtype=np.float32).T)
        put(lin.bias, lyr["b"])
    return model


def embedding_bag(
    table: torch.Tensor,
    ids: torch.Tensor,
    bag_ids: Optional[torch.Tensor] = None,
    n_bags: Optional[int] = None,
    weights: Optional[torch.Tensor] = None,
    combine: str = "sum",
) -> torch.Tensor:
    """EmbeddingBag: gather rows then segment-reduce into bags.

    ids: [K] row indices; bag_ids: [K] bag assignment (None = identity),
    in any order. As ``segment_sum``: an empty bag gives 0 and a bag id
    outside ``[0, n_bags)`` is dropped; ``mean`` divides by
    ``max(count, 1)``.
    """
    rows = torch.index_select(table, 0, ids.reshape(-1))
    if weights is not None:
        rows = rows * weights[:, None]
    if bag_ids is None:
        return rows
    bag_ids = bag_ids.long()
    ok = (bag_ids >= 0) & (bag_ids < n_bags)
    # dropped rows land on a spare bag n_bags, cut off below
    seg = torch.where(ok, bag_ids, torch.full_like(bag_ids, n_bags))
    out = torch.zeros((n_bags + 1, rows.shape[1]), dtype=rows.dtype,
                      device=rows.device).index_add_(0, seg, rows)[:n_bags]
    if combine == "mean":
        cnt = torch.zeros(n_bags + 1, dtype=rows.dtype,
                          device=rows.device).index_add_(
            0, seg, torch.ones_like(seg, dtype=rows.dtype))[:n_bags]
        out = out / torch.clamp(cnt, min=1.0)[:, None]
    return out


def _field_ids(cfg: DeepFMConfig, sparse: torch.Tensor) -> torch.Tensor:
    """Per-field hashed ids -> global rows via field offsets."""
    offsets = torch.arange(cfg.n_sparse, dtype=sparse.dtype,
                           device=sparse.device) * cfg.rows_per_field
    return sparse + replicate_like(offsets[None, :], sparse)


def _field_embeddings(cfg: DeepFMConfig, params, sparse: torch.Tensor):
    rows = _field_ids(cfg, sparse).reshape(-1)
    emb = _table_rows(params.embed, rows).reshape(
        sparse.shape[0], cfg.n_sparse, cfg.embed_dim)
    return rows, emb


def _table_rows(table: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """``table[rows]``. On a DTensor table split by rows, each rank takes
    the rows of its own block from the whole ``rows`` (zeros for the
    others) and the partial results are summed onto ``rows``' own split
    (the vocab-parallel gather; ``local_map``)."""
    if not is_dtensor(table):
        return torch.index_select(table, 0, rows)
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    from torch.distributed.tensor.experimental import local_map

    mesh = table.device_mesh
    rows = replicate_like(rows, table)
    _, offset = compute_local_shape_and_global_offset(
        table.shape, mesh, table.placements)
    start = offset[0]

    def local(t, r):
        r = r - start
        ok = (r >= 0) & (r < t.shape[0])
        got = torch.index_select(t, 0, torch.where(ok, r, 0))
        return got * ok.reshape((-1,) + (1,) * (t.dim() - 1)).to(t.dtype)

    rep = [Replicate()] * mesh.ndim
    split = [Partial() if p.is_shard(0) else Replicate()
             for p in table.placements]
    out = local_map(local, out_placements=split,
                    in_placements=(list(table.placements), rep),
                    in_grad_placements=(list(table.placements), rep),
                    device_mesh=mesh, redistribute_inputs=True)(table, rows)
    return out.redistribute(mesh, [
        q if q.is_shard(0) else Replicate() for q in rows.placements])


def deepfm_forward(cfg: DeepFMConfig, params, sparse: torch.Tensor,
                   dense: Optional[torch.Tensor] = None) -> torch.Tensor:
    """sparse [B, n_sparse] int32 -> logits [B] float32."""
    b = sparse.shape[0]
    rows, emb = _field_embeddings(cfg, params, sparse)  # [B, F, E]
    first = _table_rows(params.w1, rows).reshape(b, -1).sum(-1)
    if cfg.use_pallas_fm:
        from ..kernels.ops import fm_interaction_op

        second = fm_interaction_op(emb)
    else:
        s = emb.sum(1)
        s2 = (emb * emb).sum(1)
        second = 0.5 * (s * s - s2).sum(-1)
    h = emb.reshape(b, -1)
    if dense is not None and cfg.n_dense:
        h = torch.cat([h, dense.to(emb.dtype)], dim=-1)
    for i, lin in enumerate(params.mlp):
        h = lin(h)
        if i < len(params.mlp) - 1:
            h = torch.relu(h)
    return (first + second + h[:, 0] + params.bias).to(torch.float32)


def deepfm_loss(cfg, params, sparse, labels, dense=None) -> torch.Tensor:
    logits = deepfm_forward(cfg, params, sparse, dense)
    return torch.mean(
        torch.clamp(logits, min=0.0)
        - logits * labels
        + torch.log1p(torch.exp(-torch.abs(logits)))
    )


def retrieval_score(cfg: DeepFMConfig, params, query_sparse: torch.Tensor,
                    cand_emb: torch.Tensor) -> torch.Tensor:
    """Score 1 query against [n_cand, d] candidate embeddings — batched dot,
    not a loop (retrieval_cand shape)."""
    _, emb = _field_embeddings(cfg, params, query_sparse)
    q = emb.sum(1)  # [B, d] pooled query embedding
    return torch.einsum("bd,nd->bn", q, cand_emb)
