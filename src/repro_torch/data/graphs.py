"""Graph datasets: synthetic Cora-like full-batch data and random molecule
batches (positions + species) for DimeNet/NequIP.

A numpy copy of the reference's ``data/graphs.py``: the same seed gives
the same arrays. The batch is a ``models.gnn.GraphBatch`` on ``device``
(``None``: the card; raises without one) with int64 index columns."""
from __future__ import annotations

from typing import Tuple

import numpy as np

from ..graph.csr import CSRGraph
from ..graph.generators import erdos_renyi
from ..models.gnn import GraphBatch


def load_cora_like(
    n: int = 2708, m: int = 5278, d_feat: int = 1433, n_classes: int = 7,
    seed: int = 0, device=None,
) -> Tuple[CSRGraph, GraphBatch, np.ndarray]:
    """Synthetic citation-graph stand-in with community-correlated features
    and labels (full_graph_sm shape: 2708 nodes / 10556 directed edges)."""
    rng = np.random.default_rng(seed)
    g = erdos_renyi(n, m, seed=seed)
    labels = rng.integers(0, n_classes, size=n)
    centers = rng.normal(size=(n_classes, d_feat)) * 0.5
    feats = (centers[labels] + rng.normal(size=(n, d_feat))).astype(
        np.float32
    )
    edges = g.edge_array()
    senders = np.concatenate([edges[:, 0], edges[:, 1]]).astype(np.int32)
    receivers = np.concatenate([edges[:, 1], edges[:, 0]]).astype(np.int32)
    batch = GraphBatch.from_numpy(
        1,
        node_feat=feats,
        senders=senders,
        receivers=receivers,
        edge_mask=np.ones(len(senders), dtype=bool),
        node_mask=np.ones(n, dtype=bool),
        graph_id=np.zeros(n, dtype=np.int32),
    )
    return g, batch.to(device), labels


def random_molecule_batch(
    n_mols: int = 4, n_atoms: int = 30, n_edges: int = 64,
    n_species: int = 8, seed: int = 0, device=None,
) -> GraphBatch:
    """Batched random molecules: radius-graph edges over random coordinates."""
    rng = np.random.default_rng(seed)
    N = n_mols * n_atoms
    pos = rng.normal(size=(n_mols, n_atoms, 3)) * 2.0
    senders, receivers = [], []
    for mi in range(n_mols):
        d = np.linalg.norm(
            pos[mi][:, None, :] - pos[mi][None, :, :], axis=-1
        )
        src, dst = np.nonzero((d < 3.0) & (d > 1e-6))
        order = rng.permutation(len(src))[: n_edges]
        senders.append(src[order] + mi * n_atoms)
        receivers.append(dst[order] + mi * n_atoms)
    s = np.concatenate(senders).astype(np.int32)
    r = np.concatenate(receivers).astype(np.int32)
    e_cap = n_mols * n_edges
    es = np.zeros(e_cap, dtype=np.int32)
    er = np.zeros(e_cap, dtype=np.int32)
    em = np.zeros(e_cap, dtype=bool)
    es[: len(s)], er[: len(r)], em[: len(s)] = s, r, True
    return GraphBatch.from_numpy(
        n_mols,
        node_feat=np.zeros((N, 1), np.float32),
        senders=es,
        receivers=er,
        edge_mask=em,
        node_mask=np.ones(N, dtype=bool),
        graph_id=np.repeat(np.arange(n_mols), n_atoms).astype(np.int32),
        positions=pos.reshape(N, 3).astype(np.float32),
        species=rng.integers(0, n_species, size=N).astype(np.int32),
    ).to(device)
