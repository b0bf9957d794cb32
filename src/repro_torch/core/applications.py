"""Applications of maintained core numbers: k-core sparsification for
full-batch GNN training and core-ordered neighbour-sampling priorities
for minibatch training — the port of the reference's
``core/applications.py``.

All of them read the LIVE maintained state (no recomputation): the point
of maintenance is that these stay fresh under edge streams.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .api import CoreMaintainer


def _kcore_mask(core, src, dst, valid, k: int) -> torch.Tensor:
    keep = core >= k
    return valid & keep[src] & keep[dst]


def kcore_edge_mask(m: CoreMaintainer, k: int) -> torch.Tensor:
    """Bool mask over the GLOBAL slot table, on the maintainer's device,
    of the live edges whose BOTH endpoints lie in the k-core. Under the
    sharded engine the table is gathered first (a collective: every
    rank calls it).

    The induced subgraph on {v: core(v) >= k} restricted to these edges
    IS the k-core (maximality of the core decomposition). Under
    ``vertex_sharding="range"`` / ``"halo"`` the cores are gathered
    too."""
    src, dst, valid, _ = m._table()
    return _kcore_mask(m._full(m.core), src, dst, valid, k)


def kcore_subgraph(m: CoreMaintainer, k: int
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side (nodes, edges) of the k-core — GNN sparsification
    input. Under the sharded engine the whole k-core, on every rank (one
    gather of the table: a collective)."""
    src, dst, valid, _ = m._table()
    core = m._full(m.core)
    mask = _kcore_mask(core, src, dst, valid, k).cpu().numpy()
    src = src.cpu().numpy()[mask]
    dst = dst.cpu().numpy()[mask]
    nodes = np.nonzero(core.cpu().numpy() >= k)[0]
    return nodes, np.stack([src, dst], axis=1)


def core_sampling_weights(m: CoreMaintainer, alpha: float = 1.0
                          ) -> np.ndarray:
    """Neighbour-sampling priorities proportional to (core+1)^alpha —
    biases GraphSAGE-style fanout sampling toward structurally dense
    regions (the paper's motivating applications: dense-range
    identification)."""
    c = m.cores().astype(np.float64)
    w = (c + 1.0) ** alpha
    return (w / w.sum()).astype(np.float32)


def densest_region_vertices(m: CoreMaintainer, top_frac: float = 0.01
                            ) -> np.ndarray:
    """Vertices of the max-core shell (paper §1: rapid response
    targets), widened core by core until at least ``top_frac`` of the
    vertices are in."""
    c = m.cores()
    kmax = int(c.max())
    out = np.nonzero(c == kmax)[0]
    want = max(1, int(top_frac * m.n))
    k = kmax
    while out.size < want and k > 0:
        k -= 1
        out = np.nonzero(c >= k)[0]
    return out
