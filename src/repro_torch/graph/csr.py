"""Graph containers: numpy CSR for oracles, generators and stream
replay, and the device-side COO edge slots.

The port of the reference's ``graph/csr.py``: ``CSRGraph``,
``build_csr``, ``add_edges_csr``, ``remove_edges_csr`` and the padded
neighbour matrix ``ELLGraph`` / ``ell_from_csr`` that the ELL kernels of
``kernels/segment_ell.py`` read, copied in numpy so the port never
imports the JAX package; and ``COOEdges`` / ``coo_from_csr``, the
fixed-capacity edge slots as torch tensors (a plain dataclass: torch
needs no pytree registration). ``core.api.CoreMaintainer`` keeps its own
slot table.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..device import resolve_device


# ---------------------------------------------------------------------------
# numpy CSR (host side)
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class CSRGraph:
    """Undirected graph in CSR form. Each undirected edge appears twice."""

    n: int
    indptr: np.ndarray  # [n + 1] int64
    indices: np.ndarray  # [2m] int32

    @property
    def m(self) -> int:
        return int(self.indices.shape[0] // 2)

    def degrees(self) -> np.ndarray:
        return np.diff(self.indptr).astype(np.int64)

    def neighbors(self, v: int) -> np.ndarray:
        return self.indices[self.indptr[v]: self.indptr[v + 1]]

    def has_edge(self, u: int, v: int) -> bool:
        return bool(np.any(self.neighbors(u) == v))

    def edge_array(self) -> np.ndarray:
        """Unique undirected edges as an [m, 2] array with src < dst."""
        src = np.repeat(np.arange(self.n), np.diff(self.indptr))
        dst = self.indices
        keep = src < dst
        return np.stack([src[keep], dst[keep]], axis=1).astype(np.int64)


def build_csr(n: int, edges: np.ndarray) -> CSRGraph:
    """Build a CSR graph from an [m, 2] array of undirected edges.

    Self loops and duplicate edges are removed (paper §5.1 preprocessing).
    """
    edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
    if edges.size:
        lo = np.minimum(edges[:, 0], edges[:, 1])
        hi = np.maximum(edges[:, 0], edges[:, 1])
        keep = lo != hi
        lo, hi = lo[keep], hi[keep]
        key = lo * n + hi
        _, first = np.unique(key, return_index=True)
        lo, hi = lo[first], hi[first]
    else:
        lo = hi = np.zeros((0,), dtype=np.int64)
    src = np.concatenate([lo, hi])
    dst = np.concatenate([hi, lo])
    order = np.argsort(src, kind="stable")
    src, dst = src[order], dst[order]
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.add.at(indptr, src + 1, 1)
    np.cumsum(indptr, out=indptr)
    return CSRGraph(n=n, indptr=indptr, indices=dst.astype(np.int32))


def remove_edges_csr(g: CSRGraph, edges: np.ndarray) -> CSRGraph:
    """Return a new CSR graph with the given undirected edges removed."""
    cur = g.edge_array()
    n = g.n
    cur_key = cur[:, 0] * n + cur[:, 1]
    edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
    lo = np.minimum(edges[:, 0], edges[:, 1])
    hi = np.maximum(edges[:, 0], edges[:, 1])
    rm_key = lo * n + hi
    keep = ~np.isin(cur_key, rm_key)
    return build_csr(n, cur[keep])


def add_edges_csr(g: CSRGraph, edges: np.ndarray) -> CSRGraph:
    cur = g.edge_array()
    edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
    return build_csr(g.n, np.concatenate([cur, edges], axis=0))


# ---------------------------------------------------------------------------
# COO dynamic edge slots (device side)
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class COOEdges:
    """Fixed-capacity undirected edge slots.

    Attributes
    ----------
    n:        number of vertices (static).
    src, dst: int32 [capacity]; meaningful where ``valid``.
    valid:    bool [capacity].
    n_edges:  int32 scalar — number of slots ever written (free slots are
              ``[n_edges:]``; removed slots are tombstoned, compaction is a
              host-side maintenance action).
    """

    n: int
    src: torch.Tensor
    dst: torch.Tensor
    valid: torch.Tensor
    n_edges: torch.Tensor

    @property
    def capacity(self) -> int:
        return int(self.src.shape[0])


def coo_from_csr(g: CSRGraph, capacity: Optional[int] = None,
                 device=None) -> COOEdges:
    """The graph's edges (``g.edge_array()``, src < dst) in the first
    ``m`` slots of a table of ``capacity`` slots (default ``2 m``, at
    least 1), on ``device`` (``None``: the card)."""
    dev = resolve_device(device)
    edges = g.edge_array()
    m = edges.shape[0]
    capacity = capacity or max(1, int(m * 2))
    if capacity < m:
        raise ValueError(f"capacity {capacity} < m {m}")
    src = torch.zeros(capacity, dtype=torch.int32)
    dst = torch.zeros(capacity, dtype=torch.int32)
    valid = torch.zeros(capacity, dtype=torch.bool)
    src[:m] = torch.from_numpy(edges[:, 0].astype(np.int32))
    dst[:m] = torch.from_numpy(edges[:, 1].astype(np.int32))
    valid[:m] = True
    return COOEdges(n=g.n, src=src.to(dev), dst=dst.to(dev),
                    valid=valid.to(dev),
                    n_edges=torch.tensor(m, dtype=torch.int32, device=dev))


# ---------------------------------------------------------------------------
# ELL padded neighbor matrix
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class ELLGraph:
    """Padded neighbor lists: ``nbrs[v, i]`` is the i-th neighbor of v.

    Padding entries hold ``n`` (one-past-last vertex id) so gathers can index
    a sentinel row appended to per-vertex value arrays.
    """

    n: int
    max_deg: int
    nbrs: np.ndarray  # [n, max_deg] int32
    deg: np.ndarray  # [n] int32


def ell_from_csr(g: CSRGraph, max_deg: Optional[int] = None) -> ELLGraph:
    """The reference's arrays exactly (pad = n, neighbours in CSR order,
    ``max_deg`` defaults to the graph's, at least 1), written in one
    scatter instead of a Python loop over the vertices."""
    deg = g.degrees().astype(np.int32)
    md = int(deg.max()) if deg.size else 0
    max_deg = max_deg or max(md, 1)
    if md > max_deg:
        raise ValueError(f"max_deg {max_deg} < graph max degree {md}")
    nbrs = np.full((g.n, max_deg), g.n, dtype=np.int32)
    row = np.repeat(np.arange(g.n, dtype=np.int64), deg)
    col = np.arange(row.shape[0], dtype=np.int64) - g.indptr[row]
    nbrs[row, col] = g.indices[: row.shape[0]]
    return ELLGraph(n=g.n, max_deg=max_deg, nbrs=nbrs, deg=deg)
