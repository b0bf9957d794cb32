"""Weighted-coreness oracle and reference harness — the port of the
reference's ``core/weighted.py``.

The production weighted engine is ``CoreMaintainer(weighted=True)``
(``core/engine.py::apply_batch_weighted``). This module is what that
engine is pinned against: the numpy peeling oracle
(``weighted_core_oracle``), a standalone single-device fixpoint
(``weighted_core_fixpoint``) and the small ``WeightedCoreMaintainer``
harness.

Weighted coreness (Zhou et al., WWW'21): the weighted degree of v is the
sum of its incident edge weights; the weighted k-core is the maximal
subgraph with weighted degree >= k inside it; integer weights give
integer cores. Iterating ``c <- min(c, H_w(c))``, with ``H_w`` the
per-vertex weighted h-index, converges to the exact weighted cores from
any upper bound: the weighted degree (decomposition), the current cores
(removals), the current cores + the total inserted weight (insertions).
"""
from __future__ import annotations

import heapq
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from .api import resolve_backend
from .graph_ops import _seg2
from .remove import weighted_core_fixpoint_pass


def weighted_core_oracle(n: int, edges: np.ndarray,
                         weights: np.ndarray) -> np.ndarray:
    """Exact weighted cores by min-weighted-degree peeling (BZ analogue)."""
    adj: List[List[Tuple[int, int]]] = [[] for _ in range(n)]
    for (u, v), w in zip(edges, weights):
        adj[int(u)].append((int(v), int(w)))
        adj[int(v)].append((int(u), int(w)))
    wdeg = np.array([sum(w for _, w in a) for a in adj], dtype=np.int64)
    heap = [(int(wdeg[v]), v) for v in range(n)]
    heapq.heapify(heap)
    removed = np.zeros(n, dtype=bool)
    core = np.zeros(n, dtype=np.int64)
    k = 0
    while heap:
        d, v = heapq.heappop(heap)
        if removed[v] or d != wdeg[v]:
            continue
        removed[v] = True
        k = max(k, int(wdeg[v]))
        core[v] = k
        for u, w in adj[v]:
            if not removed[u]:
                wdeg[u] -= w
                heapq.heappush(heap, (int(wdeg[u]), u))
    return core


def weighted_core_fixpoint(src: torch.Tensor, dst: torch.Tensor,
                           w: torch.Tensor, valid: torch.Tensor,
                           upper: torch.Tensor, n: int,
                           kernel_backend: str = "torch") -> torch.Tensor:
    """Exact weighted cores from any per-vertex upper bound, on the
    tensors' device (the engine's fixpoint without its counters)."""
    core, _, _ = weighted_core_fixpoint_pass(
        src, dst, valid, w, upper.to(torch.int32), n,
        kernel_backend=kernel_backend,
    )
    return core


class WeightedCoreMaintainer:
    """Dynamic weighted-core maintenance over COO slots (host wrapper).

    ``device=None`` means the card (and raises without one), as every
    entry point of the port; ``kernel_backend=None`` is ``"cuda"`` on a
    card and ``"torch"`` on the CPU."""

    def __init__(self, n: int, edges: np.ndarray, weights: np.ndarray,
                 capacity: int | None = None, device=None,
                 kernel_backend: Optional[str] = None):
        dev = resolve_device(device)
        self.kernel_backend = resolve_backend(kernel_backend, dev)
        edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
        weights = np.asarray(weights, dtype=np.int32)
        m = edges.shape[0]
        capacity = capacity or max(16, 2 * m)
        self.n = n
        self.capacity = capacity
        self.device = dev
        src = np.zeros(capacity, np.int32)
        dst = np.zeros(capacity, np.int32)
        wgt = np.zeros(capacity, np.int32)
        val = np.zeros(capacity, bool)
        src[:m], dst[:m], wgt[:m], val[:m] = (
            edges[:, 0], edges[:, 1], weights, True
        )
        self._put(src, dst, wgt, val)
        self.n_edges = m
        self.edge_slot = {
            (int(min(a, b)), int(max(a, b))): i
            for i, (a, b) in enumerate(edges)
        }
        wv = self.w * self.valid
        wdeg = _seg2(wv, wv, self.src, self.dst, n)
        self.core = self._fixpoint(wdeg)

    def _put(self, src, dst, wgt, val) -> None:
        t = lambda x: torch.from_numpy(x).to(self.device)  # noqa: E731
        self.src, self.dst, self.w, self.valid = t(src), t(dst), t(wgt), t(val)

    def _host(self):
        """Copies of the slot table on the host (a CPU tensor's
        ``numpy()`` would share its memory)."""
        return tuple(np.array(x.cpu())
                     for x in (self.src, self.dst, self.w, self.valid))

    def _fixpoint(self, upper: torch.Tensor) -> torch.Tensor:
        return weighted_core_fixpoint(self.src, self.dst, self.w,
                                      self.valid, upper, self.n,
                                      self.kernel_backend)

    def cores(self) -> np.ndarray:
        return self.core.cpu().numpy()

    def insert_edges(self, edges: np.ndarray, weights: np.ndarray) -> None:
        edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
        weights = np.asarray(weights, dtype=np.int32)
        base = self.n_edges
        if base + len(edges) >= self.capacity:
            raise ValueError("the harness does not grow its slot table")
        src, dst, wgt, val = self._host()
        for i, ((a, b), ww) in enumerate(zip(edges, weights)):
            key = (int(min(a, b)), int(max(a, b)))
            self.edge_slot[key] = base + i
            src[base + i], dst[base + i] = key
            wgt[base + i], val[base + i] = ww, True
        self.n_edges = base + len(edges)
        self._put(src, dst, wgt, val)
        # any vertex's weighted core can rise by at most the total
        # inserted weight (not only the endpoints')
        self.core = self._fixpoint(self.core + int(weights.sum()))

    def remove_edges(self, edges: np.ndarray) -> None:
        edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
        val = self._host()[3]
        for a, b in edges:
            slot = self.edge_slot.pop((int(min(a, b)), int(max(a, b))), None)
            if slot is not None:
                val[slot] = False
        self.valid = torch.from_numpy(val).to(self.device)
        # the current cores upper-bound the post-removal cores
        self.core = self._fixpoint(self.core)
