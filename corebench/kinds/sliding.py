"""``"sliding"`` (parameters ``step_edges``, ``new_edges``,
``warmup_batches``, ``trace_batches``): the last m edges of an edge
stream, m the graph's edge count.

The stream is a ring of m + ``new_edges`` distinct edges: first the
graph's edges in an age order, then ``new_edges`` edges absent from the
graph, drawn by the configuration's own generator law (``Graph.more``),
in a random order. Before any batch the graph (the ring's first m) is
live. Step ``i`` is one mixed batch: it removes the ``step_edges``
oldest live edges, ring positions ``[i s, (i + 1) s)``, and inserts the
next ``step_edges``, positions ``[m + i s, m + (i + 1) s)``, both modulo
the ring's length, so an edge re-enters ``new_edges / step_edges`` steps
after it left (with its weight, where the graph has weights). The
configuration's ``graph_seed`` fixes the ring with the graph; the run's
seed draws only the vertex ids: every seed sends the same batches.

Set-up sends the first ``warmup_batches`` steps. Each insertion fills
slots that removals of other sources freed, so the slot table's runs of
one source keep scattering through the window, as they would on a
stream; the warm-up takes the table past the first, fastest part of
that drift.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from corebench.graphs import sub_seed
from corebench.mixes import Batch


@dataclasses.dataclass
class Sliding:
    edges: np.ndarray         # [R, 2] int64: the ring, in the run's ids
    weights: Optional[np.ndarray]  # [R] int64, or None
    m: int                    # live edges
    step: int
    warmup_batches: int
    trace_batches: int
    n: int

    def _take(self, a, start: int, count: int):
        r = len(self.edges)
        s = start % r
        if s + count <= r:
            return a[s:s + count]
        return np.concatenate([a[s:], a[:s + count - r]])

    def warmup(self) -> list:
        return [self.batch(i) for i in range(self.warmup_batches)]

    def batch(self, i: int) -> Batch:
        s = self.step
        w = (None if self.weights is None
             else self._take(self.weights, self.m + i * s, s))
        return Batch("mixed", self._take(self.edges, self.m + i * s, s),
                     self._take(self.edges, i * s, s), w)

    def live(self, i: int, device) -> tuple:
        start = (i + 1) * self.step
        e = torch.as_tensor(self._take(self.edges, start, self.m),
                            device=device)
        lo, hi = torch.minimum(e[:, 0], e[:, 1]), torch.maximum(e[:, 0],
                                                               e[:, 1])
        del e
        keys, order = torch.sort(lo * self.n + hi)
        if self.weights is None:
            return keys, None
        w = torch.as_tensor(self._take(self.weights, start, self.m),
                            device=device)
        return keys, w[order]


def make(params: dict, graph, set_seed: int, seed: int) -> Sliding:
    step = int(params["step_edges"])
    extra = int(params["new_edges"])
    keys = graph.keys
    m = keys.numel()
    if not 0 < step <= min(extra, m):
        raise ValueError(f"step_edges ({step}) has to fit both the graph "
                         f"({m}) and the ring's edges beyond it ({extra})")
    gen = torch.Generator(device=keys.device)
    gen.manual_seed(sub_seed(set_seed, 5))
    age = torch.randperm(m, generator=gen, device=keys.device)
    gen.manual_seed(sub_seed(set_seed, 6))
    new, new_w = graph.more(extra, gen)
    shuffle = torch.randperm(extra, generator=gen, device=keys.device)
    ring = torch.cat([keys[age], new[shuffle]])
    edges = graph.run_edges(ring).cpu().numpy()
    del ring
    weights = None
    if graph.weights is not None:
        if new_w is None:
            raise ValueError("a weighted graph's law has to weigh new edges")
        weights = torch.cat([graph.weights[age], new_w[shuffle]]).cpu().numpy()
    return Sliding(edges, weights, m, step, int(params["warmup_batches"]),
                   int(params["trace_batches"]), graph.n)
