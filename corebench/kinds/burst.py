"""``"burst"`` (parameters ``batch_edges``, ``distinct_pairs``,
``trace_pairs``): step ``2j`` removes ``batch_edges`` live edges, chunk
``j % distinct_pairs`` of one seeded permutation of the graph's edges;
step ``2j + 1`` inserts the same edges back (with their weights, where
the graph has them), which restores the edge set and the cores. The
configuration's ``graph_seed`` fixes the chunks with the graph; the run's
seed draws only their order and the vertex ids: every seed sends the same
bursts in another order.

Set-up sends one whole cycle (every chunk's pair once, ``warmup()``)
before the window. A re-inserted chunk lands in the slots its removal
freed, in the order it is sent, so the first cycle scatters the slot
table's runs of one source; after it the table repeats from cycle to
cycle, and the window measures that steady state, not the transient.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from corebench.graphs import sub_seed
from corebench.mixes import NONE, Batch


@dataclasses.dataclass
class Burst:
    chunks: list              # [b, 2] int64 arrays
    trace_pairs: int
    initial: torch.Tensor     # the graph's sorted keys in the run's ids (host)
    weights: Optional[torch.Tensor]  # aligned with ``initial``, or None
    chunk_weights: Optional[list]    # [b] int64 arrays, or None
    n: int

    @property
    def distinct(self) -> int:
        return len(self.chunks)

    @property
    def trace_batches(self) -> int:
        return 2 * self.trace_pairs

    def warmup(self) -> list:
        """The set-up's batches: one cycle, every chunk's pair once."""
        return [self.batch(i) for i in range(2 * self.distinct)]

    def batch(self, i: int) -> Batch:
        c = (i // 2) % self.distinct
        if i % 2 == 0:
            return Batch("remove", NONE, self.chunks[c], chunk=c)
        w = None if self.chunk_weights is None else self.chunk_weights[c]
        return Batch("insert", self.chunks[c], NONE, w, chunk=c)

    def removed_after(self, i: int):
        """The chunk that is out of the graph after step ``i`` (None
        after an insertion, and before the first step: the graph is the
        initial one)."""
        return (i // 2) % self.distinct if i % 2 == 0 else None

    def live(self, i: int, device) -> tuple:
        keys = self.initial.to(device)
        weights = None if self.weights is None else self.weights.to(device)
        c = self.removed_after(i)
        if c is None:
            return keys, weights
        e = torch.as_tensor(self.chunks[c], device=device)
        lo, hi = torch.minimum(e[:, 0], e[:, 1]), torch.maximum(e[:, 0],
                                                               e[:, 1])
        keep = ~torch.isin(keys, lo * self.n + hi)
        return keys[keep], (None if weights is None else weights[keep])


def make(params: dict, graph, set_seed: int, seed: int) -> Burst:
    b = int(params["batch_edges"])
    keys, n, perm = graph.keys, graph.n, graph.perm
    m = keys.numel()
    pairs = min(int(params["distinct_pairs"]), m // b)
    if pairs < 1:
        raise ValueError(f"{m} edges hold no chunk of {b}")
    gen = torch.Generator(device=keys.device)
    gen.manual_seed(sub_seed(set_seed, 1))
    pick = torch.randperm(m, generator=gen, device=keys.device)
    sel = pick[: pairs * b].view(pairs, b)
    gen.manual_seed(sub_seed(seed, 4))
    sel = sel[torch.randperm(pairs, generator=gen, device=keys.device)]
    k = keys[sel]
    u, v = perm[k // n], perm[k % n]
    edges = torch.stack([u, v], -1).cpu().numpy()
    chunk_w = None
    if graph.weights is not None:
        chunk_w = list(graph.weights[sel].cpu().numpy())
    initial, weights = graph.relabelled
    return Burst(list(edges), int(params.get("trace_pairs", 1)),
                 initial.cpu(), None if weights is None else weights.cpu(),
                 chunk_w, n)
