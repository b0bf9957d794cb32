"""The one traffic generator. A mix is a data file,
``corebench/traffic/<name>.json``, whose ``"kind"`` picks the pattern and
whose other keys are its parameters.

``"burst"`` (parameters ``batch_edges``, ``distinct_pairs``,
``trace_pairs``): batch ``2j`` removes ``batch_edges`` live edges, chunk
``j % distinct_pairs`` of one seeded permutation of the graph's edges;
batch ``2j + 1`` inserts the same edges back, which restores the edge set
and the cores. The configuration's ``graph_seed`` fixes the chunks with
the graph; the run's seed draws only their order and the vertex ids:
every seed sends the same bursts in another order.

Set-up sends one whole cycle (every chunk's pair once, ``warmup()``)
before the window. A re-inserted chunk lands in the slots its removal
freed, in the order it is sent, so the first cycle scatters the slot
table's runs of one source; after it the table repeats from cycle to
cycle, and the window measures that steady state, not the transient.
The batches are numpy ``int64 [b, 2]`` arrays made on the host before
the window: the client's data.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .graphs import sub_seed


@dataclasses.dataclass
class Batch:
    kind: str                 # "remove" | "insert"
    insert: np.ndarray        # [b, 2] int64 (may be empty)
    remove: np.ndarray        # [b, 2] int64 (may be empty)
    chunk: int                # which chunk of edges the batch moves

    @property
    def edits(self) -> int:
        return len(self.insert) + len(self.remove)


@dataclasses.dataclass
class Burst:
    chunks: list              # [b, 2] int64 arrays
    trace_pairs: int

    @property
    def distinct(self) -> int:
        return len(self.chunks)

    def warmup(self) -> list:
        """The set-up's batches: one cycle, every chunk's pair once."""
        return [self.batch(i) for i in range(2 * self.distinct)]

    def batch(self, i: int) -> Batch:
        """Batch ``i`` of the window."""
        c = (i // 2) % self.distinct
        none = np.zeros((0, 2), dtype=np.int64)
        if i % 2 == 0:
            return Batch("remove", none, self.chunks[c], c)
        return Batch("insert", self.chunks[c], none, c)

    def removed_after(self, i: int):
        """The chunk that is out of the graph after batch ``i`` (None
        after an insertion: the graph is the initial one again)."""
        return (i // 2) % self.distinct if i % 2 == 0 else None


def burst(params: dict, keys: torch.Tensor, n: int, set_seed: int,
          seed: int, perm: torch.Tensor) -> Burst:
    b = int(params["batch_edges"])
    m = keys.numel()
    pairs = min(int(params["distinct_pairs"]), m // b)
    if pairs < 1:
        raise ValueError(f"{m} edges hold no chunk of {b}")
    gen = torch.Generator(device=keys.device)
    gen.manual_seed(sub_seed(set_seed, 1))
    pick = torch.randperm(m, generator=gen, device=keys.device)
    sel = keys[pick[: pairs * b]].view(pairs, b)
    gen.manual_seed(sub_seed(seed, 4))
    sel = sel[torch.randperm(pairs, generator=gen, device=keys.device)]
    u, v = perm[sel // n], perm[sel % n]
    edges = torch.stack([u, v], -1).cpu().numpy()
    return Burst(list(edges), int(params.get("trace_pairs", 1)))


KINDS = {"burst": burst}


def make(params: dict, keys: torch.Tensor, n: int, set_seed: int,
         seed: int, perm: torch.Tensor):
    """The traffic of one mix: its edges drawn from ``keys`` (the graph
    before relabelling) with ``set_seed``, their order with ``seed``, and
    the vertex ids renamed by ``perm``."""
    return KINDS[params["kind"]](params, keys, n, set_seed, seed, perm)
