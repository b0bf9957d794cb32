"""A configuration's graph, drawn on the device from the seed by the
generator the configuration names: ``"generator": "<name>"`` is
``corebench/generators/<name>.py``, found by name (``parts.py``).

A generator module defines

* ``generate(config, gen, device)``: a dict with ``"n"`` and ``"keys"``,
  the sorted unique undirected edge keys ``lo * n + hi`` (``lo < hi``,
  int64) of the graph's structure, optionally ``"weights"`` (positive
  int64, aligned with ``keys``) and anything ``more`` needs;
* ``more(config, graph, count, gen, device)``: ``{"keys"[, "weights"]}``,
  ``count`` further distinct edges of the same law that are absent from
  ``graph["keys"]`` (``graph`` is what ``generate`` returned).

The structure comes from the configuration's ``graph_seed``; a run's
``--seed`` draws only the vertex ids (``Graph.perm``). Everything here is
plain PyTorch. Nothing imports the system under test.
"""
from __future__ import annotations

import dataclasses
import functools
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from . import parts


def sub_seed(seed: int, tag: int) -> int:
    """A 63-bit seed for one stream (``tag``) of a run's ``--seed``."""
    state = np.random.SeedSequence([int(seed) % (1 << 64), tag])
    return int(state.generate_state(1, np.uint64)[0] >> np.uint64(1))


def unique_keys(u: torch.Tensor, v: torch.Tensor, n: int) -> torch.Tensor:
    """The sorted unique keys of the pairs ``(u, v)``, self loops dropped."""
    lo, hi = torch.minimum(u, v), torch.maximum(u, v)
    keep = lo != hi
    return torch.unique(lo[keep] * n + hi[keep])


def distinct_absent(draw, present: torch.Tensor, count: int,
                    gen: torch.Generator) -> torch.Tensor:
    """``count`` sorted distinct keys, none in the sorted ``present``: the
    unique keys ``draw(k)`` gives for ``k`` draws, gathered until there are
    enough, and a uniform ``count``-subset of them kept."""
    dev = present.device
    keys = torch.zeros(0, dtype=torch.int64, device=dev)
    stalled = 0
    while keys.numel() < count:
        new = draw(count - keys.numel() + max(1024, count // 1000))
        at = torch.searchsorted(present, new).clamp(max=present.numel() - 1)
        if present.numel():
            new = new[present[at] != new]
        grown = torch.unique(torch.cat([keys, new]))
        stalled = stalled + 1 if grown.numel() == keys.numel() else 0
        if stalled > 100:
            raise ValueError(f"the law gives fewer than {count} absent edges")
        keys = grown
    pick = torch.randperm(keys.numel(), generator=gen, device=dev)[:count]
    return torch.sort(keys[pick]).values


@dataclasses.dataclass
class Graph:
    """One run's graph: the structure (``keys``, ``weights``) in its own
    vertex ids, and ``perm``, the run's ids (vertex ``v`` is ``perm[v]``)."""
    n: int
    keys: torch.Tensor
    weights: Optional[torch.Tensor]
    perm: torch.Tensor
    config: dict
    law: object
    drawn: dict

    def more(self, count: int, gen: torch.Generator) -> tuple:
        """``(keys, weights or None)`` of ``count`` further edges of the
        generator's law, absent from the graph, in the structure's ids."""
        out = self.law.more(self.config, self.drawn, count, gen,
                            self.keys.device)
        return out["keys"], out.get("weights")

    def run_edges(self, keys: torch.Tensor) -> torch.Tensor:
        """The ``[k, 2]`` edges of structure keys, in the run's ids."""
        return torch.stack([self.perm[keys // self.n],
                            self.perm[keys % self.n]], -1)

    @functools.cached_property
    def relabelled(self) -> tuple:
        """``(keys, weights or None)`` in the run's ids, sorted by key."""
        keys, order = relabel_order(self.keys, self.perm, self.n)
        return keys, (None if self.weights is None else self.weights[order])


def generate(config: dict, seed: int, device, root: Path = parts.ROOT) -> Graph:
    """A configuration's graph for one seed: its structure from
    ``graph_seed`` by the named generator, its vertex ids from ``seed``:
    every seed gets the same graph in another vertex order."""
    gen = torch.Generator(device=device)
    gen.manual_seed(sub_seed(config["graph_seed"], 0))
    law = parts.load("generators", config["generator"], root)
    drawn = law.generate(config, gen, device)
    gen.manual_seed(sub_seed(seed, 3))
    perm = torch.randperm(drawn["n"], generator=gen, device=device)
    return Graph(n=drawn["n"], keys=drawn["keys"],
                 weights=drawn.get("weights"), perm=perm, config=config,
                 law=law, drawn=drawn)


def relabel_order(keys: torch.Tensor, perm: torch.Tensor, n: int) -> tuple:
    """``(sorted keys, order)`` of the graph with vertex ``v`` renamed
    ``perm[v]``: the renamed key ``i`` of the sorted list is that of
    ``keys[order[i]]``."""
    lo, hi = perm[keys // n], perm[keys % n]
    return torch.sort(torch.minimum(lo, hi) * n + torch.maximum(lo, hi))


def csr_arrays(keys: torch.Tensor, n: int) -> tuple:
    """Host CSR of the undirected graph: ``indptr`` int64 [n + 1] and
    ``indices`` int32 [2m], each row sorted by neighbour id."""
    lo, hi = keys // n, keys % n
    both = torch.cat([lo * n + hi, hi * n + lo]).sort().values
    src = both // n
    indptr = torch.zeros(n + 1, dtype=torch.int64, device=keys.device)
    indptr[1:] = torch.cumsum(torch.bincount(src, minlength=n), 0)
    indices = (both % n).to(torch.int32)
    return indptr.cpu().numpy(), indices.cpu().numpy()
