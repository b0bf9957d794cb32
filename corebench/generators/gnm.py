"""Erdos-Renyi G(n, m) with exactly ``m`` distinct edges (``n``, ``m``):
pairs drawn uniformly, deduplicated, and a uniform ``m``-subset of the
distinct pairs kept; undirected and unweighted.

``more`` draws further uniform pairs by the same law that are absent from
the graph.
"""
from __future__ import annotations

import torch

from corebench.graphs import distinct_absent, unique_keys


def generate(config: dict, gen: torch.Generator, device) -> dict:
    """``{"n", "keys"}``: exactly ``m`` sorted unique keys ``lo * n + hi``."""
    n, m = config["n"], config["m"]
    if m > n * (n - 1) // 2:
        raise ValueError(f"G({n}, {m}) has more edges than pairs")
    keys = torch.zeros(0, dtype=torch.int64, device=device)
    while keys.numel() < m:
        k = m - keys.numel() + max(1024, m // 1000)
        u = torch.randint(0, n, (k,), generator=gen, device=device)
        v = torch.randint(0, n, (k,), generator=gen, device=device)
        keys = torch.unique(torch.cat([keys, unique_keys(u, v, n)]))
    pick = torch.randperm(keys.numel(), generator=gen, device=device)[:m]
    return {"n": n, "keys": torch.sort(keys[pick]).values}


def more(config: dict, graph: dict, count: int, gen: torch.Generator,
         device) -> dict:
    """``{"keys"}``: ``count`` distinct uniform pairs absent from
    ``graph["keys"]``, sorted."""
    n = graph["n"]
    if count > n * (n - 1) // 2 - graph["keys"].numel():
        raise ValueError(f"G({n}, {graph['keys'].numel()}) has fewer than "
                         f"{count} absent pairs")

    def draw(k):
        u = torch.randint(0, n, (k,), generator=gen, device=device)
        v = torch.randint(0, n, (k,), generator=gen, device=device)
        return unique_keys(u, v, n)

    return {"keys": distinct_absent(draw, graph["keys"], count, gen)}
