"""The Graph500 Kronecker generator (``scale``, ``edgefactor``,
``initiator`` = [A, B, C]): ``edgefactor << scale`` draws, two uniform
numbers a level as in the specification's reference code, vertex ids
permuted at random; self loops and duplicates dropped, the graph taken as
undirected and unweighted.

``more`` draws further edges by the same law (Kronecker draws through the
same vertex permutation) that are absent from the graph.
"""
from __future__ import annotations

import torch

from corebench.graphs import distinct_absent, unique_keys


def _draws(scale: int, initiator, count: int, gen: torch.Generator,
           device) -> tuple:
    """``count`` Kronecker draws ``(u, v)`` before the vertex permutation."""
    a, b, c = (float(x) for x in initiator)
    ab = a + b
    c_norm = c / (1.0 - ab)
    a_norm = a / ab
    u = torch.zeros(count, dtype=torch.int64, device=device)
    v = torch.zeros(count, dtype=torch.int64, device=device)
    for level in range(scale):
        ii = torch.rand(count, generator=gen, device=device) > ab
        thresh = torch.where(ii, c_norm, a_norm)
        jj = torch.rand(count, generator=gen, device=device) > thresh
        u += ii.long() << level
        v += jj.long() << level
    return u, v


def generate(config: dict, gen: torch.Generator, device) -> dict:
    """``{"n", "keys", "vertex_perm"}``: sorted unique keys ``lo * n + hi``."""
    scale = config["scale"]
    n = 1 << scale
    u, v = _draws(scale, config["initiator"], config["edgefactor"] << scale,
                  gen, device)
    perm = torch.randperm(n, generator=gen, device=device)
    return {"n": n, "keys": unique_keys(perm[u], perm[v], n),
            "vertex_perm": perm}


def more(config: dict, graph: dict, count: int, gen: torch.Generator,
         device) -> dict:
    """``{"keys"}``: ``count`` distinct keys of further Kronecker draws,
    absent from ``graph["keys"]``, sorted."""
    n, perm = graph["n"], graph["vertex_perm"]

    def draw(k):
        u, v = _draws(config["scale"], config["initiator"], k, gen, device)
        return unique_keys(perm[u], perm[v], n)

    return {"keys": distinct_absent(draw, graph["keys"], count, gen)}
