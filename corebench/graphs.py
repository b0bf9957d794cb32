"""The benchmark's graph generators: edges drawn on the device from the
seed, deduplicated there, and returned as sorted unique undirected edge
keys ``lo * n + hi`` (``lo < hi``, int64).

A configuration names its generator by ``"generator"``:

* ``"kronecker"``: the Graph500 Kronecker generator (``scale``,
  ``edgefactor``, ``initiator`` = [A, B, C]): ``edgefactor << scale``
  draws, two uniform numbers a level as in the specification's reference
  code, vertex ids permuted at random; self loops and duplicates dropped.
* ``"gnm"``: Erdos-Renyi G(n, m) with exactly ``m`` distinct edges: pairs
  drawn uniformly, deduplicated, and a uniform ``m``-subset of the
  distinct pairs kept.

Everything here is plain PyTorch. Nothing imports the system under test.
"""
from __future__ import annotations

import numpy as np
import torch


def sub_seed(seed: int, tag: int) -> int:
    """A 63-bit seed for one stream (``tag``) of a run's ``--seed``."""
    state = np.random.SeedSequence([int(seed) % (1 << 64), tag])
    return int(state.generate_state(1, np.uint64)[0] >> np.uint64(1))


def _unique_keys(u: torch.Tensor, v: torch.Tensor, n: int) -> torch.Tensor:
    lo, hi = torch.minimum(u, v), torch.maximum(u, v)
    keep = lo != hi
    return torch.unique(lo[keep] * n + hi[keep])


def kronecker(scale: int, edgefactor: int, initiator, gen: torch.Generator,
              device) -> tuple:
    """Graph500 Kronecker edges: ``(n, keys)``."""
    a, b, c = (float(x) for x in initiator)
    n = 1 << scale
    draws = edgefactor << scale
    ab = a + b
    c_norm = c / (1.0 - ab)
    a_norm = a / ab
    u = torch.zeros(draws, dtype=torch.int64, device=device)
    v = torch.zeros(draws, dtype=torch.int64, device=device)
    for level in range(scale):
        ii = torch.rand(draws, generator=gen, device=device) > ab
        thresh = torch.where(ii, c_norm, a_norm)
        jj = torch.rand(draws, generator=gen, device=device) > thresh
        u += ii.long() << level
        v += jj.long() << level
    perm = torch.randperm(n, generator=gen, device=device)
    return n, _unique_keys(perm[u], perm[v], n)


def gnm(n: int, m: int, gen: torch.Generator, device) -> tuple:
    """G(n, m) edges: ``(n, keys)`` with exactly ``m`` distinct keys."""
    if m > n * (n - 1) // 2:
        raise ValueError(f"G({n}, {m}) has more edges than pairs")
    keys = torch.zeros(0, dtype=torch.int64, device=device)
    while keys.numel() < m:
        k = m - keys.numel() + max(1024, m // 1000)
        u = torch.randint(0, n, (k,), generator=gen, device=device)
        v = torch.randint(0, n, (k,), generator=gen, device=device)
        keys = torch.unique(torch.cat([keys, _unique_keys(u, v, n)]))
    pick = torch.randperm(keys.numel(), generator=gen, device=device)[:m]
    return n, torch.sort(keys[pick]).values


def generate(config: dict, seed: int, device) -> tuple:
    """``(n, keys, perm)`` of a configuration's graph for one seed.

    The graph's structure comes from the configuration's ``graph_seed``;
    ``perm`` is the vertex relabelling that ``seed`` draws, which
    ``relabel`` applies: every seed gets the same graph in another vertex
    order."""
    gen = torch.Generator(device=device)
    gen.manual_seed(sub_seed(config["graph_seed"], 0))
    kind = config["generator"]
    if kind == "kronecker":
        n, keys = kronecker(config["scale"], config["edgefactor"],
                            config["initiator"], gen, device)
    elif kind == "gnm":
        n, keys = gnm(config["n"], config["m"], gen, device)
    else:
        raise ValueError(f"unknown generator {kind!r}")
    gen.manual_seed(sub_seed(seed, 3))
    return n, keys, torch.randperm(n, generator=gen, device=device)


def relabel(keys: torch.Tensor, perm: torch.Tensor, n: int) -> torch.Tensor:
    """The sorted keys of the graph with vertex ``v`` renamed ``perm[v]``."""
    lo, hi = perm[keys // n], perm[keys % n]
    return torch.sort(torch.minimum(lo, hi) * n + torch.maximum(lo, hi)).values


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
