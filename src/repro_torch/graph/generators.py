"""Synthetic graph generators used in the paper's experiments (§5.1).

ER (Erdős–Rényi), BA (Barabási–Albert) and RMAT, mirroring the SNAP
generators the paper uses (average degree fixed by (n, m)). All are
deterministic given a seed.
"""
from __future__ import annotations

import numpy as np

from .csr import CSRGraph, build_csr


def erdos_renyi(n: int, m: int, seed: int = 0) -> CSRGraph:
    """G(n, m): m undirected edges sampled uniformly without self loops."""
    rng = np.random.default_rng(seed)
    # oversample to survive dedup/self-loop removal
    k = int(m * 1.3) + 16
    src = rng.integers(0, n, size=k, dtype=np.int64)
    dst = rng.integers(0, n, size=k, dtype=np.int64)
    edges = np.stack([src, dst], axis=1)
    edges = edges[src != dst][:m]
    return build_csr(n, edges)


def barabasi_albert(n: int, deg: int = 8, seed: int = 0) -> CSRGraph:
    """BA preferential attachment, ``deg//2`` edges per arriving vertex.

    Vectorized approximation of preferential attachment: targets are drawn
    from the current edge endpoint multiset (degree-proportional).
    """
    rng = np.random.default_rng(seed)
    k = max(1, deg // 2)
    targets = list(range(k))
    src_list = []
    dst_list = []
    endpoint_pool: list[int] = list(range(k))
    for v in range(k, n):
        pool = np.asarray(endpoint_pool, dtype=np.int64)
        picks = pool[rng.integers(0, pool.shape[0], size=k)]
        for t in np.unique(picks):
            src_list.append(v)
            dst_list.append(int(t))
            endpoint_pool.append(int(t))
            endpoint_pool.append(v)
    edges = np.stack(
        [np.asarray(src_list, dtype=np.int64), np.asarray(dst_list, dtype=np.int64)],
        axis=1,
    )
    return build_csr(n, edges)


def rmat(n_log2: int, m: int, seed: int = 0,
         a: float = 0.57, b: float = 0.19, c: float = 0.19) -> CSRGraph:
    """R-MAT recursive matrix graph (power-law, SNAP defaults)."""
    rng = np.random.default_rng(seed)
    n = 1 << n_log2
    k = int(m * 1.4) + 16
    src = np.zeros(k, dtype=np.int64)
    dst = np.zeros(k, dtype=np.int64)
    for level in range(n_log2):
        r = rng.random(k)
        in_a = r < a
        in_b = (r >= a) & (r < a + b)
        in_c = (r >= a + b) & (r < a + b + c)
        # quadrant -> (row bit, col bit)
        row_bit = (~in_a & ~in_b).astype(np.int64)  # c or d -> bottom half
        row_bit = (in_c | (~in_a & ~in_b & ~in_c)).astype(np.int64)
        col_bit = (in_b | (~in_a & ~in_b & ~in_c)).astype(np.int64)
        src = src * 2 + row_bit
        dst = dst * 2 + col_bit
    edges = np.stack([src, dst], axis=1)
    edges = edges[src != dst][:m]
    return build_csr(n, edges)


def random_edge_batch(g: CSRGraph, n_edges: int, seed: int = 0,
                      existing: bool = False) -> np.ndarray:
    """Sample a batch of edges for insertion (non-existing) or removal
    (existing). Mirrors the paper's 100k random-edge experiment setup."""
    rng = np.random.default_rng(seed)
    if existing:
        all_edges = g.edge_array()
        idx = rng.choice(all_edges.shape[0], size=min(n_edges, all_edges.shape[0]),
                         replace=False)
        return all_edges[idx]
    out = []
    seen = set()
    while len(out) < n_edges:
        u = int(rng.integers(0, g.n))
        v = int(rng.integers(0, g.n))
        if u == v:
            continue
        key = (min(u, v), max(u, v))
        if key in seen or g.has_edge(u, v):
            continue
        seen.add(key)
        out.append(key)
    return np.asarray(out, dtype=np.int64)
