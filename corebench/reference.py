"""The plain reference that decides ``correct``: k-core numbers by a
level-synchronous peel, the k-order certificate, and the live edge set,
all worked out again from the edges the benchmark generated.

Plain PyTorch on whatever device it is given. It imports nothing of the
system under test and takes nothing the system made: the system's cores,
labels and live edges are only read here to be judged.

The peel (Batagelj-Zaversnik's order, level-synchronous as in ParK):
``k`` starts at 0; every wave removes all live vertices of degree <= k
and gives them core k; when none is left, ``k`` rises to the least live
degree. Each wave touches only the removed vertices' adjacency lists.
"""
from __future__ import annotations

import torch


def csr(keys: torch.Tensor, n: int) -> tuple:
    """``(indptr [n + 1], indices [2m])`` of the undirected edge keys
    ``lo * n + hi``."""
    lo, hi = keys // n, keys % n
    src = torch.cat([lo, hi])
    dst = torch.cat([hi, lo])
    order = torch.argsort(src, stable=True)
    indptr = torch.zeros(n + 1, dtype=torch.int64, device=keys.device)
    indptr[1:] = torch.cumsum(torch.bincount(src, minlength=n), 0)
    return indptr, dst[order]


def core_numbers(keys: torch.Tensor, n: int, with_order: bool = False):
    """Exact core number of every vertex (int64 [n]); with ``with_order``
    also a k-order: the wave that removed each vertex, then its id."""
    dev = keys.device
    indptr, indices = csr(keys, n)
    rowlen = indptr[1:] - indptr[:-1]
    deg = rowlen.clone()
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    core = torch.zeros(n, dtype=torch.int64, device=dev)
    wave = torch.zeros(n, dtype=torch.int64, device=dev)
    n_alive = n
    k = w = 0
    while n_alive:
        front = torch.nonzero(alive & (deg <= k)).flatten()
        if front.numel() == 0:
            k = int(deg[alive].min())
            continue
        core[front] = k
        wave[front] = w
        w += 1
        alive[front] = False
        n_alive -= front.numel()
        counts = rowlen[front]
        total = int(counts.sum())
        if total == 0:
            continue
        starts = torch.repeat_interleave(indptr[front], counts)
        offset = torch.arange(total, device=dev) - torch.repeat_interleave(
            torch.cumsum(counts, 0) - counts, counts)
        nbr = indices[starts + offset]
        nbr = nbr[alive[nbr]]
        deg.index_add_(0, nbr, torch.full_like(nbr, -1))
    if with_order:
        return core, wave * n + torch.arange(n, device=dev)
    return core


def order_violations(keys: torch.Tensor, n: int, core: torch.Tensor,
                     label: torch.Tensor) -> int:
    """Vertices that break the k-order certificate under ``core`` and the
    judged ``label``, plus vertices whose (core, label) pair repeats.

    The certificate: in the order by (core, label), every vertex has at
    most ``core(v)`` neighbours after it (higher core, or the same core
    and a larger label)."""
    lo, hi = keys // n, keys % n
    core = core.long()
    label = label.long()
    c_lo, c_hi = core[lo], core[hi]
    same = c_lo == c_hi
    hi_after = (c_hi > c_lo) | (same & (label[hi] > label[lo]))
    lo_after = (c_lo > c_hi) | (same & (label[lo] > label[hi]))
    after = (torch.bincount(lo[hi_after], minlength=n)
             + torch.bincount(hi[lo_after], minlength=n))
    bad = int((after > core).sum())
    by_label = torch.argsort(label, stable=True)
    order = by_label[torch.argsort(core[by_label], stable=True)]
    c, lab = core[order], label[order]
    repeats = int(((c[1:] == c[:-1]) & (lab[1:] == lab[:-1])).sum())
    return bad + repeats


def edge_diff(live: torch.Tensor, want: torch.Tensor) -> int:
    """Size of the symmetric difference between a judged multiset of live
    edge keys and the expected set, with each repeated live key counted."""
    live = torch.sort(live).values
    repeats = int((live[1:] == live[:-1]).sum()) if live.numel() else 0
    live = torch.unique_consecutive(live)
    missing = int((~torch.isin(want, live)).sum())
    extra = int((~torch.isin(live, want)).sum())
    return repeats + missing + extra


def remove_keys(keys: torch.Tensor, gone: torch.Tensor) -> torch.Tensor:
    """The sorted key set without ``gone``."""
    return keys[~torch.isin(keys, gone)]


def edge_keys(edges, n: int, device) -> torch.Tensor:
    """Keys ``lo * n + hi`` of an ``[b, 2]`` edge array."""
    e = torch.as_tensor(edges, dtype=torch.int64, device=device)
    lo = torch.minimum(e[:, 0], e[:, 1])
    hi = torch.maximum(e[:, 0], e[:, 1])
    return torch.sort(lo * n + hi).values
