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

The default reference of a configuration (no ``"reference"`` key); it
judges unweighted graphs and refuses weights. ``check`` gives the four
numbers the harness holds to their limits, each exact (limit 0):

* ``core_mismatch``: vertices whose core differs from a fresh peel of the
  edge set the traffic implies, summed over the checked states;
* ``order_violations``: vertices that break the k-order certificate
  under the reference's cores and the program's labels, plus repeated
  (core, label) pairs (``order_violations``), summed over the states;
* ``edge_diff``: the final slot table's live edges against the implied
  edge set (``edge_diff``);
* ``count_mismatch``: batches whose ``n_inserted`` or ``n_removed``
  differs from the edges sent (every inserted edge is absent and every
  removed one live in the traffic).
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


def check(n: int, expected: list, live: tuple, want: tuple,
          rows: list) -> dict:
    """The four numbers (see the module's docstring). ``expected``: for
    each distinct implied edge set ``(keys, weights, states)``, with
    ``states`` the program's ``(core, label)`` at each checked state that
    should hold it; ``live``: the program's final ``(keys, weights)``;
    ``want``: the implied final ``(keys, weights)``; ``rows``: every
    batch's ``sent_insert``, ``sent_remove``, ``n_inserted``,
    ``n_removed``."""
    if want[1] is not None or any(w is not None for _, w, _ in expected):
        raise ValueError("the k-core reference judges unweighted graphs; "
                         "a weighted configuration names its own")
    core_bad = order_bad = 0
    for keys, _, states in expected:
        ref = core_numbers(keys, n)
        for core, label in states:
            core = torch.as_tensor(core, device=keys.device).long()
            label = torch.as_tensor(label, device=keys.device).long()
            core_bad += int((core != ref).sum())
            order_bad += order_violations(keys, n, ref, label)
        del ref
    count_bad = sum(int(r["n_inserted"]) != r["sent_insert"]
                    or int(r["n_removed"]) != r["sent_remove"] for r in rows)
    return {"core_mismatch": core_bad, "order_violations": order_bad,
            "edge_diff": edge_diff(live[0], want[0]),
            "count_mismatch": count_bad}
