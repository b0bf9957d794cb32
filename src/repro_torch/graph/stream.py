"""Temporal edge streams — the paper's dynamic-graph workload.

Generates (or replays) timestamped edge events and yields fixed-size
batches of insertions/removals, the input format of the streaming core
maintenance service (examples/stream_maintenance.py).
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional, Tuple

import numpy as np

from .csr import CSRGraph


@dataclasses.dataclass
class EdgeEvent:
    edges: np.ndarray   # [b, 2] — insertions ("insert"/"mixed"), removals ("remove")
    kind: str           # "insert" | "remove" | "mixed"
    t: int
    removals: Optional[np.ndarray] = None  # [b', 2], only for kind="mixed"

    @property
    def n_edits(self) -> int:
        return len(self.edges) + (
            len(self.removals) if self.removals is not None else 0
        )


class _LiveEdges:
    """A live edge set as sorted int64 keys ``u * n + v``: the order of
    ``sorted()`` over the ``(u, v)`` tuples the reference keeps in a set,
    membership by binary search, and no per-batch sort (inserting into
    and deleting from the sorted array are linear). At 15 M edges the
    reference's ``sorted(live)`` a batch is the slow part of a stream."""

    def __init__(self, edges: np.ndarray, n: int):
        self.n = n
        self.keys = np.unique(self._key(np.asarray(edges, np.int64)))

    def _key(self, edges: np.ndarray) -> np.ndarray:
        return edges.reshape(-1, 2)[:, 0] * self.n + edges.reshape(-1, 2)[:, 1]

    def __len__(self) -> int:
        return self.keys.shape[0]

    def __contains__(self, edge) -> bool:
        k = edge[0] * self.n + edge[1]
        i = np.searchsorted(self.keys, k)
        return bool(i < self.keys.shape[0] and self.keys[i] == k)

    def take(self, idx: np.ndarray) -> np.ndarray:
        """The edges at sorted positions ``idx`` (in that order), removed
        from the set; ``[len(idx), 2]`` int64."""
        k = self.keys[idx]
        self.keys = np.delete(self.keys, idx)
        return np.stack([k // self.n, k % self.n], axis=1)

    def add(self, edges) -> None:
        k = np.sort(self._key(np.asarray(edges, np.int64)))
        self.keys = np.insert(self.keys, np.searchsorted(self.keys, k), k)


def synthetic_stream(
    g: CSRGraph,
    n_batches: int,
    batch_size: int,
    p_insert: float = 0.5,
    seed: int = 0,
) -> Iterator[EdgeEvent]:
    """Random insert/remove batches against a live edge set (paper §5.2:
    edges are first removed then inserted; here interleaved)."""
    rng = np.random.default_rng(seed)
    live = _LiveEdges(g.edge_array(), g.n)
    n = g.n
    for t in range(n_batches):
        if rng.random() < p_insert or len(live) < batch_size:
            batch = []
            picked = set()
            while len(batch) < batch_size:
                u, v = rng.integers(0, n, size=2)
                key = (int(min(u, v)), int(max(u, v)))
                if u == v or key in picked or key in live:
                    continue
                picked.add(key)
                batch.append(key)
            live.add(batch)
            yield EdgeEvent(np.asarray(batch, dtype=np.int64), "insert", t)
        else:
            take = rng.choice(len(live), size=batch_size, replace=False)
            yield EdgeEvent(live.take(take), "remove", t)


def mixed_stream(
    g: CSRGraph,
    n_batches: int,
    batch_size: int,
    p_insert: float = 0.5,
    seed: int = 0,
) -> Iterator[EdgeEvent]:
    """Mixed insert+remove batches — the paper's burst workload in the
    format the unified engine consumes in ONE compiled call per batch.

    Each event carries ~``p_insert * batch_size`` fresh insertions in
    ``edges`` and the rest as removals of currently-live edges in
    ``removals``. Removed edges return to the candidate pool, so an edge
    removed at t may be re-inserted at a later t (the re-insertion path
    the engine tests pin down)."""
    rng = np.random.default_rng(seed)
    live = _LiveEdges(g.edge_array(), g.n)
    n = g.n
    max_edges = n * (n - 1) // 2
    for t in range(n_batches):
        n_ins = int(round(batch_size * p_insert))
        # clamp to what the graph can absorb: never sample more fresh
        # edges than are absent (dense/small graphs would spin forever)
        n_ins = min(n_ins, max_edges - len(live))
        n_rm = min(batch_size - n_ins, len(live))
        inserts: list = []
        picked = set()
        while len(inserts) < n_ins:
            u, v = rng.integers(0, n, size=2)
            key = (int(min(u, v)), int(max(u, v)))
            if u == v or key in picked or key in live:
                continue
            picked.add(key)
            inserts.append(key)
        take = rng.choice(len(live), size=n_rm, replace=False)
        removals = live.take(take)
        live.add(inserts)
        yield EdgeEvent(
            np.asarray(inserts, dtype=np.int64).reshape(-1, 2),
            "mixed",
            t,
            removals=removals.reshape(-1, 2),
        )


def churn_stream(
    g: CSRGraph,
    n_batches: int,
    batch_size: int,
    p_reinsert: float = 0.6,
    same_batch_roundtrip: bool = True,
    dirty: bool = True,
    seed: int = 0,
) -> Iterator[EdgeEvent]:
    """Balanced 50/50 insert/remove churn with adversarial recycling
    pressure — the steady-state workload the in-program free-list
    allocator (core/engine.py) exists for.

    Per batch: ``batch_size // 2`` removals of live edges, then the same
    number of insertions of which ~``p_reinsert`` re-insert RECENTLY
    removed edges (landing on slots the recycler just reclaimed; the
    rest are fresh absent edges). With ``same_batch_roundtrip`` one of
    the batch's own removals is re-inserted in the SAME event (the slot
    is freed and refilled inside one compiled program). With ``dirty``
    each event also carries rows every engine must mask on device: a
    self-loop, an in-batch duplicate, a duplicate of a live edge, and a
    removal of an absent edge. Live edge count is exactly flat across
    every event — the capacity/high-water invariant tests key on this.

    Consumers tracking the live set must apply removals first, then
    deduped insertions (``CoreMaintainer.apply_batch`` order).
    """
    rng = np.random.default_rng(seed)
    live = {tuple(e) for e in g.edge_array().tolist()}
    pool: list = []  # recently removed candidates for re-insertion
    n = g.n
    max_edges = n * (n - 1) // 2
    for t in range(n_batches):
        k = min(batch_size // 2, len(live))
        lst = sorted(live)
        take = rng.choice(len(lst), size=k, replace=False)
        removals = [lst[i] for i in take]
        live.difference_update(removals)
        inserts: list = []
        if same_batch_roundtrip and removals:
            inserts.append(removals[0])  # removed and re-inserted at t
        while pool and len(inserts) < int(round(k * p_reinsert)):
            e = pool.pop(int(rng.integers(0, len(pool))))
            if e not in live and e not in inserts:
                inserts.append(e)
        # clamp to the absent pairs actually available so the rejection
        # loop terminates on (near-)complete graphs; the removals above
        # guarantee at least k absent pairs, so live stays exactly flat
        # on any graph that is not literally full
        k_ins = min(k, max_edges - len(live))
        while len(inserts) < k_ins:
            u, v = rng.integers(0, n, size=2)
            key = (int(min(u, v)), int(max(u, v)))
            if u == v or key in live or key in inserts:
                continue
            inserts.append(key)
        pool.extend(e for e in removals if e not in inserts)
        live.update(inserts)
        ins = np.asarray(inserts, dtype=np.int64).reshape(-1, 2)
        rm = np.asarray(removals, dtype=np.int64).reshape(-1, 2)
        if dirty:
            garnish = [[3 % n, 3 % n]]  # self-loop
            if inserts:
                garnish.append(list(inserts[-1]))  # in-batch duplicate
            if live:
                garnish.append(list(next(iter(live))))  # dup of live edge
            ins = np.concatenate(
                [ins, np.asarray(garnish, dtype=np.int64)]
            )
            absent_rm = None  # removal of an absent edge is a no-op
            for _ in range(20):
                u, v = rng.integers(0, n, size=2)
                key = (int(min(u, v)), int(max(u, v)))
                if u != v and key not in live:
                    absent_rm = key
                    break
            if absent_rm is not None:
                rm = np.concatenate(
                    [rm, np.asarray([absent_rm], dtype=np.int64)]
                )
        yield EdgeEvent(ins, "mixed", t, removals=rm)


def _validated_temporal(edges_with_time) -> np.ndarray:
    """Normalize a temporal edge list to an int64 [m, 3] array, failing
    loudly on the malformed inputs that used to slip through (a [m, 2]
    list silently replayed vertex ids as timestamps; float timestamps
    truncated)."""
    arr = np.asarray(edges_with_time)
    if arr.ndim != 2 or arr.shape[1] != 3:
        raise ValueError(
            f"temporal edge list must have shape [m, 3] (u, v, t), got "
            f"{arr.shape}"
        )
    if not np.issubdtype(arr.dtype, np.integer):
        raise ValueError(
            f"temporal edge list must have an integer dtype (u, v, t), "
            f"got {arr.dtype} — cast timestamps explicitly rather than "
            "letting them truncate silently"
        )
    return arr.astype(np.int64)


def temporal_replay(
    edges_with_time: np.ndarray, batch_size: int
) -> Iterator[EdgeEvent]:
    """Replay a [m, 3] (u, v, t) temporal edge list in timestamp order as
    insertion batches (KONECT-style temporal graphs).

    Ordering guarantee: the sort is STABLE, so rows sharing a timestamp
    replay in input order — a given edge list always produces the same
    batches. That guarantee cuts both ways: when the input is NOT
    already time-sorted and a run of equal timestamps straddles a batch
    boundary, which of the tied edges land in the earlier batch is an
    artifact of input file order rather than of time, so this replay
    refuses (``ValueError``) instead of silently committing one of the
    m! equally-valid batchings. Pre-sort the list (any tie order you
    pick is then YOUR deterministic choice) or use a ``batch_size``
    that keeps ties together."""
    arr = _validated_temporal(edges_with_time)
    if batch_size < 1:
        raise ValueError(f"batch_size must be >= 1, got {batch_size}")
    t = arr[:, 2]
    presorted = bool(np.all(t[:-1] <= t[1:]))
    order = np.argsort(t, kind="stable")
    ordered = arr[order]
    ts = ordered[:, 2]
    if not presorted and len(ordered) > batch_size:
        bounds = np.arange(batch_size, len(ordered), batch_size)
        cross = bounds[ts[bounds - 1] == ts[bounds]]
        if cross.size:
            raise ValueError(
                "temporal_replay: unsorted input has equal-timestamp "
                f"ties (t={int(ts[cross[0]])}) crossing a batch "
                "boundary — the stable sort keeps INPUT order within a "
                "timestamp, so the batch split would be an artifact of "
                "file order, not time; pre-sort the edge list or pick a "
                "batch_size that keeps ties in one batch"
            )
    for i in range(0, len(ordered), batch_size):
        chunk = ordered[i : i + batch_size]
        yield EdgeEvent(chunk[:, :2].astype(np.int64), "insert",
                        int(chunk[-1, 2]))


def sliding_window_stream(
    edges_with_time: np.ndarray,
    window: int,
    stride: Optional[int] = None,
) -> Iterator[EdgeEvent]:
    """Sliding-window expiry over a [m, 3] (u, v, t) temporal edge list
    — the workload where REMOVALS are structural, not sampled: each
    step advances time by ``stride`` and yields one mixed event whose
    insertions are the edges arriving in the new stride and whose
    removals are the live edges older than ``window`` (bulk expiry by
    age, the Li et al. dynamic-graph evaluation pattern).

    Semantics (matching ``CoreMaintainer.apply_batch``'s
    removals-first order):

    * the live set is keyed on the undirected pair; a re-arrival of a
      live edge REFRESHES its age (the event does not re-insert it —
      the engine would no-op the duplicate anyway) and a re-arrival of
      an edge expiring in the same step round-trips through one event
      (removal + insertion, the same-batch recycling path);
    * self-loops are dropped; in-step duplicate pairs insert once and
      age by their LATEST arrival;
    * events with neither arrivals nor expiries are elided; the stream
      drains until every edge has expired, so the final live set is
      empty and Σ removals == Σ insertions.

    Timestamps only gate WHICH step an edge joins, so unlike
    ``temporal_replay`` the equal-timestamp tie order never changes the
    output — the input needs no pre-sorting (the stable sort plus
    per-step set semantics make the events input-order independent up
    to in-step insertion order)."""
    arr = _validated_temporal(edges_with_time)
    if window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if stride is None:
        stride = window
    if stride < 1:
        raise ValueError(f"stride must be >= 1, got {stride}")
    order = np.argsort(arr[:, 2], kind="stable")
    ordered = arr[order]
    m = len(ordered)
    if m == 0:
        return
    live: dict = {}  # (u, v) -> latest arrival time
    i = 0
    hi = int(ordered[0, 2]) + stride  # step covers arrivals with t < hi
    while i < m or live:
        cutoff = hi - window
        removals = [e for e, ta in live.items() if ta <= cutoff]
        for e in removals:
            del live[e]
        inserts: list = []
        while i < m and int(ordered[i, 2]) < hi:
            u, v, t = (int(x) for x in ordered[i])
            i += 1
            if u == v:
                continue
            key = (min(u, v), max(u, v))
            if key not in live and key not in inserts:
                inserts.append(key)
            live[key] = max(live.get(key, t), t)
        if inserts or removals:
            yield EdgeEvent(
                np.asarray(inserts, dtype=np.int64).reshape(-1, 2),
                "mixed",
                hi,
                removals=np.asarray(
                    removals, dtype=np.int64).reshape(-1, 2),
            )
        hi += stride
