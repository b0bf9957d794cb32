"""Sequential oracles: BZ decomposition, Simplified-Order (OI/OR) and
Traversal (TI/TR) core maintenance.

These reproduce the paper's sequential baselines faithfully (Algorithms 1,
7-10) and serve as the correctness oracle for the parallel JAX
implementations.  The Order-Maintenance (OM) list is implemented as a
linked list with integer gap labels and amortized per-level renumbering —
the same O(1) ``Order(x, y)`` interface the paper's two-level OM provides
(the two-level/group refinement only changes relabel constants; see
docs/DESIGN.md §6).

All maintainers expose instrumentation: ``last_v_plus`` / ``last_v_star``
(sizes of the searched and changed sets for the most recent edge), which
back the paper's Figure 5 / Table 2 style benchmarks.
"""
from __future__ import annotations

import heapq
from collections import deque
from typing import Dict, List, Sequence, Set, Tuple

import numpy as np

from ..graph.csr import CSRGraph

_GAP = 1 << 20  # label gap for fresh renumbers


# ---------------------------------------------------------------------------
# BZ core decomposition (Algorithm 1), "small degree first" tie-breaking
# ---------------------------------------------------------------------------
def bz_core_decomposition(
    n: int, adj: Sequence[Set[int]]
) -> Tuple[np.ndarray, List[int]]:
    """Return (core numbers, peeling order) for an adjacency-set graph.

    Ties among equal current degree are broken by (original degree, id) —
    the paper's best-performing "small degree first" strategy.
    """
    deg0 = np.array([len(a) for a in adj], dtype=np.int64)
    d = deg0.copy()
    heap = [(int(d[v]), int(deg0[v]), v) for v in range(n)]
    heapq.heapify(heap)
    removed = np.zeros(n, dtype=bool)
    core = np.zeros(n, dtype=np.int64)
    order: List[int] = []
    k = 0
    while heap:
        dv, _, v = heapq.heappop(heap)
        if removed[v] or dv != d[v]:
            continue  # stale heap entry
        removed[v] = True
        k = max(k, int(d[v]))
        core[v] = k
        order.append(v)
        for w in adj[v]:
            if not removed[w] and d[w] > d[v]:
                d[w] -= 1
                heapq.heappush(heap, (int(d[w]), int(deg0[w]), w))
    return core, order


def bz_from_csr(g: CSRGraph) -> np.ndarray:
    adj = [set(g.neighbors(v).tolist()) for v in range(g.n)]
    core, _ = bz_core_decomposition(g.n, adj)
    return core


# ---------------------------------------------------------------------------
# Order-maintenance list (per core level)
# ---------------------------------------------------------------------------
class _LevelList:
    """Ordered list of vertices with integer labels; head/tail sentinels are
    label 0 and 2**62. ``Order(x, y)`` is a label comparison."""

    __slots__ = ("nxt", "prv", "label", "ver")

    def __init__(self) -> None:
        self.nxt: Dict[object, object] = {"H": "T"}
        self.prv: Dict[object, object] = {"T": "H"}
        self.label: Dict[object, int] = {"H": 0, "T": 1 << 62}
        self.ver = 0  # bumped on renumber (paper Appendix E version counter)

    def __contains__(self, v: int) -> bool:
        return v in self.label

    def _renumber(self) -> None:
        self.ver += 1
        x = self.nxt["H"]
        i = 1
        while x != "T":
            self.label[x] = i * _GAP
            i += 1
            x = self.nxt[x]

    def insert_after(self, x: object, y: int) -> None:
        nx = self.nxt[x]
        lab = (self.label[x] + self.label[nx]) // 2
        if lab == self.label[x]:  # gap exhausted -> relabel (amortized)
            self._renumber()
            nx = self.nxt[x]
            lab = (self.label[x] + self.label[nx]) // 2
            assert lab != self.label[x]
        self.nxt[x] = y
        self.prv[y] = x
        self.nxt[y] = nx
        self.prv[nx] = y
        self.label[y] = lab

    def append_tail(self, y: int) -> None:
        self.insert_after(self.prv["T"], y)

    def insert_head(self, y: int) -> None:
        self.insert_after("H", y)

    def delete(self, x: int) -> None:
        p, nx = self.prv[x], self.nxt[x]
        self.nxt[p] = nx
        self.prv[nx] = p
        del self.nxt[x], self.prv[x], self.label[x]

    def iter(self):
        x = self.nxt["H"]
        while x != "T":
            yield x
            x = self.nxt[x]


class _KOrder:
    """The global k-order O = O_0 O_1 O_2 ... (one level list per core)."""

    def __init__(self, core: np.ndarray, order: List[int]) -> None:
        self.levels: Dict[int, _LevelList] = {}
        self.core = core
        for v in order:  # peel order within each level
            self.level(int(core[v])).append_tail(v)

    def level(self, k: int) -> _LevelList:
        if k not in self.levels:
            self.levels[k] = _LevelList()
        return self.levels[k]

    def lt(self, u: int, v: int) -> bool:
        """u strictly precedes v in k-order."""
        cu, cv = int(self.core[u]), int(self.core[v])
        if cu != cv:
            return cu < cv
        lab = self.levels[cu].label
        return lab[u] < lab[v]

    def label_of(self, v: int) -> Tuple[int, int]:
        k = int(self.core[v])
        return (k, self.levels[k].label[v])


# ---------------------------------------------------------------------------
# Simplified-Order maintainer (Algorithms 7-10)
# ---------------------------------------------------------------------------
class OrderCoreMaintainer:
    """Sequential Simplified-Order edge insertion (OI) and removal (OR)."""

    def __init__(self, n: int, edges: np.ndarray) -> None:
        self.n = n
        self.adj: List[Set[int]] = [set() for _ in range(n)]
        for u, v in np.asarray(edges, dtype=np.int64).reshape(-1, 2):
            if u != v:
                self.adj[int(u)].add(int(v))
                self.adj[int(v)].add(int(u))
        core, order = bz_core_decomposition(n, self.adj)
        self.core = core
        self.O = _KOrder(self.core, order)
        self.last_v_plus = 0
        self.last_v_star = 0

    # -- helpers ----------------------------------------------------------
    def _dout_plus(self, v: int, evicted: Set[int]) -> int:
        """Remaining out-degree (Def 3.7): successors not in V+ \\ V*."""
        return sum(
            1 for w in self.adj[v] if self.O.lt(v, w) and w not in evicted
        )

    def _din_star(self, v: int, v_star: Set[int]) -> int:
        """Candidate in-degree (Def 3.6): predecessors in V*."""
        return sum(1 for w in self.adj[v] if w in v_star and self.O.lt(w, v))

    # -- edge insertion (Algorithm 7 + 8 + 9) ------------------------------
    def insert_edge(self, u: int, v: int) -> List[int]:
        """Insert (u, v); returns the list of vertices whose core rose."""
        if v in self.adj[u]:
            raise ValueError(f"edge ({u},{v}) already present")
        self.adj[u].add(v)
        self.adj[v].add(u)
        if self.O.lt(v, u):
            u, v = v, u  # orient u -> v, u is the k-order root
        K = int(self.core[u])

        evicted: Set[int] = set()
        v_star: Set[int] = set()
        v_star_order: List[int] = []
        dout: Dict[int, int] = {u: self._dout_plus(u, evicted)}
        self.last_v_plus = 0
        self.last_v_star = 0
        if dout[u] <= K:
            return []

        # min-priority queue in k-order; rebuilt when the level renumbers
        # (the sequential analogue of the paper's Appendix E version check).
        in_q: Set[int] = {u}
        q: List[Tuple[int, int]] = [(self.O.label_of(u)[1], u)]
        q_ver = self.O.level(K).ver

        def q_push(w: int) -> None:
            heapq.heappush(q, (self.O.label_of(w)[1], w))
            in_q.add(w)

        while q:
            if self.O.level(K).ver != q_ver:
                q_ver = self.O.level(K).ver
                q = [(self.O.label_of(w)[1], w) for w in in_q]
                heapq.heapify(q)
            _, w = heapq.heappop(q)
            in_q.discard(w)
            if w in v_star or w in evicted:
                continue  # cannot recur (see Appendix C) — defensive
            if w not in dout:
                dout[w] = self._dout_plus(w, evicted)
            din_w = self._din_star(w, v_star)
            self.last_v_plus += 1
            if din_w + dout[w] > K:
                # Forward (Algorithm 8)
                v_star.add(w)
                v_star_order.append(w)
                for x in self.adj[w]:
                    if (
                        int(self.core[x]) == K
                        and self.O.lt(w, x)
                        and x not in in_q
                        and x not in v_star
                        and x not in evicted
                    ):
                        q_push(x)
            elif din_w > 0:
                self._backward(w, din_w, dout, v_star, v_star_order, evicted, K)
            # else: skip — w never joins V+

        # Ending phase (Algorithm 7 lines 9-10)
        lvl_k = self.O.level(K)
        lvl_k1 = self.O.level(K + 1)
        prev: object = "H"
        for w in v_star_order:
            lvl_k.delete(w)
            lvl_k1.insert_after(prev, w)
            prev = w
            self.core[w] = K + 1
        self.last_v_star = len(v_star_order)
        return v_star_order

    def _backward(
        self,
        w: int,
        din_w: int,
        dout: Dict[int, int],
        v_star: Set[int],
        v_star_order: List[int],
        evicted: Set[int],
        K: int,
    ) -> None:
        """Algorithm 9: evict unsupported vertices from V*."""
        evicted.add(w)
        din: Dict[int, int] = {x: self._din_star(x, v_star) for x in v_star}
        r: deque[int] = deque()
        in_r: Set[int] = set()

        def do_pre(x: int) -> None:
            for y in self.adj[x]:
                if y in v_star and self.O.lt(y, x):
                    dout[y] -= 1
                    if din[y] + dout[y] <= K and y not in in_r:
                        r.append(y)
                        in_r.add(y)

        def do_post(x: int) -> None:
            for y in self.adj[x]:
                if y in v_star and self.O.lt(x, y) and din[y] > 0:
                    din[y] -= 1
                    if din[y] + dout[y] <= K and y not in in_r:
                        r.append(y)
                        in_r.add(y)

        do_pre(w)
        dout[w] = dout[w] + din_w  # w's V* predecessors will move above it
        lvl = self.O.level(K)
        pre = w
        while r:
            x = r.popleft()
            in_r.discard(x)
            v_star.discard(x)
            v_star_order.remove(x)
            evicted.add(x)
            do_pre(x)
            do_post(x)
            lvl.delete(x)
            lvl.insert_after(pre, x)
            pre = x
            dout[x] = dout[x] + din[x]
            din[x] = 0

    # -- edge removal (Algorithm 10) ---------------------------------------
    def remove_edge(self, u: int, v: int) -> List[int]:
        """Remove (u, v); returns the list of vertices whose core dropped."""
        if v not in self.adj[u]:
            raise ValueError(f"edge ({u},{v}) not present")
        self.adj[u].discard(v)
        self.adj[v].discard(u)
        K = int(min(self.core[u], self.core[v]))

        mcd: Dict[int, int] = {}
        popped: Set[int] = set()
        in_star: Set[int] = set()
        v_star_order: List[int] = []
        r: deque[int] = deque()

        def mcd_fresh(x: int) -> int:
            # supporters at current cores, minus already-propagated drops
            return sum(
                1
                for y in self.adj[x]
                if self.core[y] >= self.core[x] and y not in popped
            )

        def try_drop(x: int) -> None:
            if mcd[x] < K and x not in in_star:
                in_star.add(x)
                v_star_order.append(x)
                r.append(x)

        for x in (u, v):
            if int(self.core[x]) == K:
                mcd[x] = mcd_fresh(x)
                try_drop(x)

        self.last_v_plus = 0
        while r:
            w = r.popleft()
            popped.add(w)
            self.last_v_plus += 1
            for w2 in self.adj[w]:
                if int(self.core[w2]) == K and w2 not in in_star:
                    if w2 not in mcd:
                        mcd[w2] = mcd_fresh(w2)
                        # w already counted itself out via `popped`
                    else:
                        mcd[w2] -= 1
                    try_drop(w2)

        lvl_k = self.O.level(K)
        lvl_k1 = self.O.level(K - 1)
        for w in v_star_order:
            lvl_k.delete(w)
            lvl_k1.append_tail(w)
            self.core[w] = K - 1
        self.last_v_star = len(v_star_order)
        return v_star_order

    # -- batches ------------------------------------------------------------
    def insert_batch(self, edges: np.ndarray) -> None:
        for u, v in np.asarray(edges, dtype=np.int64).reshape(-1, 2):
            self.insert_edge(int(u), int(v))

    def remove_batch(self, edges: np.ndarray) -> None:
        for u, v in np.asarray(edges, dtype=np.int64).reshape(-1, 2):
            self.remove_edge(int(u), int(v))

    def check_invariants(self) -> None:
        """k-order must be a valid peel order: within a level, every vertex's
        remaining out-degree (successors) must be <= its core number is NOT
        required; the defining invariant is core correctness (checked against
        BZ by the tests) plus label strict monotonicity per level."""
        for k, lvl in self.O.levels.items():
            labs = [lvl.label[x] for x in lvl.iter()]
            assert labs == sorted(labs)
            for x in lvl.iter():
                assert int(self.core[x]) == k


# ---------------------------------------------------------------------------
# Traversal maintainer (TI/TR baselines, Sariyüce et al.)
# ---------------------------------------------------------------------------
class TraversalCoreMaintainer:
    """Sequential Traversal insertion/removal — the paper's TI/TR baseline.

    Insertion BFS-collects the k-subcore reachable from the root through
    vertices whose optimistic support (cd) exceeds K, then runs the eviction
    fixpoint. Removal is the mcd cascade without order maintenance."""

    def __init__(self, n: int, edges: np.ndarray) -> None:
        self.n = n
        self.adj: List[Set[int]] = [set() for _ in range(n)]
        for u, v in np.asarray(edges, dtype=np.int64).reshape(-1, 2):
            if u != v:
                self.adj[int(u)].add(int(v))
                self.adj[int(v)].add(int(u))
        core, _ = bz_core_decomposition(n, self.adj)
        self.core = core
        self.last_v_plus = 0
        self.last_v_star = 0

    def insert_edge(self, u: int, v: int) -> List[int]:
        if v in self.adj[u]:
            raise ValueError(f"edge ({u},{v}) already present")
        self.adj[u].add(v)
        self.adj[v].add(u)
        K = int(min(self.core[u], self.core[v]))
        roots = [x for x in (u, v) if int(self.core[x]) == K]

        # pruned BFS over the K-subcore
        cd: Dict[int, int] = {}
        visited: Set[int] = set()
        stack = []
        for rt in roots:
            if rt not in visited:
                visited.add(rt)
                stack.append(rt)
        while stack:
            w = stack.pop()
            cd[w] = sum(1 for x in self.adj[w] if self.core[x] >= K)
            if cd[w] > K:
                for x in self.adj[w]:
                    if int(self.core[x]) == K and x not in visited:
                        visited.add(x)
                        stack.append(x)
        self.last_v_plus = len(visited)

        # eviction fixpoint on the visited set: a core-K vertex supports a
        # promotion only if it is itself still a live candidate (V* is
        # connected to the root through V*, so candidates outside `visited`
        # cannot exist).
        alive = {w for w in visited if cd[w] > K}
        changed = True
        while changed:
            changed = False
            for w in list(alive):
                support = sum(
                    1
                    for x in self.adj[w]
                    if self.core[x] > K or (self.core[x] == K and x in alive)
                )
                if support <= K:
                    alive.discard(w)
                    changed = True
        for w in alive:
            self.core[w] = K + 1
        self.last_v_star = len(alive)
        return sorted(alive)

    def remove_edge(self, u: int, v: int) -> List[int]:
        if v not in self.adj[u]:
            raise ValueError(f"edge ({u},{v}) not present")
        self.adj[u].discard(v)
        self.adj[v].discard(u)
        K = int(min(self.core[u], self.core[v]))
        mcd: Dict[int, int] = {}
        popped: Set[int] = set()
        in_star: Set[int] = set()
        order: List[int] = []
        r: deque[int] = deque()

        def mcd_fresh(x: int) -> int:
            return sum(
                1
                for y in self.adj[x]
                if self.core[y] >= self.core[x] and y not in popped
            )

        for x in (u, v):
            if int(self.core[x]) == K:
                mcd[x] = mcd_fresh(x)
                if mcd[x] < K and x not in in_star:
                    in_star.add(x)
                    order.append(x)
                    r.append(x)
        self.last_v_plus = 0
        while r:
            w = r.popleft()
            popped.add(w)
            self.last_v_plus += 1
            for w2 in self.adj[w]:
                if int(self.core[w2]) == K and w2 not in in_star:
                    if w2 not in mcd:
                        mcd[w2] = mcd_fresh(w2)
                    else:
                        mcd[w2] -= 1
                    if mcd[w2] < K:
                        in_star.add(w2)
                        order.append(w2)
                        r.append(w2)
        for w in order:
            self.core[w] -= 1
        self.last_v_star = len(order)
        return order

    def insert_batch(self, edges: np.ndarray) -> None:
        for u, v in np.asarray(edges, dtype=np.int64).reshape(-1, 2):
            self.insert_edge(int(u), int(v))

    def remove_batch(self, edges: np.ndarray) -> None:
        for u, v in np.asarray(edges, dtype=np.int64).reshape(-1, 2):
            self.remove_edge(int(u), int(v))
