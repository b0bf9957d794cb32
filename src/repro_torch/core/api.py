"""CoreMaintainer — the public interface to parallel order-based core
maintenance, on PyTorch.

The port of the reference's ``core/api.py`` for ``engine="unified"``:
every batch (mixed insertions + removals) runs as one call of
``engine.apply_batch`` on the maintainer's device, with the slot table
updated in place. The host keeps

  * a lazily-built ``edge -> slot`` mirror for queries (``edge_slot``;
    dropped after each batch, built on first access), and
  * two monotone bounds for capacity planning: ``hwm_ub`` (upper bound
    on the slot high-water mark, reported exactly by
    ``stats.high_water``) and ``live_ub`` (upper bound on the live edge
    count). The free-list recycles tombstoned slots in the batch
    program, so the bounds are re-read from the device only when they
    cross the capacity threshold.

Entry points run on the card: ``device=None`` means ``"cuda"`` and
raises when no CUDA device is present; tests pass ``device="cpu"``.
``kernel_backend`` is ``"torch"`` or ``"cuda"`` (the counterparts of the
reference's ``"lax"`` and ``"pallas"``) and defaults to ``"cuda"`` on a
CUDA device, ``"torch"`` on the CPU; ``"cuda"`` on a CPU device raises.

``weighted=True`` (weighted coreness, Zhou et al.) adds a per-slot int32
weight column ``w``: ``from_graph(weights=)`` takes the initial
weights, ``apply_batch(insert_weights=)`` the weights of each batch's
inserts, and both maintenance phases run the weighted h-index fixpoint
(``engine.apply_batch_weighted``).

Checkpoints use the reference's ``np.savez_compressed`` payload (n,
capacity, src, dst, valid, n_edges, core, label, and ``w`` when
weighted), so they load in both directions. The host engine is in
ROADMAP Queue 1 (items 1-6, the rest) and the sharded engines item 8.

Edge endpoints are validated on every edit path: out-of-range vertices
raise ``ValueError`` by default, or are dropped under ``validate=False``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..graph.csr import CSRGraph
from .decomposition import peel_decomposition, rank_to_labels
from .engine import BatchStats, apply_batch, apply_batch_weighted
from .graph_ops import KERNEL_BACKENDS
from .insert import InsertStats
from .oracle import bz_core_decomposition
from .remove import RemoveStats, weighted_core_fixpoint_pass

_STATE_KEYS = ("n", "capacity", "src", "dst", "valid", "n_edges", "core",
               "label")


def _pow2_roundup(need: int) -> int:
    """Smallest power of two >= need — the bucketing idiom behind batch
    padding and the active window."""
    p = 1
    while p < need:
        p *= 2
    return p


def plan_window(hwm_ub: int, b_ins: int, local_cap: int) -> int:
    """Pow2 bucket of the active window covering the high-water bound
    plus a ``b_ins``-insert batch, clamped to the table size."""
    return min(_pow2_roundup(max(16, hwm_ub + b_ins + 1)), local_cap)


def _pad_pow2(x: np.ndarray, fill: int) -> np.ndarray:
    p = _pow2_roundup(max(1, len(x)))
    out = np.full(p, fill, dtype=np.int32)
    out[: len(x)] = x
    return out


def _as_edge_array(edges) -> np.ndarray:
    if edges is None:
        return np.zeros((0, 2), dtype=np.int64)
    return np.asarray(edges, dtype=np.int64).reshape(-1, 2)


def resolve_backend(kernel_backend: Optional[str],
                    dev: torch.device) -> str:
    """``None`` means ``"cuda"`` on a card and ``"torch"`` on the CPU;
    ``"cuda"`` on a CPU device raises."""
    if kernel_backend is None:
        kernel_backend = "cuda" if dev.type == "cuda" else "torch"
    if kernel_backend not in KERNEL_BACKENDS:
        raise ValueError(
            f"unknown kernel_backend {kernel_backend!r} "
            f"(expected one of {KERNEL_BACKENDS})"
        )
    if kernel_backend == "cuda" and dev.type != "cuda":
        raise ValueError(
            "kernel_backend='cuda' needs a CUDA device (got "
            f"{dev}); the CPU runs kernel_backend='torch'"
        )
    return kernel_backend


def _check_engine(engine: str) -> None:
    if engine == "host":
        raise NotImplementedError(
            "engine='host' is in ROADMAP Queue 1, items 1-6, the rest; "
            "the port runs engine='unified'"
        )
    if engine == "sharded":
        raise NotImplementedError(
            "engine='sharded' is ROADMAP Queue 1 item 8; the port runs "
            "engine='unified'"
        )
    if engine != "unified":
        raise ValueError(f"unknown engine {engine!r}")


@dataclasses.dataclass
class CoreMaintainer:
    """Dynamic-graph core maintenance with k-order labels (PyTorch)."""

    n: int
    capacity: int
    src: torch.Tensor      # int32 [capacity]
    dst: torch.Tensor      # int32 [capacity]
    valid: torch.Tensor    # bool [capacity]
    n_edges: torch.Tensor  # int32 scalar, live edge count
    core: torch.Tensor     # int32 [n]
    label: torch.Tensor    # int64 [n]
    n_levels: int
    engine: str = "unified"
    kernel_backend: Optional[str] = None  # None: "cuda" on a card
    validate: bool = True  # raise on out-of-range endpoints (else mask)
    weighted: bool = False
    w: Optional[torch.Tensor] = None  # int32 [capacity] when weighted
    last_insert_stats: Optional[InsertStats] = None
    last_remove_stats: Optional[RemoveStats] = None
    last_batch_stats: Optional[BatchStats] = None
    slot_cache: Optional[Dict[Tuple[int, int], int]] = None
    live_ub: int = -1  # upper bound on live edges (-1: from valid)
    hwm_ub: int = -1   # upper bound on the slot high-water mark
    _last_window: int = dataclasses.field(default=0, repr=False)

    def __post_init__(self) -> None:
        _check_engine(self.engine)
        dev = self.src.device
        self.kernel_backend = resolve_backend(self.kernel_backend, dev)
        if self.weighted:
            if self.w is None:
                # unit weights: the weighted engine then computes exactly
                # the classic coreness
                self.w = torch.ones(self.capacity, dtype=torch.int32,
                                    device=dev)
            elif tuple(self.w.shape) != (self.capacity,):
                raise ValueError(
                    f"w has shape {tuple(self.w.shape)}, expected the "
                    f"slot table shape ({self.capacity},)"
                )
            else:
                self.w = self.w.to(device=dev, dtype=torch.int32)
        elif self.w is not None:
            raise ValueError(
                "w= (per-slot edge weights) needs weighted=True; the "
                "unweighted engine would silently ignore the column"
            )
        if self.live_ub < 0 or self.hwm_ub < 0:
            live = torch.nonzero(self.valid).flatten()
            self.live_ub = int(live.shape[0])
            self.hwm_ub = int(live[-1]) + 1 if live.numel() else 0

    @property
    def device(self) -> torch.device:
        return self.src.device

    # -- construction -------------------------------------------------------
    @classmethod
    def from_graph(
        cls,
        g: CSRGraph,
        capacity: Optional[int] = None,
        init: str = "host-bz",
        engine: str = "unified",
        kernel_backend: Optional[str] = None,
        weighted: bool = False,
        validate: bool = True,
        device=None,
        weights=None,
    ) -> "CoreMaintainer":
        """Build a maintainer from a static graph. ``init="host-bz"``
        runs the sequential BZ oracle on the host; ``init="jax-peel"``
        (the reference's name, kept so callers port unchanged) runs the
        level-synchronous peel on the device. The ``edge_slot`` mirror
        is left to be built on first access.

        ``weighted=True`` takes ``weights`` aligned with
        ``g.edge_array()`` (positive integers; None means all ones) and
        bypasses ``init``: the initial cores come from the engine's own
        weighted h-index fixpoint, from the weighted-degree bound, on
        the maintainer's device and kernel backend (the integer result
        cannot depend on the backend), and the initial labels are the
        ``(core, vertex id)`` lexicographic ranks."""
        _check_engine(engine)
        dev = resolve_device(device)
        edges = g.edge_array()
        m = edges.shape[0]
        capacity = capacity or max(16, 2 * m)
        if capacity <= m:
            raise ValueError("capacity must exceed edge count")
        if weights is not None and not weighted:
            raise ValueError("weights= needs weighted=True")
        src = torch.zeros(capacity, dtype=torch.int32, device=dev)
        dst = torch.zeros(capacity, dtype=torch.int32, device=dev)
        val = torch.zeros(capacity, dtype=torch.bool, device=dev)
        src[:m] = torch.from_numpy(edges[:, 0].astype(np.int32)).to(dev)
        dst[:m] = torch.from_numpy(edges[:, 1].astype(np.int32)).to(dev)
        val[:m] = True
        common = dict(n=g.n, capacity=capacity, src=src, dst=dst, valid=val,
                      n_edges=torch.tensor(m, dtype=torch.int32, device=dev),
                      n_levels=g.n + 2, engine=engine, validate=validate,
                      live_ub=m, hwm_ub=m)
        if weighted:
            wv = (np.ones(m, dtype=np.int64) if weights is None
                  else np.asarray(weights, dtype=np.int64).reshape(-1))
            if wv.shape[0] != m:
                raise ValueError(
                    f"weights have length {wv.shape[0]} but the graph "
                    f"has {m} edges"
                )
            if wv.size and (wv < 1).any():
                raise ValueError("edge weights must be positive integers")
            backend = resolve_backend(kernel_backend, dev)
            wcol = torch.zeros(capacity, dtype=torch.int32, device=dev)
            wcol[:m] = torch.from_numpy(wv.astype(np.int32)).to(dev)
            deg_w = np.zeros(g.n, dtype=np.int64)
            np.add.at(deg_w, edges[:, 0], wv)
            np.add.at(deg_w, edges[:, 1], wv)
            core, _, _ = weighted_core_fixpoint_pass(
                src, dst, val, wcol,
                torch.from_numpy(deg_w.astype(np.int32)).to(dev), g.n,
                kernel_backend=backend,
            )
            core_np = core.cpu().numpy()
            order = np.lexsort((np.arange(g.n), core_np))
            rank = np.zeros(g.n, dtype=np.int32)
            rank[order] = np.arange(g.n, dtype=np.int32)
            label = rank_to_labels(torch.from_numpy(rank).to(dev))
            return cls(core=core, label=label, kernel_backend=backend,
                       weighted=True, w=wcol, **common)
        if init == "host-bz":
            adj = [set(g.neighbors(v).tolist()) for v in range(g.n)]
            core_np, order = bz_core_decomposition(g.n, adj)
            rank = np.zeros(g.n, dtype=np.int32)
            rank[np.asarray(order, dtype=np.int64)] = np.arange(
                g.n, dtype=np.int32
            )
            core = torch.from_numpy(core_np.astype(np.int32)).to(dev)
            label = rank_to_labels(torch.from_numpy(rank).to(dev))
        elif init == "jax-peel":
            core, rank = peel_decomposition(src, dst, val, g.n)
            label = rank_to_labels(rank)
        else:
            raise ValueError(init)
        return cls(core=core, label=label, kernel_backend=kernel_backend,
                   **common)

    @classmethod
    def from_state(
        cls,
        arrays: Mapping[str, np.ndarray],
        device=None,
        kernel_backend: Optional[str] = None,
        engine: str = "unified",
        weighted: bool = False,
        validate: bool = True,
    ) -> "CoreMaintainer":
        """Build a maintainer from the reference's state as numpy arrays:
        the keys of its ``save`` payload (n, capacity, src, dst, valid,
        n_edges, core, label, and ``w`` of a weighted maintainer). The
        unweighted engine ignores a weight column, as the reference's
        unweighted ``load`` does; ``weighted=True`` without one adopts
        unit weights."""
        _check_engine(engine)
        dev = resolve_device(device)
        missing = [k for k in _STATE_KEYS if k not in arrays]
        if missing:
            raise KeyError(f"state lacks {missing}")

        def t(key, dtype):
            # a copy: the slot table is updated in place, and the caller's
            # arrays (a reference maintainer's buffers) must stay as given
            return torch.from_numpy(np.array(arrays[key], dtype=dtype)).to(dev)

        n = int(np.asarray(arrays["n"]))
        return cls(
            n=n,
            capacity=int(np.asarray(arrays["capacity"])),
            src=t("src", np.int32),
            dst=t("dst", np.int32),
            valid=t("valid", np.bool_),
            n_edges=t("n_edges", np.int32).reshape(()),
            core=t("core", np.int32),
            label=t("label", np.int64),
            n_levels=n + 2,
            engine=engine,
            kernel_backend=kernel_backend,
            validate=validate,
            weighted=weighted,
            w=t("w", np.int32) if weighted and "w" in arrays else None,
        )

    # -- queries -------------------------------------------------------------
    @property
    def edge_slot(self) -> Dict[Tuple[int, int], int]:
        """Host mirror of the live edge -> slot table, built on first
        access after a batch (queries tolerate the sync; the edit path
        never reads it)."""
        if self.slot_cache is None:
            live = torch.nonzero(self.valid).flatten().cpu().numpy()
            src = self.src.cpu().numpy()[live]
            dst = self.dst.cpu().numpy()[live]
            lo, hi = np.minimum(src, dst), np.maximum(src, dst)
            self.slot_cache = dict(zip(zip(lo.tolist(), hi.tolist()),
                                       live.tolist()))
        return self.slot_cache

    def cores(self) -> np.ndarray:
        return self.core.cpu().numpy()[: self.n]

    def labels(self) -> np.ndarray:
        return self.label.cpu().numpy()[: self.n]

    def order_lt(self, u: int, v: int) -> bool:
        cu, cv = int(self.core[u]), int(self.core[v])
        if cu != cv:
            return cu < cv
        return int(self.label[u]) < int(self.label[v])

    @property
    def live_edges(self) -> int:
        return int(self.valid.sum())

    # -- validation ----------------------------------------------------------
    def _validated(self, edges, what: str, weights=None):
        """Normalize an edge batch and enforce endpoint bounds: with
        ``validate`` an out-of-range endpoint raises, otherwise the
        offending rows are dropped. ``weights``, when given, must align
        row for row, always validate strictly (positive integers) and
        are dropped with their rows. Returns ``edges``, or ``(edges,
        weights)`` when weights were passed."""
        edges = _as_edge_array(edges)
        if weights is not None:
            weights = np.asarray(weights, dtype=np.int64).reshape(-1)
            if weights.shape[0] != edges.shape[0]:
                raise ValueError(
                    f"{what} weights have length {weights.shape[0]} but "
                    f"the edge batch has {edges.shape[0]} rows"
                )
            if weights.size and (weights < 1).any():
                raise ValueError(
                    f"{what} edge weights must be positive integers, "
                    f"got {int(weights[weights < 1][0])}"
                )
        if edges.size:
            bad = ((edges < 0) | (edges >= self.n)).any(axis=1)
            if bad.any():
                if self.validate:
                    row = edges[bad][0]
                    raise ValueError(
                        f"{what} edge {row.tolist()} out of range for "
                        f"n={self.n} (pass validate=False to mask instead)"
                    )
                edges = edges[~bad]
                if weights is not None:
                    weights = weights[~bad]
        if weights is not None:
            return edges, weights
        return edges

    # -- edits ----------------------------------------------------------------
    def apply_batch(self, insert_edges=None, remove_edges=None,
                    insert_weights=None) -> BatchStats:
        """Apply one mixed batch (removals first, then insertions) on the
        device. Both lists are validated before any state changes.

        ``insert_weights`` (weighted maintainers only) aligns row for row
        with ``insert_edges``; omitted means weight 1 per edge. An
        in-batch duplicate keeps the FIRST row's weight, inserting a
        live edge keeps the stored weight, and remove + insert in one
        batch commits the new weight."""
        if insert_weights is not None and not self.weighted:
            raise ValueError(
                "insert_weights= needs weighted=True; the unweighted "
                "engine would silently drop the weights"
            )
        if self.weighted:
            if insert_weights is None:
                insert_weights = np.ones(
                    _as_edge_array(insert_edges).shape[0], dtype=np.int64)
            ins, ins_w = self._validated(insert_edges, "insert",
                                         weights=insert_weights)
        else:
            ins = self._validated(insert_edges, "insert")
        rm = self._validated(remove_edges, "remove")
        dev = self.device
        b_ins = ins.shape[0]
        if b_ins == 0 and rm.shape[0] == 0:
            z = torch.zeros((), dtype=torch.int32, device=dev)
            stats = BatchStats(
                z, z, z, z, z, z, z,
                torch.zeros((), dtype=torch.bool, device=dev), z,
                torch.tensor(self.hwm_ub, dtype=torch.int32, device=dev),
                z, z,
            )
            self.last_batch_stats = stats
            return stats
        self._ensure_capacity(b_ins)
        iu = _pad_pow2(ins[:, 0], 0)
        iv = _pad_pow2(ins[:, 1], 0)
        iok = np.zeros(len(iu), dtype=bool)
        iok[:b_ins] = True
        ru = _pad_pow2(rm[:, 0], 0)
        rv = _pad_pow2(rm[:, 1], 0)
        rok = np.zeros(len(ru), dtype=bool)
        rok[: rm.shape[0]] = True
        # pow2 bound on the slot high-water mark incl. this batch: every
        # edge pass runs over this slot prefix only, and (the free-list
        # fills the lowest holes first) it always holds >= b_ins free
        # slots
        window = self._window(b_ins)
        if 0 < self._last_window < window:
            # the bucket would grow — refresh the exact bounds (one
            # amortized sync) before paying for wider passes
            self._refresh_bounds()
            window = self._window(b_ins)
        self._last_window = window
        if self.weighted:
            # padded lanes carry weight 1; iok=False keeps them out of
            # the slot writes and the total-weight promotion bound
            iw = _pad_pow2(ins_w.astype(np.int32), 1)
            lanes = [torch.from_numpy(x).to(dev)
                     for x in (iu, iv, iw, iok, ru, rv, rok)]
            (self.src, self.dst, self.valid, self.w, self.core, self.label,
             self.n_edges, stats) = apply_batch_weighted(
                self.src, self.dst, self.valid, self.w, self.core,
                self.label, self.n_edges, *lanes, self.n, self.n_levels,
                window, kernel_backend=self.kernel_backend,
            )
        else:
            lanes = [torch.from_numpy(x).to(dev)
                     for x in (iu, iv, iok, ru, rv, rok)]
            (self.src, self.dst, self.valid, self.core, self.label,
             self.n_edges, stats) = apply_batch(
                self.src, self.dst, self.valid, self.core, self.label,
                self.n_edges, *lanes, self.n, self.n_levels, window,
                kernel_backend=self.kernel_backend,
            )
        # monotone bounds: each insert can raise the high-water mark and
        # the live count by at most one; removals only help
        self.hwm_ub = min(self.hwm_ub + b_ins, self.capacity)
        self.live_ub = min(self.live_ub + b_ins, self.capacity)
        self.slot_cache = None
        self.last_batch_stats = stats
        return stats

    def insert_edges(self, edges: np.ndarray,
                     weights: Optional[np.ndarray] = None) -> InsertStats:
        st = self.apply_batch(insert_edges=edges, insert_weights=weights)
        self.last_insert_stats = InsertStats(
            rounds=st.insert_rounds,
            n_promoted=st.n_promoted,
            v_plus=st.v_plus,
            max_frontier=st.max_frontier,
        )
        return self.last_insert_stats

    def remove_edges(self, edges: np.ndarray) -> RemoveStats:
        st = self.apply_batch(remove_edges=edges)
        self.last_remove_stats = RemoveStats(
            rounds=st.remove_rounds, n_dropped=st.n_dropped,
            max_frontier=st.max_frontier,
        )
        return self.last_remove_stats

    # -- capacity planning ----------------------------------------------------
    def _window(self, b_ins: int) -> int:
        return plan_window(self.hwm_ub, b_ins, self.capacity)

    def _refresh_bounds(self) -> None:
        """Replace the monotone planning bounds with the exact values the
        device already computed (``stats.high_water`` and ``n_edges``)."""
        if self.last_batch_stats is not None:
            self.hwm_ub = int(self.last_batch_stats.high_water)
        self.live_ub = int(self.n_edges)

    def _ensure_capacity(self, b_ins: int) -> None:
        """Make the window able to hold the live slots plus this batch:
        bound check -> exact-bound refresh -> defrag, growing in the same
        re-layout if a packed table would still leave no headroom."""
        if self.hwm_ub + b_ins + 1 < self.capacity:
            return
        self._refresh_bounds()
        if self.hwm_ub + b_ins + 1 < self.capacity:
            return
        new_cap = self.capacity
        while self.live_ub + b_ins + 1 >= new_cap:
            new_cap = max(new_cap * 2, new_cap + 2 * b_ins + 16)
        self._defrag_to(new_cap)

    def _defrag_to(self, new_cap: int) -> None:
        """Repack the live slots into the lowest ``m`` slots of a table
        of ``new_cap`` slots (compact and grow in one re-layout), on the
        device. Preserves core/label state."""
        live = torch.nonzero(self.valid).flatten()
        m = int(live.shape[0])
        if new_cap <= m:
            raise ValueError(
                f"defrag target {new_cap} cannot hold {m} live edges"
            )
        dev = self.device
        src = torch.zeros(new_cap, dtype=torch.int32, device=dev)
        dst = torch.zeros(new_cap, dtype=torch.int32, device=dev)
        val = torch.zeros(new_cap, dtype=torch.bool, device=dev)
        src[:m] = self.src[live]
        dst[:m] = self.dst[live]
        val[:m] = True
        self.src, self.dst, self.valid = src, dst, val
        if self.weighted:
            w = torch.zeros(new_cap, dtype=torch.int32, device=dev)
            w[:m] = self.w[live]
            self.w = w
        self.n_edges = torch.tensor(m, dtype=torch.int32, device=dev)
        self.capacity = new_cap
        self.live_ub = m
        self.hwm_ub = m
        self._last_window = 0  # fresh layout: let the next batch re-bucket
        self.slot_cache = None

    def _grow_to(self, new_cap: int) -> None:
        """Extend the slot table with dead headroom."""
        pad = new_cap - self.capacity
        if pad <= 0:
            return
        self.src = torch.cat([self.src, self.src.new_zeros(pad)])
        self.dst = torch.cat([self.dst, self.dst.new_zeros(pad)])
        self.valid = torch.cat([self.valid, self.valid.new_zeros(pad)])
        if self.weighted:
            self.w = torch.cat([self.w, self.w.new_zeros(pad)])
        self.capacity = new_cap

    # -- persistence -------------------------------------------------------------
    def state(self) -> Dict[str, np.ndarray]:
        """The checkpoint payload as numpy arrays — the reference's
        ``save`` keys and dtypes (``w`` added when weighted), so
        ``from_state`` of either package reads it."""
        payload = dict(
            n=self.n,
            capacity=self.capacity,
            src=self.src.cpu().numpy(),
            dst=self.dst.cpu().numpy(),
            valid=self.valid.cpu().numpy(),
            n_edges=self.n_edges.cpu().numpy(),
            core=self.cores(),
            label=self.labels(),
        )
        if self.weighted:
            payload["w"] = self.w.cpu().numpy()
        return payload

    def save(self, path: str) -> None:
        """Checkpoint the maintainer (the free-list is implicit: a dead
        slot is exactly a ``valid=False`` entry)."""
        np.savez_compressed(path, **self.state())

    @classmethod
    def load(cls, path: str, device=None,
             kernel_backend: Optional[str] = None,
             engine: str = "unified", weighted: bool = False,
             validate: bool = True) -> "CoreMaintainer":
        """Load a checkpoint of either package."""
        with np.load(path) as z:
            arrays = {k: z[k] for k in z.files}
        return cls.from_state(arrays, device=device,
                              kernel_backend=kernel_backend, engine=engine,
                              weighted=weighted, validate=validate)
