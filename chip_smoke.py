#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
card: builds the Hopper kernels from this checkout, checks each against
its plain PyTorch version, and drives the main paths — one mixed batch
at a time through ``CoreMaintainer.apply_batch`` on the unified engine,
unweighted and weighted — at full width.

    python3 chip_smoke.py            # needs one CUDA card and nvcc

Phases:
  1. build the kernels; print the card's name and power limit;
  2. small-scale correctness: replay ``mixed_stream`` and
     ``churn_stream`` on an n ~ 2,000 graph with ``kernel_backend="cuda"``,
     cores checked against the BZ oracle after every batch, and cores,
     labels and all 12 batch statistics equal to a
     ``kernel_backend="torch"`` replay on the card; then the same
     replays on weighted maintainers with random weights 1-5 on every
     insert list, cores checked against the weighted peeling oracle,
     and cores, labels, the weight column and the statistics equal
     between the two backends;
  3. each kernel against its plain version on the main path's state
     (the RMAT graph of phase 4: window of ~2^24 slots, n = 2^21), with
     0 mismatches required, timed with CUDA events beside its byte bound;
     ``coo_stat[wsum]`` on the weighted maintainer's state of phase 5;
  4. the main path on ``rmat(21, 16_000_000)``: a 100,000-edge removal
     burst, its re-insertion, then mixed batches of 100,000 edits; per
     batch the wall time, round counts and kernel launches; at the end
     the cores against a fresh peel and the k-order certificate;
  5. the weighted main path on the same graph with weights 1-5:
     ``from_graph(weighted=True, weights=...)``, the same burst removed
     and re-inserted with its own weights, then phase 4's mixed batches
     with random weights; per batch the wall time, round counts and
     ``coo_stat[wsum]`` launches (one per bisection step); at the end
     the cores against a fresh weighted ``from_graph``, the live weight
     column against a host mirror, and the labels canonical.

The sizes are fixed below; ``scripts/profile_burst.py`` profiles a burst
at the same size.

Prints one ``{"kernels": [...]}`` JSON line, the ``nvidia-smi`` name and
power limit, and as the last line ``{"ok": true, "device": {...}}``.
Exits non-zero (printing no result) without a CUDA device, outside a
checkout of the repository, or when any phase fails.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
# int32 ALU: 64 INT32 lanes an SM x 132 SMs x 1.98 GHz boost clock (the
# 67 TFLOP/s fp32 peak is 128 lanes counting an FMA as two operations)
INT32_OPS_PER_S = 64 * 132 * 1.98e9

# the main path: the paper's mid-size real-graph scale and its
# 100,000-edge burst protocol (benchmarks/workloads.py)
SCALE = 21                # log2 vertices of the RMAT graph
EDGES = 16_000_000        # RMAT edges drawn, before build_csr's dedup
BURST = 100_000           # edges removed, then re-inserted, in one batch
MIXED_BATCHES = 4         # mixed_stream batches after the burst pair
MIXED_SIZE = 100_000      # edits per mixed batch
MAX_WEIGHT = 5            # weights drawn uniformly from 1..MAX_WEIGHT
SMALL_N = 2048            # phase 2's graphs
SMALL_BATCHES = 6
SMALL_BATCH = 200
ITERS = 20                # timed launches per kernel in phase 3
PALLAS = "src/repro/kernels/coremaint.py"
REPLACES = {"coo_stat": f"{PALLAS}:262",
            "fused_removal_round": f"{PALLAS}:350",
            "fused_promotion_stats": f"{PALLAS}:449",
            "coo_stat[wsum]": f"{PALLAS}:241"}
MAIN_PATH_KERNELS = ("coo_stat[din]", "coo_stat[same_in]",
                     "fused_removal_round", "fused_promotion_stats")
WEIGHTED_PATH_KERNELS = ("coo_stat[wsum]",)


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(*a) -> None:
    print(*a, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def sync(device) -> None:
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def time_ms(fn, iters: int, device) -> float:
    """Mean time of ``fn`` after one warm-up call: CUDA events on the
    card, the host clock on the CPU."""
    import torch
    fn()
    sync(device)
    if torch.device(device).type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) * 1e3 / iters
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def apply_delta(live: set, ins, rm) -> None:
    """Host mirror of ``apply_batch`` on a live edge set: removals first,
    then the insertions that are not self-loops."""
    for a, b in np.asarray(rm).reshape(-1, 2).tolist():
        live.discard((min(a, b), max(a, b)))
    for a, b in np.asarray(ins).reshape(-1, 2).tolist():
        if a != b:
            live.add((min(a, b), max(a, b)))


# ---------------------------------------------------------------------------
def phase_small(device, n: int, m: int, n_batches: int, batch: int,
                backend: str, yardstick: str) -> None:
    """Replay both streams with ``backend`` and ``yardstick`` side by
    side; BZ oracle after every batch."""
    from repro_torch.core.api import CoreMaintainer
    from repro_torch.core.oracle import bz_core_decomposition
    from repro_torch.graph.generators import erdos_renyi, rmat
    from repro_torch.graph.stream import churn_stream, mixed_stream

    graphs = {"er": erdos_renyi(n, m, seed=7),
              "rmat": rmat(int(np.log2(n)), m, seed=7)}
    for gname, g in graphs.items():
        for sname, stream in (
            ("mixed", mixed_stream(g, n_batches, batch, seed=11)),
            ("churn", churn_stream(g, n_batches, batch, seed=12)),
        ):
            a = CoreMaintainer.from_graph(g, device=device,
                                          kernel_backend=backend)
            b = CoreMaintainer.from_graph(g, device=device,
                                          kernel_backend=yardstick)
            live = {tuple(e) for e in g.edge_array().tolist()}
            t0 = time.perf_counter()
            for ev in stream:
                sa = a.apply_batch(insert_edges=ev.edges,
                                   remove_edges=ev.removals)
                sb = b.apply_batch(insert_edges=ev.edges,
                                   remove_edges=ev.removals)
                apply_delta(live, ev.edges, ev.removals)
                adj = [set() for _ in range(g.n)]
                for u, v in live:
                    adj[u].add(v)
                    adj[v].add(u)
                want, _ = bz_core_decomposition(g.n, adj)
                check(np.array_equal(a.cores(), want),
                      f"phase 2 {gname}/{sname} t={ev.t}: cores != BZ")
                check(np.array_equal(a.cores(), b.cores())
                      and np.array_equal(a.labels(), b.labels()),
                      f"phase 2 {gname}/{sname} t={ev.t}: {backend} != "
                      f"{yardstick} (cores/labels)")
                for f in sa._fields:
                    check(int(getattr(sa, f)) == int(getattr(sb, f)),
                          f"phase 2 {gname}/{sname} t={ev.t}: stats.{f}")
                check(a.live_edges == len(live),
                      f"phase 2 {gname}/{sname}: live edge count")
            log(f"phase 2 {gname}/{sname}: n={g.n} m={g.m} "
                f"{n_batches} batches of {batch}: BZ ok, {backend} == "
                f"{yardstick} bit for bit ({time.perf_counter() - t0:.2f} s)")


def phase_small_weighted(device, n: int, m: int, n_batches: int,
                         batch: int, backend: str, yardstick: str) -> None:
    """Phase 2's replays on weighted maintainers: random weights 1-5 on
    the graph and on every insert list; the weighted peeling oracle
    after every batch."""
    from repro_torch.core.api import CoreMaintainer
    from repro_torch.core.weighted import weighted_core_oracle
    from repro_torch.graph.generators import erdos_renyi, rmat
    from repro_torch.graph.stream import churn_stream, mixed_stream

    graphs = {"er": erdos_renyi(n, m, seed=7),
              "rmat": rmat(int(np.log2(n)), m, seed=7)}
    rng = np.random.default_rng(13)
    for gname, g in graphs.items():
        for sname, stream in (
            ("mixed", mixed_stream(g, n_batches, batch, seed=11)),
            ("churn", churn_stream(g, n_batches, batch, seed=12)),
        ):
            w0 = rng.integers(1, MAX_WEIGHT + 1, g.m)
            a = CoreMaintainer.from_graph(g, device=device,
                                          kernel_backend=backend,
                                          weighted=True, weights=w0)
            b = CoreMaintainer.from_graph(g, device=device,
                                          kernel_backend=yardstick,
                                          weighted=True, weights=w0)
            live = WeightMirror(g.n, g.edge_array(), w0)
            t0 = time.perf_counter()
            for ev in stream:
                iw = rng.integers(1, MAX_WEIGHT + 1, len(ev.edges))
                sa = a.apply_batch(insert_edges=ev.edges,
                                   remove_edges=ev.removals,
                                   insert_weights=iw)
                sb = b.apply_batch(insert_edges=ev.edges,
                                   remove_edges=ev.removals,
                                   insert_weights=iw)
                live.apply(ev.edges, iw, ev.removals)
                where = f"phase 2 weighted {gname}/{sname} t={ev.t}"
                want = weighted_core_oracle(g.n, live.edges(), live.w)
                check(np.array_equal(a.cores(), want),
                      f"{where}: cores != weighted oracle")
                for name in ("core", "label", "w", "valid", "src"):
                    check(bool((getattr(a, name) == getattr(b, name)).all()),
                          f"{where}: {backend} != {yardstick} ({name})")
                for f in sa._fields:
                    check(int(getattr(sa, f)) == int(getattr(sb, f)),
                          f"{where}: stats.{f}")
                check(live.matches(a), f"{where}: weight column != mirror")
            log(f"phase 2 weighted {gname}/{sname}: n={g.n} m={g.m} "
                f"{n_batches} batches of {batch}, weights 1-{MAX_WEIGHT}: "
                f"weighted oracle ok, {backend} == {yardstick} bit for bit "
                f"({time.perf_counter() - t0:.2f} s)")


class WeightMirror:
    """Host mirror of a weighted maintainer's live edges, as sorted int64
    keys ``lo * n + hi`` with their weights, updated with the engine's
    batch semantics: removals first, then insertions without self-loops,
    the first row of an in-batch duplicate winning, and live edges
    keeping their stored weight."""

    def __init__(self, n: int, edges, weights) -> None:
        self.n = n
        keys = self._keys(edges)
        order = np.argsort(keys, kind="stable")
        self.keys = keys[order]
        self.w = np.asarray(weights, dtype=np.int64)[order]

    def _keys(self, edges) -> np.ndarray:
        e = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
        return np.minimum(e[:, 0], e[:, 1]) * self.n + np.maximum(
            e[:, 0], e[:, 1])

    def _find(self, q):
        pos = np.searchsorted(self.keys, q).clip(max=max(len(self.keys) - 1,
                                                         0))
        found = (self.keys[pos] == q) if len(self.keys) else np.zeros(
            len(q), bool)
        return pos, found

    def apply(self, ins, iw, rm) -> None:
        if rm is not None and len(rm):
            pos, found = self._find(self._keys(rm))
            keep = np.ones(len(self.keys), bool)
            keep[pos[found]] = False
            self.keys, self.w = self.keys[keep], self.w[keep]
        if ins is not None and len(ins):
            e = np.asarray(ins, dtype=np.int64).reshape(-1, 2)
            ok = e[:, 0] != e[:, 1]
            k, wk = self._keys(e)[ok], np.asarray(iw, dtype=np.int64)[ok]
            k, first = np.unique(k, return_index=True)
            wk = wk[first]
            _, found = self._find(k)
            keys = np.concatenate([self.keys, k[~found]])
            w = np.concatenate([self.w, wk[~found]])
            order = np.argsort(keys, kind="stable")
            self.keys, self.w = keys[order], w[order]

    def edges(self) -> np.ndarray:
        return np.stack([self.keys // self.n, self.keys % self.n], 1)

    def matches(self, m) -> bool:
        """The maintainer's live slots, keyed and sorted, carry exactly
        the mirror's edges and weights."""
        import torch
        live = torch.nonzero(m.valid).flatten()
        s, d = m.src[live].long(), m.dst[live].long()
        keys = torch.minimum(s, d) * m.n + torch.maximum(s, d)
        keys, order = torch.sort(keys)
        w = m.w[live][order]
        return (keys.shape[0] == len(self.keys)
                and np.array_equal(keys.cpu().numpy(), self.keys)
                and np.array_equal(w.cpu().numpy(), self.w))


def _stat_bytes(e: int, e_valid: int, n: int, stat: str) -> int:
    """Bytes a stat pass must move: the window's valid mask (1 B a slot),
    src and dst of the live slots only (the kernel skips a dead slot
    before it reads the endpoints); core, label (when a predicate reads
    it) and aux (when it reads one) once; the packed int32 output once."""
    from repro_torch.kernels.coremaint import _LABEL_STATS, _STATS
    reads_label = stat in _LABEL_STATS
    reads_aux = stat in ("din", "same_in")
    return (e + 8 * e_valid + 4 * n + 8 * n * reads_label + n * reads_aux
            + 4 * n * _STATS[stat][1])


def kernel_row(name, kname, got, want, run, run_plain, nbytes, ops,
               iters, device, shape: str) -> dict:
    """Hold a kernel's outputs to its plain version's (0 mismatches),
    time both with CUDA events, and return its ``kernels`` JSON row
    (``launches`` is filled in from the main path's run)."""
    err = 0
    for x, y in zip(got, want):
        check(x.dtype == y.dtype and x.shape == y.shape,
              f"phase 3 {name}: dtype/shape")
        err = max(err, int((x.long() - y.long()).abs().max())
                  if x.numel() else 0)
    check(err == 0, f"phase 3 {name}: max abs err {err}")
    ms = time_ms(run, iters, device)
    plain_ms = time_ms(run_plain, max(1, iters // 4), device)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT32_OPS_PER_S * 1e3
    log(f"phase 3 {name}: {shape} mismatches=0 kernel_ms={ms:.4f} "
        f"plain_ms={plain_ms:.4f} bytes={nbytes} "
        f"bound_ms={max(t_bytes, t_ops):.4f}")
    return dict(
        name=name, route="cuda",
        source="src/repro_torch/csrc/coremaint.cu",
        replaces=REPLACES[kname], launches=0, max_abs_err=float(err),
        ms=ms, plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops),
        bound_by="bytes" if t_bytes >= t_ops else "operations",
        library_ms=None,
    )


def phase_kernels(device, m, iters: int, seed: int = 0) -> list:
    """Each kernel against its plain version on the maintainer's state."""
    import torch
    from repro_torch.kernels import coremaint as K

    w = m._window(0)
    src, dst, valid = m.src[:w], m.dst[:w], m.valid[:w]
    core, label, n = m.core, m.label, m.n
    e_valid = int(valid.sum())
    log(f"phase 3 state: window E={w} live slots={e_valid} n={n}")
    gen = torch.Generator(device=device).manual_seed(seed)
    aux = torch.rand(n, generator=gen, device=device) < 0.5
    rows = []

    def record(name, kname, got, want, run, run_plain, nbytes, ops):
        rows.append(kernel_row(name, kname, got, want, run, run_plain,
                               nbytes, ops, iters, device, f"E={w} n={n}"))

    for stat in ("din", "same_in", "mcd_hi_dout", "hi_dout", "mcd"):
        a = aux if stat in ("din", "same_in") else None
        lab = label if stat in K._LABEL_STATS else None
        args = (src, dst, valid, core, lab, n, stat, a)
        got = K.coo_stat(*args)
        want = K.coo_stat_plain(*args)
        # ~2 compares and an add per predicate, per valid slot
        ops = e_valid * 3 * 2 * got.shape[1]
        record(f"coo_stat[{stat}]", "coo_stat", (got,), (want,),
               lambda: K.coo_stat(*args), lambda: K.coo_stat_plain(*args),
               _stat_bytes(w, e_valid, n, stat), ops)
    args = (src, dst, valid, core, label, n)
    record("fused_removal_round", "fused_removal_round",
           K.fused_removal_round(*args), K.fused_removal_round_plain(*args),
           lambda: K.fused_removal_round(*args),
           lambda: K.fused_removal_round_plain(*args),
           # + new_core, drop
           _stat_bytes(w, e_valid, n, "mcd_hi_dout") + 5 * n,
           e_valid * 18 + 3 * n)
    record("fused_promotion_stats", "fused_promotion_stats",
           K.fused_promotion_stats(*args),
           K.fused_promotion_stats_plain(*args),
           lambda: K.fused_promotion_stats(*args),
           lambda: K.fused_promotion_stats_plain(*args),
           _stat_bytes(w, e_valid, n, "hi_dout") + n,  # + viol
           e_valid * 12 + 2 * n)
    return rows


def _wsum_bytes(e: int, e_valid: int, n: int) -> int:
    """Bytes a wsum pass must move: the window's valid mask (1 B a slot),
    src, dst and w of the live slots only (the kernel skips a dead slot
    before it reads them), core and the thresholds once, the int32
    output once."""
    return e + 12 * e_valid + 12 * n


def phase_kernels_weighted(device, m, iters: int) -> list:
    """``coo_stat[wsum]`` against its plain version on the weighted
    maintainer's state, at two thresholds on either side of the
    predicate: ``(core + 1) // 2`` (a bisection mid) and ``core + 1``."""
    from repro_torch.kernels import coremaint as K

    w = m._window(0)
    src, dst, valid, wt = m.src[:w], m.dst[:w], m.valid[:w], m.w[:w]
    core, n = m.core, m.n
    e_valid = int(valid.sum())
    log(f"phase 3 weighted state: window E={w} live slots={e_valid} n={n}")
    rows = []
    for tname, thresh in (("(core+1)//2", (core + 1) // 2),
                          ("core+1", core + 1)):
        args = (src, dst, valid, core, None, n, "wsum", thresh, wt)
        got = K.coo_stat(*args)
        want = K.wsum_plain(src, dst, valid, wt, core, thresh, n)
        # two gathers, a compare and an add per endpoint, per live slot
        rows.append(kernel_row(
            "coo_stat[wsum]", "coo_stat[wsum]", (got,), (want,),
            lambda: K.coo_stat(*args),
            lambda: K.wsum_plain(src, dst, valid, wt, core, thresh, n),
            _wsum_bytes(w, e_valid, n), e_valid * 2 * 4, iters, device,
            f"E={w} n={n} thresh={tname} sum={int(got.sum())}"))
    # both thresholds are checked and logged; the JSON row is the
    # bisection-like one
    return rows[:1]


def certificate_ok(m) -> bool:
    """k-order certificate: same-level successors + higher-core
    neighbours <= core for every vertex."""
    from repro_torch.core import graph_ops as G
    hi, dout = G.hi_and_dout_same(m.src, m.dst, m.valid, m.core, m.label,
                                  m.n)
    return bool(((hi + dout) <= m.core).all())


def phase_main(device, m, g, sample, stream) -> dict:
    """The main path: burst removal, its re-insertion, mixed batches."""
    import torch
    from repro_torch.core.decomposition import peel_decomposition
    from repro_torch.kernels import coremaint as K

    batches = [("burst remove", None, sample),
               ("burst insert", sample, None)]
    batches += [(f"mixed {ev.t}", ev.edges, ev.removals) for ev in stream]
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    for name, ins, rm in batches:
        before = dict(K.LAUNCHES)
        sync(device)
        t0 = time.perf_counter()
        st = m.apply_batch(insert_edges=ins, remove_edges=rm)
        sync(device)
        dt = time.perf_counter() - t0
        moved = {k: K.LAUNCHES[k] - before[k] for k in K.LAUNCHES
                 if K.LAUNCHES[k] != before[k]}
        log(f"phase 4 {name}: wall_s={dt:.4f} "
            f"remove_rounds={int(st.remove_rounds)} "
            f"insert_rounds={int(st.insert_rounds)} "
            f"n_removed={int(st.n_removed)} n_inserted={int(st.n_inserted)} "
            f"n_dropped={int(st.n_dropped)} n_promoted={int(st.n_promoted)} "
            f"v_plus={int(st.v_plus)} launches={json.dumps(moved)}")
    launches = dict(K.LAUNCHES)
    for k in MAIN_PATH_KERNELS:
        check(launches[k] > 0 or not on_card,
              f"phase 4: kernel {k} was never launched")
    peak = torch.cuda.max_memory_allocated() if on_card else None
    log(f"phase 4 launches={json.dumps(launches)} "
        f"max_memory_allocated={peak}")
    t0 = time.perf_counter()
    want, _ = peel_decomposition(m.src, m.dst, m.valid, m.n)
    check(torch.equal(m.core, want), "phase 4: cores != fresh peel")
    check(certificate_ok(m), "phase 4: k-order certificate violated")
    check(m.live_edges == g.m + sum(
        len(ev.edges) - len(ev.removals) for ev in stream),
        "phase 4: live edge count")
    log(f"phase 4: cores == fresh peel of the final live edge set, "
        f"certificate holds ({time.perf_counter() - t0:.1f} s)")
    return launches


def phase_weighted(device, m, g, w0, pick, stream, seed: int = 1) -> dict:
    """The weighted main path: the burst ``g.edge_array()[pick]`` removed
    and re-inserted with its own weights, then ``stream``'s mixed batches
    with random weights."""
    import torch
    from repro_torch.core.api import CoreMaintainer
    from repro_torch.core.order import renumber
    from repro_torch.graph.csr import build_csr
    from repro_torch.kernels import coremaint as K

    rng = np.random.default_rng(seed)
    sample = g.edge_array()[pick]
    batches = [("burst remove", None, None, sample),
               ("burst insert", sample, w0[pick], None)]
    batches += [(f"mixed {ev.t}", ev.edges,
                 rng.integers(1, MAX_WEIGHT + 1, len(ev.edges)), ev.removals)
                for ev in stream]
    mirror = WeightMirror(g.n, g.edge_array(), w0)
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    for name, ins, iw, rm in batches:
        before = K.LAUNCHES["coo_stat[wsum]"]
        sync(device)
        t0 = time.perf_counter()
        st = m.apply_batch(insert_edges=ins, remove_edges=rm,
                           insert_weights=iw)
        sync(device)
        dt = time.perf_counter() - t0
        mirror.apply(ins, iw, rm)
        log(f"phase 5 {name}: wall_s={dt:.4f} "
            f"remove_rounds={int(st.remove_rounds)} "
            f"insert_rounds={int(st.insert_rounds)} "
            f"n_removed={int(st.n_removed)} n_inserted={int(st.n_inserted)} "
            f"n_dropped={int(st.n_dropped)} n_promoted={int(st.n_promoted)} "
            f"renumbered={bool(st.renumbered)} "
            f"wsum_launches={K.LAUNCHES['coo_stat[wsum]'] - before}")
    launches = dict(K.LAUNCHES)
    for k in WEIGHTED_PATH_KERNELS:
        check(launches[k] > 0 or not on_card,
              f"phase 5: kernel {k} was never launched")
    peak = torch.cuda.max_memory_allocated() if on_card else None
    log(f"phase 5 launches={json.dumps(launches)} "
        f"max_memory_allocated={peak}")
    t0 = time.perf_counter()
    check(mirror.matches(m), "phase 5: live weight column != host mirror")
    check(m.live_edges == len(mirror.keys) == g.m + sum(
        len(ev.edges) - len(ev.removals) for ev in stream),
        "phase 5: live edge count")
    check(torch.equal(m.label, renumber(m.core, m.label)),
          "phase 5: labels != order.renumber(core, label)")
    fresh_g = build_csr(g.n, mirror.edges())
    check(np.array_equal(fresh_g.edge_array(), mirror.edges()),
          "phase 5: build_csr reordered the mirror's edges")
    fresh = CoreMaintainer.from_graph(fresh_g, device=device, weighted=True,
                                      weights=mirror.w)
    check(torch.equal(m.core, fresh.core),
          "phase 5: cores != fresh weighted from_graph")
    log(f"phase 5: cores == fresh weighted from_graph of the final live "
        f"edges and weights, weight column == host mirror, labels "
        f"canonical ({time.perf_counter() - t0:.1f} s)")
    return launches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.core.api import CoreMaintainer
    from repro_torch.graph.generators import rmat
    from repro_torch.graph.stream import mixed_stream
    from repro_torch.kernels import coremaint as K

    device = "cuda"
    # ---- phase 1 --------------------------------------------------------
    t0 = time.perf_counter()
    lib = K.build(verbose=True)
    K._library()
    log(f"phase 1 build: {lib.name} in {time.perf_counter() - t0:.1f} s")
    smi = nvidia_smi_line()
    log(f"phase 1 card: {smi} | {torch.cuda.get_device_name(0)} | "
        f"torch {torch.__version__} cuda {torch.version.cuda}")

    # ---- phase 2 --------------------------------------------------------
    phase_small(device, SMALL_N, 5 * SMALL_N, SMALL_BATCHES, SMALL_BATCH,
                backend="cuda", yardstick="torch")
    phase_small_weighted(device, SMALL_N, 5 * SMALL_N, SMALL_BATCHES,
                         SMALL_BATCH, backend="cuda", yardstick="torch")

    # ---- main path set-up (phase 3 runs on its state) --------------------
    t0 = time.perf_counter()
    g = rmat(SCALE, EDGES, seed=0)
    log(f"phase 4 graph: rmat({SCALE}, {EDGES}, seed=0) keeps "
        f"n={g.n} m={g.m} after build_csr ({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    m = CoreMaintainer.from_graph(g, init="jax-peel", device=device)
    sync(device)
    log(f"phase 4 from_graph(init='jax-peel'): capacity={m.capacity} "
        f"window={m._window(BURST)} kmax={int(m.core.max())} "
        f"({time.perf_counter() - t0:.1f} s)")

    # ---- phase 3 --------------------------------------------------------
    rows = phase_kernels(device, m, ITERS)

    # ---- phase 4 --------------------------------------------------------
    rng = np.random.default_rng(0)
    pick = rng.choice(g.m, size=BURST, replace=False)
    t0 = time.perf_counter()
    stream = list(mixed_stream(g, MIXED_BATCHES, MIXED_SIZE, seed=0))
    log(f"phase 4 mixed_stream: {MIXED_BATCHES} batches of {MIXED_SIZE} "
        f"sampled in {time.perf_counter() - t0:.1f} s (host set-up)")
    launches = phase_main(device, m, g, g.edge_array()[pick], stream)
    for r in rows:
        r["launches"] = launches[r["name"]]
        # the unified engine fuses the mcd_hi_dout / hi_dout passes into
        # the fused wrappers; these stats serve other callers
        r["status"] = ("on the main path" if r["name"] in MAIN_PATH_KERNELS
                       else "ported, off the main path")
    del m

    # ---- weighted main path set-up (phase 3 runs on its state) ----------
    w0 = np.random.default_rng(1).integers(1, MAX_WEIGHT + 1, g.m)
    K.reset_launches()
    t0 = time.perf_counter()
    mw = CoreMaintainer.from_graph(g, device=device, weighted=True,
                                   weights=w0)
    sync(device)
    log(f"phase 5 from_graph(weighted=True, weights 1-{MAX_WEIGHT}): "
        f"capacity={mw.capacity} window={mw._window(BURST)} "
        f"kmax={int(mw.core.max())} wsum_launches="
        f"{K.LAUNCHES['coo_stat[wsum]']} ({time.perf_counter() - t0:.1f} s)")
    wrows = phase_kernels_weighted(device, mw, ITERS)

    # ---- phase 5 --------------------------------------------------------
    wlaunches = phase_weighted(device, mw, g, w0, pick, stream)
    for r in wrows:
        r["launches"] = wlaunches[r["name"]]
        r["status"] = "on the weighted main path"
    rows += wrows

    log(json.dumps({"kernels": rows}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
