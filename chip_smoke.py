#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
card: builds the Hopper kernels from this checkout, checks each against
its plain PyTorch version, and drives the main path — one mixed batch at
a time through ``CoreMaintainer.apply_batch`` on the unified engine — at
full width.

    python3 chip_smoke.py            # needs one CUDA card and nvcc

Phases:
  1. build the kernels; print the card's name and power limit;
  2. small-scale correctness: replay ``mixed_stream`` and
     ``churn_stream`` on an n ~ 2,000 graph with ``kernel_backend="cuda"``,
     cores checked against the BZ oracle after every batch, and cores,
     labels and all 12 batch statistics equal to a
     ``kernel_backend="torch"`` replay on the card;
  3. each kernel against its plain version on the main path's state
     (the RMAT graph of phase 4: window of ~2^24 slots, n = 2^21), with
     0 mismatches required, timed with CUDA events beside its byte bound;
  4. the main path on ``rmat(21, 16_000_000)``: a 100,000-edge removal
     burst, its re-insertion, then mixed batches of 100,000 edits; per
     batch the wall time, round counts and kernel launches; at the end
     the cores against a fresh peel and the k-order certificate.

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
SMALL_N = 2048            # phase 2's graphs
SMALL_BATCHES = 6
SMALL_BATCH = 200
ITERS = 20                # timed launches per kernel in phase 3
PALLAS = "src/repro/kernels/coremaint.py"
REPLACES = {"coo_stat": f"{PALLAS}:262",
            "fused_removal_round": f"{PALLAS}:350",
            "fused_promotion_stats": f"{PALLAS}:449"}
MAIN_PATH_KERNELS = ("coo_stat[din]", "coo_stat[same_in]",
                     "fused_removal_round", "fused_promotion_stats")


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
        rows.append(dict(
            name=name, route="cuda",
            source="src/repro_torch/csrc/coremaint.cu",
            replaces=REPLACES[kname], launches=0, max_abs_err=float(err),
            ms=ms, plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            library_ms=None,
        ))
        log(f"phase 3 {name}: E={w} n={n} mismatches=0 kernel_ms={ms:.4f} "
            f"plain_ms={plain_ms:.4f} bytes={nbytes} "
            f"bound_ms={max(t_bytes, t_ops):.4f}")

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


def certificate_ok(m) -> bool:
    """k-order certificate: same-level successors + higher-core
    neighbours <= core for every vertex."""
    from repro_torch.core import graph_ops as G
    hi, dout = G.hi_and_dout_same(m.src, m.dst, m.valid, m.core, m.label,
                                  m.n)
    return bool(((hi + dout) <= m.core).all())


def phase_main(device, m, g, burst: int, n_mixed: int, mixed: int,
               seed: int = 0) -> dict:
    """The main path: burst removal, its re-insertion, mixed batches."""
    import torch
    from repro_torch.core.decomposition import peel_decomposition
    from repro_torch.graph.stream import mixed_stream
    from repro_torch.kernels import coremaint as K

    rng = np.random.default_rng(seed)
    edges = g.edge_array()
    sample = edges[rng.choice(edges.shape[0], size=burst, replace=False)]
    batches = [("burst remove", None, sample),
               ("burst insert", sample, None)]
    t0 = time.perf_counter()
    stream = list(mixed_stream(g, n_mixed, mixed, seed=seed))
    log(f"phase 4 mixed_stream: {n_mixed} batches of {mixed} sampled in "
        f"{time.perf_counter() - t0:.1f} s (host set-up)")
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


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.core.api import CoreMaintainer
    from repro_torch.graph.generators import rmat
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
    launches = phase_main(device, m, g, BURST, MIXED_BATCHES, MIXED_SIZE)
    for r in rows:
        r["launches"] = launches[r["name"]]
        # the unified engine fuses the mcd_hi_dout / hi_dout passes into
        # the fused wrappers; these stats serve other callers
        r["status"] = ("on the main path" if r["name"] in MAIN_PATH_KERNELS
                       else "ported, off the main path")

    log(json.dumps({"kernels": rows}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
