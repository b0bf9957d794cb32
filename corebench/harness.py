"""One run of one cell: set-up, the measured window, the traced batches
(``--trace 1``), the check against the plain reference, and the metrics.

Everything is found by name: ``BENCHMARK.json``'s ``workloads`` entry
names the configuration (its ``file``) and the mix
(``corebench/traffic/<name>.json``); the configuration names its
generator (``corebench/generators/<name>.py``, see ``graphs.py``) and
optionally its reference (``corebench/references/<name>.py``, default
``kcore``); the mix names its kind (``corebench/kinds/<kind>.py``, see
``mixes.py``); each metric is read by ``corebench/metrics/<name>.py``'s
``read(run)``. Nothing here branches on any of those names.
"""
from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from . import graphs, mixes, parts, spans, tracing
from .systems import Program

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# the benchmark's span around each traced batch, by the batch's kind
SPANS = ("burst_remove", "burst_insert", "burst_mixed")
DEFAULT_REFERENCE = "kcore"
# the numbers compared with the reference, each with its limit: every one
# is an exact comparison, so every limit is 0
LIMITS = {"core_mismatch": 0, "order_violations": 0, "edge_diff": 0,
          "count_mismatch": 0}


def log(msg: str) -> None:
    print(f"corebench: {msg}", file=sys.stderr, flush=True)


def load_bench(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def find_cell(bench: dict, workload: str, root: Path = ROOT) -> tuple:
    """``(cell, config, mix)`` of a workload, by name."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[cell["config"]]["file"]).read_text())
    mix = json.loads((root / HERE.name / "traffic"
                      / f"{cell['traffic']}.json").read_text())
    return cell, config, mix


def metric_names(bench: dict, workload: str, trace: bool) -> list:
    """The metrics a run of this cell reports: end-to-end ones without
    ``--trace``, per-layer ones with it; a metric with ``workloads``
    only in those cells."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [(m["name"], m["unit"]) for m in group
            if workload in m.get("workloads", [workload])]


def reader(name: str, root: Path = ROOT):
    """``read(run)`` of ``corebench/metrics/<name>.py``."""
    return parts.load("metrics", name, root).read


def _sync(dev: torch.device):
    return torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)


@contextlib.contextmanager
def _counting_calls(points, calls: list):
    """Wrap each kernel entry point so each call appends ``(entry, stat,
    window slots)``; restored on exit."""
    saved = [(mod, name, getattr(mod, name)) for mod, name in points]

    def wrap(fn, name):
        def counted(src, *a, **kw):
            stat = kw.get("stat", a[5] if name == "coo_stat" and len(a) > 5
                          else "mcd_hi_dout")
            calls.append((name, stat, int(src.shape[0])))
            return fn(src, *a, **kw)
        return counted

    try:
        for mod, name, fn in saved:
            setattr(mod, name, wrap(fn, name))
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def _stats_row(batch, seconds: float, st) -> dict:
    row = {"kind": batch.kind, "edits": batch.edits, "seconds": seconds,
           "sent_insert": len(batch.insert), "sent_remove": len(batch.remove)}
    for f in ("n_inserted", "n_removed", "remove_rounds", "insert_rounds",
              "n_promoted", "v_plus"):
        row[f] = st[f] if isinstance(st, dict) else getattr(st, f)
    return row


def _judge(reference, n: int, traffic, states: dict, last: int,
           live: tuple, rows: list, dev: torch.device) -> dict:
    """The numbers compared with the reference (see ``LIMITS``).
    ``states`` maps each checked step to the program's ``(core, label)``
    there; the traffic gives the edge set each step implies, and each
    distinct set goes to the reference once, with every state that should
    hold it."""
    expected, want = [], None
    for step, state in sorted(states.items()):
        keys, weights = traffic.live(step, dev)
        for k, w, held in expected:
            if torch.equal(k, keys) and (w is None) == (weights is None) \
                    and (w is None or torch.equal(w, weights)):
                held.append(state)
                keys, weights = k, w
                break
        else:
            expected.append((keys, weights, [state]))
        if step == last:
            want = (keys, weights)
    return reference.check(n, expected, live, want, rows)


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device="cuda", t_start: float = None, root: Path = ROOT,
             system=Program, max_batches: int = None,
             warmup: bool = True) -> dict:
    """One run; returns the result object (without the import guard,
    which ``run.py`` applies). ``system``, ``max_batches`` and ``warmup``
    (False: the window starts at the traffic's step 0) serve the control
    runs and the tests."""
    t_start = time.perf_counter() if t_start is None else t_start
    bench = load_bench(root)
    _, config, mix = find_cell(bench, workload, root)
    reference = parts.load("references",
                           config.get("reference", DEFAULT_REFERENCE), root)
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    sync = _sync(dev)
    split = {}

    # ---- set-up: the graph on the device from the seed, the traffic -----
    t0 = time.perf_counter()
    g = graphs.generate(config, seed, dev, root)
    traffic = mixes.make(mix, g, config["graph_seed"], seed, root)
    n = g.n
    keys, weights = g.relabelled
    del g
    indptr, indices = graphs.csr_arrays(keys, n)
    m_edges = keys.numel()
    weights = None if weights is None else weights.cpu().numpy()
    del keys
    sync()
    split["generate_s"] = time.perf_counter() - t0
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sut = system(config, n, indptr, indices, dev, weights=weights)
    sync()
    split["from_graph_s"] = time.perf_counter() - t0
    log(f"{workload} seed {seed}: n={n} m={m_edges}, generated in "
        f"{split['generate_s']:.2f} s, from_graph {split['from_graph_s']:.2f} s")
    del indptr, indices, weights
    core0, label0 = (x.cpu() for x in sut.state())
    t0 = time.perf_counter()
    warm = []
    for b in (traffic.warmup() if warmup else []):
        st = sut.apply(b.insert, b.remove, b.insert_weights)
        sync()
        warm.append(_stats_row(b, 0.0, st))
    split["warmup_s"] = time.perf_counter() - t0
    # the two states checked inside the window, drawn from the seed among
    # the pairs of batches the window will surely reach (half of what the
    # warm-up's time a pair allows)
    reach = 1
    if warm:
        pair_s = 2 * split["warmup_s"] / len(warm)
        reach = max(1, int(0.5 * seconds / max(pair_s, 1e-6)))
    if max_batches:
        reach = max(1, min(reach, max_batches // 2))
    u = np.random.default_rng(graphs.sub_seed(seed, 2)).random(2)
    sample = {2 * int(u[0] * reach): None, 2 * int(u[1] * reach) + 1: None}
    sut.reset_launches()

    # ---- the measured window ------------------------------------------------
    step0 = len(warm)  # the traffic's step of the window's first batch
    rows = []
    t_win = time.perf_counter()
    setup_s = t_win - t_start
    i = 0
    while True:
        b = traffic.batch(step0 + i)
        t0 = time.perf_counter()
        st = sut.apply(b.insert, b.remove, b.insert_weights)
        sync()
        t1 = time.perf_counter()
        rows.append((b, t1 - t0, st))
        if i in sample:
            sample[i] = tuple(x.cpu() for x in sut.state())
        i += 1
        if t1 - t_win >= seconds or (max_batches and i >= max_batches):
            break
    window_s = t1 - t_win
    log(f"window: {len(rows)} batches in {window_s:.2f} s after a "
        f"{setup_s:.2f} s set-up (warm-up {split['warmup_s']:.3f} s)")
    launches = sut.launches()
    syncs = sut.syncs()
    peak = torch.cuda.max_memory_allocated() if on_card else 0

    # ---- the traced batches (--trace 1) --------------------------------------
    traced = None
    if trace:
        traced = _trace(sut, traffic, step0 + i, rows, sync, on_card)
        i += traffic.trace_batches
    last = step0 + i - 1

    # ---- the check ------------------------------------------------------------
    t0 = time.perf_counter()
    core_f, label_f = sut.state()
    states = {-1: (core0, label0), last: (core_f.cpu(), label_f.cpu())}
    for j, snap in sample.items():
        if snap is not None:
            states.setdefault(step0 + j, snap)
    live = sut.live_keys()
    del sut, st, core_f, label_f
    if on_card:
        torch.cuda.empty_cache()
    batch_rows = [_stats_row(b, s, st) for b, s, st in rows]
    checks = _judge(reference, n, traffic, states, last, live,
                    batch_rows + warm, dev)
    del live
    check_s = time.perf_counter() - t0
    log(f"check: {len(states)} states against the reference in "
        f"{check_s:.2f} s")
    correct = all(checks[k] <= LIMITS[k] for k in LIMITS)
    n_window = len(rows) - (traffic.trace_batches if trace else 0)
    run = {"batches": [{k: (int(v) if torch.is_tensor(v) else v)
                        for k, v in r.items()}
                       for r in batch_rows[:n_window]],
           "window_s": window_s, "setup_s": setup_s,
           "memory_peak_bytes": peak, "launches": launches, "syncs": syncs,
           "n": n, "m": m_edges,
           "batch_edges": max(r["sent_remove"] for r in batch_rows),
           "trace": traced}
    metrics = {}
    for name, unit in metric_names(bench, workload, trace):
        value = reader(name, root)(run)
        if value is not None:
            metrics[name] = {"value": value, "unit": unit}
    result = {
        "correct": correct,
        "attempted": len(rows),
        "failed": checks["count_mismatch"],
        "metrics": metrics,
        "device": _device(dev, peak, traced),
    }
    if traced and traced.get("breakdown"):
        result["breakdown"] = traced["breakdown"]
    lat = [r["seconds"] for r in run["batches"]]
    result["notes"] = {**split, "setup_s": setup_s, "check_s": check_s,
                       "window_batches": n_window, "n": n, "m": m_edges,
                       "states_checked": len(states),
                       "kmax": int(core0.max()),
                       "first_20_batches_ms": 1e3 * float(np.mean(lat[:20])),
                       "last_20_batches_ms": 1e3 * float(np.mean(lat[-20:]))}
    result["checks"] = {k: {"value": checks[k], "limit": LIMITS[k]}
                        for k in LIMITS}
    return result


def _trace(sut, traffic, i0: int, rows: list, sync, on_card: bool) -> dict:
    """``trace_batches`` more steps under the profiler, each batch in a
    span of the benchmark's own named after its kind, every kernel entry
    point call counted; the program's own spans summed by
    ``spans.span_summary``.

    The profiler is ``torch.autograd.profiler.profile``, which
    ``torch.profiler.profile`` wraps: the wrapper's start imports
    ``torch._inductor`` (and with it ``torch._dynamo``), seconds of
    imports that the run would pay and the trace does not need."""
    from torch.autograd.profiler import profile, record_function

    calls = []
    t0 = time.perf_counter()
    with profile(use_cpu=True, use_device="cuda" if on_card else None,
                 use_kineto=True) as prof, \
            _counting_calls(sut.entry_points(), calls):
        for i in range(i0, i0 + traffic.trace_batches):
            b = traffic.batch(i)
            with record_function(f"burst_{b.kind}"):
                t1 = time.perf_counter()
                st = sut.apply(b.insert, b.remove, b.insert_weights)
                sync()
                rows.append((b, time.perf_counter() - t1, st))
    log(f"trace: {traffic.trace_batches} batches traced in "
        f"{time.perf_counter() - t0:.2f} s with the profiler's start and stop")
    t0 = time.perf_counter()
    import repro_torch
    cu = Path(repro_torch.__file__).parent / "csrc" / "coremaint.cu"
    events = prof.function_events
    t1 = time.perf_counter()
    out = tracing.summarize(events, SPANS, tracing.kernel_names(cu))
    out["calls"] = calls
    t2 = time.perf_counter()
    out["spans"] = spans.span_summary(events, spans.program_spans())
    log(f"trace: {len(events)} events read in {t1 - t0:.2f} s, summed in "
        f"{t2 - t1:.2f} s and {time.perf_counter() - t2:.2f} s (spans)")
    return out


def _power_limit() -> str:
    """The card's power limit as ``nvidia-smi`` reads it (a card may be
    set below its 700 W, and then runs slower under load)."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "unknown"


def _device(dev: torch.device, peak: int, traced) -> dict:
    on_card = dev.type == "cuda"
    out = {"platform": "gpu" if on_card else dev.type,
           "kind": torch.cuda.get_device_name(dev) if on_card else "cpu",
           "count": 1, "memory_peak_bytes": peak}
    if on_card:
        out["power_limit"] = _power_limit()
    if traced is not None and "busy_s" in traced:
        out["busy_s"] = traced["busy_s"]
        out["window_s"] = traced["window_s"]
    return out

