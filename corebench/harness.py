"""One run of one cell: set-up, the measured window, the traced pairs
(``--trace 1``), the check against the plain reference, and the metrics.

The cell, its configuration, its traffic mix and its metrics are found by
name: ``BENCHMARK.json``'s ``workloads`` entry names the configuration
(its ``file``) and the mix (``corebench/traffic/<name>.json``); each
metric is read by ``corebench/metrics/<name>.py``'s ``read(run)``.
"""
from __future__ import annotations

import contextlib
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from . import graphs, mixes, reference, tracing
from .systems import Program

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
SPANS = ("burst_remove", "burst_insert")
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
    path = root / HERE.name / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"corebench_metric_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


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


def _judge(state_of: dict, keys: torch.Tensor, n: int, traffic,
           live: torch.Tensor, last: int, rows: list) -> dict:
    """The numbers compared with the reference (see ``LIMITS``)."""
    dev = keys.device
    peeled = {}

    def ref_keys(removed):
        if removed is None:
            return keys
        return reference.remove_keys(keys, reference.edge_keys(
            traffic.chunks[removed], n, dev))

    def ref_core(removed):
        if removed not in peeled:
            peeled[removed] = reference.core_numbers(ref_keys(removed), n)
        return peeled[removed]

    core_bad = order_bad = 0
    for _, (removed, core, label) in sorted(state_of.items(),
                                            key=lambda kv: str(kv[0])):
        want = ref_core(removed)
        core = torch.as_tensor(core, device=dev).long()
        label = torch.as_tensor(label, device=dev).long()
        core_bad += int((core != want).sum())
        order_bad += reference.order_violations(ref_keys(removed), n, want,
                                                label)
    count_bad = sum(
        int(r["n_inserted"]) != r["sent_insert"]
        or int(r["n_removed"]) != r["sent_remove"] for r in rows)
    return {"core_mismatch": core_bad, "order_violations": order_bad,
            "edge_diff": reference.edge_diff(
                live, ref_keys(traffic.removed_after(last))),
            "count_mismatch": count_bad}


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device="cuda", t_start: float = None, root: Path = ROOT,
             system=Program, max_batches: int = None) -> dict:
    """One run; returns the result object (without the import guard,
    which ``run.py`` applies). ``system`` and ``max_batches`` serve the
    control runs and the tests."""
    t_start = time.perf_counter() if t_start is None else t_start
    bench = load_bench(root)
    _, config, mix = find_cell(bench, workload, root)
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    sync = _sync(dev)
    split = {}

    # ---- set-up: the graph on the device from the seed, the traffic -----
    t0 = time.perf_counter()
    n, keys, perm = graphs.generate(config, seed, dev)
    traffic = mixes.make(mix, keys, n, config["graph_seed"], seed, perm)
    keys = graphs.relabel(keys, perm, n)
    del perm
    indptr, indices = graphs.csr_arrays(keys, n)
    keys_host = keys.cpu()
    m_edges = keys.numel()
    del keys
    sync()
    split["generate_s"] = time.perf_counter() - t0
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sut = system(config, n, indptr, indices, dev)
    sync()
    split["from_graph_s"] = time.perf_counter() - t0
    log(f"{workload} seed {seed}: n={n} m={m_edges}, generated in "
        f"{split['generate_s']:.2f} s, from_graph {split['from_graph_s']:.2f} s")
    del indptr, indices
    core0, label0 = (x.cpu() for x in sut.state())
    t0 = time.perf_counter()
    warm = []
    for b in traffic.warmup():
        st = sut.apply(b.insert, b.remove)
        sync()
        warm.append(_stats_row(b, 0.0, st))
    split["warmup_s"] = time.perf_counter() - t0
    pair_s = 2 * split["warmup_s"] / len(warm)
    # the two states checked inside the window, drawn from the seed among
    # the pairs the window will surely reach (half of what the warm-up's
    # time a pair allows)
    reach = max(1, int(0.5 * seconds / max(pair_s, 1e-6)))
    if max_batches:
        reach = max(1, min(reach, max_batches // 2))
    u = np.random.default_rng(graphs.sub_seed(seed, 2)).random(2)
    sample = {2 * int(u[0] * reach): None, 2 * int(u[1] * reach) + 1: None}
    sut.reset_launches()

    # ---- the measured window ------------------------------------------------
    rows = []
    t_win = time.perf_counter()
    setup_s = t_win - t_start
    i = 0
    while True:
        b = traffic.batch(i)
        t0 = time.perf_counter()
        st = sut.apply(b.insert, b.remove)
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
    peak = torch.cuda.max_memory_allocated() if on_card else 0

    # ---- the traced pairs (--trace 1) ----------------------------------------
    traced = None
    if trace:
        traced = _trace(sut, traffic, i, rows, sync, on_card)
        i += 2 * traffic.trace_pairs
    last = i - 1

    # ---- the check ------------------------------------------------------------
    t0 = time.perf_counter()
    core_f, label_f = sut.state()
    states = {"initial": (None, core0, label0),
              "final": (traffic.removed_after(last), core_f.cpu(),
                        label_f.cpu())}
    for j, snap in sample.items():
        if snap is not None:
            states[j] = (traffic.removed_after(j), *snap)
    live = sut.live_keys()
    del sut, st, core_f, label_f
    if on_card:
        torch.cuda.empty_cache()
    batch_rows = [_stats_row(b, s, st) for b, s, st in rows]
    checks = _judge(states, keys_host.to(dev), n, traffic, live, last,
                    batch_rows + warm)
    del live
    check_s = time.perf_counter() - t0
    log(f"check: {len(states)} states against the reference in "
        f"{check_s:.2f} s")
    correct = all(checks[k] <= LIMITS[k] for k in LIMITS)
    n_window = len(rows) - (2 * traffic.trace_pairs if trace else 0)
    run = {"batches": [{k: (int(v) if torch.is_tensor(v) else v)
                        for k, v in r.items()}
                       for r in batch_rows[:n_window]],
           "window_s": window_s, "setup_s": setup_s,
           "memory_peak_bytes": peak, "launches": launches,
           "n": n, "m": m_edges, "batch_edges": len(traffic.chunks[0]),
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
    """``trace_pairs`` more pairs under ``torch.profiler``, each batch in a
    span of the benchmark's own, every kernel entry point call counted."""
    from torch.profiler import ProfilerActivity, profile, record_function

    calls = []
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                     if on_card else [])
    with profile(activities=acts) as prof, \
            _counting_calls(sut.entry_points(), calls):
        for i in range(i0, i0 + 2 * traffic.trace_pairs):
            b = traffic.batch(i)
            with record_function(SPANS[i % 2]):
                t0 = time.perf_counter()
                st = sut.apply(b.insert, b.remove)
                sync()
                rows.append((b, time.perf_counter() - t0, st))
    import repro_torch
    cu = Path(repro_torch.__file__).parent / "csrc" / "coremaint.cu"
    out = tracing.summarize(prof.events(), SPANS, tracing.kernel_names(cu))
    out["calls"] = calls
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

