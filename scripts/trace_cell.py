#!/usr/bin/env python3
"""Where a ``corebench`` cell's batch time goes, by the program's own spans
and sync counter (``repro_torch.trace``).

    python3 scripts/trace_cell.py --workload rmat-s21.burst --seed 1 --seconds 51

Runs the cell as ``corebench/run.py --trace 1`` does (the same set-up,
window, traced pairs and check), with two readings added from outside
the harness: ``corebench/spans.py``'s ``span_summary`` of the traced
pairs' profiler events, and the program's sync count over the window
(reset where the harness resets the launch count, read where it reads
it). Prints one JSON object: the run's ``correct``, its per-layer
metrics and breakdown, the span summary, the syncs by site, and these
numbers a traced batch (``api.apply_batch`` spans):

* ``api_host_ms``: the self time of ``api.apply_batch`` (validation,
  padding, window planning, upload);
* ``table_ops_ms``: the device time of the kernels launched in
  ``engine.lookup``, ``engine.tombstone``, ``engine.dedup`` and
  ``engine.alloc``;
* ``place_block_ms``: the device time of ``order.place_block``'s kernels;
* ``round_idle_ms``: the device's idle time inside ``remove.round`` and
  ``insert.round`` spans;
* ``syncs_per_batch``: the window's syncs over its batches;
* ``spill_share``: the share of the vertices that label placement's level
  pass (``kernels/order.py``) covered over the window that took its spill
  path (a level beyond the shared table), from the kernel's device-side
  tally, read after the window;

with ``span_device_share`` (the spans' device time over the traced busy
time) and the traced batches' mean latency beside the window's, by kind
(what tracing costs). Exits non-zero without a CUDA device, and 1 when
the run is not correct.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

T_START = time.perf_counter()
ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

TABLE_SPANS = ("engine.lookup", "engine.tombstone", "engine.dedup",
               "engine.alloc")
ROUND_SPANS = ("remove.round", "insert.round")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=51)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("trace_cell: no CUDA device", file=sys.stderr)
        return 2
    torch.set_num_threads(4)  # as corebench/run.py
    from corebench import harness, spans, tracing
    from corebench.systems import Program
    from repro_torch import trace
    from repro_torch.kernels import order as korder

    seen = {}

    class Counted(Program):
        def reset_launches(self):
            super().reset_launches()
            trace.reset_syncs()
            korder.reset_launches()
            korder.reset_spill_count()

        def launches(self):
            seen["syncs"] = dict(trace.SYNCS)
            seen["spilled"] = korder.spill_count()
            seen["placed"] = korder.VERTICES["place_levels"]
            return super().launches()

    summarize = tracing.summarize

    def summarize_spans(events, marks, kernels):
        seen["spans"] = spans.span_summary(events, trace.SPANS)
        seen["traced_ms"] = {m: [1e3 * (e.time_range.end
                                        - e.time_range.start) / 1e6
                                 for e in events if e.name == m
                                 and e.device_type.name == "CPU"]
                             for m in marks}
        return summarize(events, marks, kernels)

    tracing.summarize = summarize_spans
    res = harness.run_cell(args.workload, args.seed, args.seconds, True,
                           device="cuda", t_start=T_START, system=Counted)
    sp = seen["spans"]
    n = sp["api.apply_batch"]["count"]

    def per_batch(names, key):
        return 1e3 * sum(sp[s][key] for s in names if s in sp) / n

    metric = {k: v["value"] for k, v in res["metrics"].items()}
    window = {"remove": metric.get("remove_burst_ms"),
              "insert": metric.get("insert_burst_ms")}
    traced = {kind: statistics.fmean(seen["traced_ms"][m])
              for kind, m in zip(("remove", "insert"), harness.SPANS)}
    out = {
        "workload": args.workload, "seed": args.seed,
        "correct": res["correct"], "device": res["device"],
        "api_host_ms": 1e3 * sp["api.apply_batch"]["self_s"] / n,
        "table_ops_ms": per_batch(TABLE_SPANS, "device_s"),
        "place_block_ms": per_batch(("order.place_block",), "device_s"),
        "round_idle_ms": per_batch(ROUND_SPANS, "idle_s"),
        "syncs_per_batch": sum(seen["syncs"].values())
        / res["notes"]["window_batches"],
        "spill_share": seen["spilled"] / max(seen["placed"], 1),
        "spilled": seen["spilled"], "placed": seen["placed"],
        "span_device_share": sum(s["device_s"] for s in sp.values())
        / res["device"]["busy_s"],
        "batch_ms": {"window": window, "traced": traced},
        "syncs": seen["syncs"], "metrics": metric,
        "breakdown": res.get("breakdown"), "spans": sp,
        "notes": res["notes"],
    }
    print(json.dumps(out), flush=True)
    return 0 if res["correct"] else 1


if __name__ == "__main__":
    sys.exit(main())
