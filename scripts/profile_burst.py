#!/usr/bin/env python3
"""Where a burst's time goes on one CUDA card: the port's main path at
the size ``chip_smoke.py`` drives it (``rmat(21, 16_000_000, seed=0)``,
``from_graph(init="jax-peel")``), one 100,000-edge burst of live edges
removed and then re-inserted (which restores the edge set and the
cores).

    python3 scripts/profile_burst.py                # one CUDA card, nvcc
    python3 scripts/profile_burst.py --weighted     # the weighted engine
    python3 scripts/profile_burst.py --engine host  # the host engine
    python3 scripts/profile_burst.py --engine sharded --vertex-sharding range

``--weighted`` builds weighted maintainers instead
(``from_graph(weighted=True)``, weights drawn uniformly from 1-5 with
seed 1, as ``chip_smoke.py`` phase 5 does) and re-inserts the burst with
its own weights.

``--engine host`` builds an ``engine="host"`` maintainer from the same
state (its ``edge_slot`` dict built and timed before any pair), takes
turns with the kernel maintainer (host, cuda, cuda, host) and profiles
the host maintainer's pair: the seed two-call path, whose fixpoints run
plain PyTorch on the card, so its edge-pass share is 0.

``--engine sharded`` builds two sharded maintainers (a world of one NCCL
rank, ``kernel_backend="cuda"``) from the same state, one with
replicated vertex state and one with ``--vertex-sharding`` (default
``range``), takes turns (replicated, range, range, replicated) and
profiles the ``--vertex-sharding`` one's pair; under ``range`` the spans
are ``order.place_block_ring`` and the halo session's
``complete`` (the statistics' all-gather and owner scatter) and
``gather_values`` (the regathers).

1. The burst pair on two maintainers built from one state, one with the
   hand-written kernels (``kernel_backend="cuda"``) and one with the
   plain ``"torch"`` backend, in turns (torch, cuda, cuda, torch); each
   pair's removal and re-insertion wall times, ending in a device sync.
2. One more pair on the kernel maintainer (``--engine host``: the host
   maintainer) under ``torch.profiler``:
   wall time, device busy time, idle share, and the device time of the
   PyTorch ops and of the kernels that take most of it; the device time
   of the kernels launched inside ``order.place_block`` (each call
   wrapped in a ``record_function`` span for this pair only) and of the
   core-maintenance edge passes (``csrc/coremaint.cu``'s edge kernels),
   each with its share of the busy time.

Prints the card's ``nvidia-smi`` name and power limit first. Exits
non-zero without a CUDA device.
"""
from __future__ import annotations

import argparse
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

SCALE = 21
EDGES = 16_000_000
BURST = 100_000
MAX_WEIGHT = 5
SPAN = "order.place_block"
RANGE_SPANS = ("order.place_block_ring", "HaloSession.complete",
               "HaloSession.gather_values")
# the core-maintenance edge kernels of csrc/coremaint.cu
EDGE_KERNELS = re.compile(r"(unit_stat|removal_round|wsum)_kernel")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--weighted", action="store_true",
                    help="profile the weighted engine (weights 1-5)")
    ap.add_argument("--engine", default="unified",
                    choices=("unified", "host", "sharded"),
                    help="host: profile the seed two-call path; sharded: "
                         "a world of one NCCL rank")
    ap.add_argument("--vertex-sharding", default="range",
                    choices=("replicated", "range"),
                    help="--engine sharded: the layout profiled")
    args = ap.parse_args()
    if args.weighted and args.engine == "host":
        ap.error("--weighted needs a device engine")
    import torch
    if not torch.cuda.is_available():
        print("profile_burst: no CUDA device", file=sys.stderr)
        return 2
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.core import insert as core_insert
    from repro_torch.core import remove as core_remove
    from repro_torch.core import vertex_layout as core_layout
    from repro_torch.core.api import CoreMaintainer
    from repro_torch.graph.generators import rmat
    from repro_torch.kernels import build as KB
    from repro_torch.kernels import coremaint as K

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"card: {smi} | torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)
    KB.build()
    t0 = time.perf_counter()
    g = rmat(SCALE, EDGES, seed=0)
    if args.weighted:
        w0 = np.random.default_rng(1).integers(1, MAX_WEIGHT + 1, g.m)
        kern = CoreMaintainer.from_graph(g, device="cuda", weighted=True,
                                         weights=w0)
    else:
        kern = CoreMaintainer.from_graph(g, init="jax-peel", device="cuda")
    plain = CoreMaintainer.from_state(kern.state(), device="cuda",
                                      kernel_backend="torch",
                                      weighted=args.weighted)
    torch.cuda.synchronize()
    print(f"set-up: n={g.n} m={g.m} ({time.perf_counter() - t0:.1f} s)",
          flush=True)
    turns, prof_m = (plain, kern, kern, plain), kern
    if args.engine == "host":
        host = CoreMaintainer.from_state(kern.state(), device="cuda",
                                         engine="host")
        t0 = time.perf_counter()
        n_slots = len(host.edge_slot)
        print(f"host engine: edge_slot dict of {n_slots} entries built in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        turns, prof_m = (host, kern, kern, host), host
    if args.engine == "sharded":
        import datetime
        import os
        import tempfile
        import torch.distributed as dist
        from repro_torch.launch.mesh import make_edge_mesh
        torch.cuda.set_device(0)
        dist.init_process_group(
            "nccl", store=dist.FileStore(
                os.path.join(tempfile.mkdtemp(), "store"), 1),
            rank=0, world_size=1, timeout=datetime.timedelta(seconds=300))
        mesh = make_edge_mesh()
        state = kern.state()
        rep, vs = (CoreMaintainer.from_state(
            state, device="cuda", engine="sharded", mesh=mesh,
            weighted=args.weighted, vertex_sharding=v)
            for v in ("replicated", args.vertex_sharding))
        del state
        turns, prof_m = (rep, vs, vs, rep), vs

    live = torch.nonzero(kern.valid).flatten()
    pick = torch.from_numpy(np.random.default_rng(1).choice(
        live.numel(), size=BURST, replace=False)).to(live.device)
    slots = live[pick]
    sample = torch.stack([kern.src[slots], kern.dst[slots]], 1).cpu().numpy()
    weights = kern.w[slots].cpu().numpy() if args.weighted else None
    core0 = kern.core.clone()

    def burst_pair(m):
        times = []
        for ins, iw, rm in ((None, None, sample), (sample, weights, None)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m.apply_batch(insert_edges=ins, remove_edges=rm,
                          insert_weights=iw)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        if not torch.equal(torch.from_numpy(m.cores()).to(core0.device),
                           core0):
            raise RuntimeError("the burst pair did not restore the cores")
        return times

    for m in turns:
        rm_s, ins_s = burst_pair(m)
        print(f"burst pair engine={m.engine} "
              f"vertex_sharding={m.vertex_sharding} "
              f"kernel_backend={m.kernel_backend}"
              f"{' weighted' if args.weighted else ''}: "
              f"remove_s={rm_s:.4f} insert_s={ins_s:.4f}", flush=True)

    # each spanned function, wrapped where its callers look it up, for
    # the profiled pair only: (owner, attribute, span name)
    ring = prof_m.vertex_sharding == "range"
    wraps = ([(mod, "place_block_ring", RANGE_SPANS[0])
              for mod in (core_insert, core_remove)]
             + [(core_layout.HaloSession, "complete", RANGE_SPANS[1]),
                (core_layout.HaloSession, "gather_values", RANGE_SPANS[2])]
             if ring else [(mod, "place_block", SPAN)
                           for mod in (core_insert, core_remove)])
    saved = [(owner, attr, getattr(owner, attr)) for owner, attr, _ in wraps]

    def spanned(fn, name):
        def run(*a, **kw):
            with record_function(name):
                return fn(*a, **kw)
        return run

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for (owner, attr, name), (_, _, fn) in zip(wraps, saved):
            setattr(owner, attr, spanned(fn, name))
        try:
            t0 = time.perf_counter()
            K.reset_launches()
            burst_pair(prof_m)
            wall = time.perf_counter() - t0
        finally:
            for owner, attr, fn in saved:
                setattr(owner, attr, fn)
    print(f"profile launches: "
          f"{ {k: v for k, v in K.LAUNCHES.items() if v} }")
    # device kernels carry the device time; host-side ops (aten::*) show
    # the device time of the kernels they launched, so they are listed
    # apart and never summed with the kernels
    averages = prof.key_averages()
    names = {name for _, _, name in wraps}
    timed = [e for e in averages if e.self_device_time_total > 0
             and e.key not in names]  # the spans' own device ranges
    kernels = [e for e in timed if e.device_type == DeviceType.CUDA]
    ops = [e for e in timed if e.device_type != DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    print(f"profile (engine={prof_m.engine} "
          f"vertex_sharding={prof_m.vertex_sharding} "
          f"kernel_backend={prof_m.kernel_backend} burst pair under the "
          f"profiler): wall_s={wall:.4f} "
          f"device_busy_s={busy_us / 1e6:.4f} "
          f"idle_share={1 - busy_us / 1e6 / wall:.3f}")
    # a span's host event carries the device time of the kernels
    # launched inside it
    shares = [(name, sum(e.device_time_total for e in averages
                         if e.key == name
                         and e.device_type != DeviceType.CUDA))
              for name in sorted(names)]
    shares.append(("edge passes", sum(
        e.self_device_time_total for e in kernels
        if EDGE_KERNELS.search(e.key))))
    for name, us in shares:
        print(f"profile share {name}: {us / 1e3:.3f} ms "
              f"{us / busy_us:.3f} of device busy")
    for kind, evs, top in (("op", ops, 8), ("kernel", kernels, 10)):
        for e in sorted(evs, key=lambda e: -e.self_device_time_total)[:top]:
            print(f"profile {kind:6s} "
                  f"{e.self_device_time_total / 1e3:9.3f} ms x{e.count:<5d} "
                  f"{e.key[:80]}")
    if args.engine == "sharded":
        import torch.distributed as dist
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
