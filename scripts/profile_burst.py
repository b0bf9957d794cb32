#!/usr/bin/env python3
"""Where a burst's time goes on one CUDA card: the port's main path at
the size ``chip_smoke.py`` drives it (``rmat(21, 16_000_000, seed=0)``,
``from_graph(init="jax-peel")``), one 100,000-edge burst of live edges
removed and then re-inserted (which restores the edge set and the
cores).

    python3 scripts/profile_burst.py              # needs one CUDA card and nvcc
    python3 scripts/profile_burst.py --weighted   # the weighted engine

``--weighted`` builds weighted maintainers instead
(``from_graph(weighted=True)``, weights drawn uniformly from 1-5 with
seed 1, as ``chip_smoke.py`` phase 5 does) and re-inserts the burst with
its own weights.

1. The burst pair on two maintainers built from one state, one with the
   hand-written kernels (``kernel_backend="cuda"``) and one with the
   plain ``"torch"`` backend, in turns (torch, cuda, cuda, torch); each
   pair's removal and re-insertion wall times, ending in a device sync.
2. One more pair on the kernel maintainer under ``torch.profiler``:
   wall time, device busy time, idle share, and the device time of the
   PyTorch ops and of the kernels that take most of it.

Prints the card's ``nvidia-smi`` name and power limit first. Exits
non-zero without a CUDA device.
"""
from __future__ import annotations

import argparse
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--weighted", action="store_true",
                    help="profile the weighted engine (weights 1-5)")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("profile_burst: no CUDA device", file=sys.stderr)
        return 2
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.api import CoreMaintainer
    from repro_torch.graph.generators import rmat
    from repro_torch.kernels import coremaint as K

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"card: {smi} | torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)
    K.build()
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
        if not torch.equal(m.core, core0):
            raise RuntimeError("the burst pair did not restore the cores")
        return times

    for m in (plain, kern, kern, plain):
        rm_s, ins_s = burst_pair(m)
        print(f"burst pair kernel_backend={m.kernel_backend}"
              f"{' weighted' if args.weighted else ''}: "
              f"remove_s={rm_s:.4f} insert_s={ins_s:.4f}", flush=True)

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        K.reset_launches()
        burst_pair(kern)
        wall = time.perf_counter() - t0
    print(f"profile launches: "
          f"{ {k: v for k, v in K.LAUNCHES.items() if v} }")
    # device kernels carry the device time; host-side ops (aten::*) show
    # the device time of the kernels they launched, so they are listed
    # apart and never summed with the kernels
    timed = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    kernels = [e for e in timed if e.device_type == DeviceType.CUDA]
    ops = [e for e in timed if e.device_type != DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    print(f"profile (cuda burst pair under the profiler): wall_s={wall:.4f} "
          f"device_busy_s={busy_us / 1e6:.4f} "
          f"idle_share={1 - busy_us / 1e6 / wall:.3f}")
    for kind, evs, top in (("op", ops, 8), ("kernel", kernels, 10)):
        for e in sorted(evs, key=lambda e: -e.self_device_time_total)[:top]:
            print(f"profile {kind:6s} "
                  f"{e.self_device_time_total / 1e3:9.3f} ms x{e.count:<5d} "
                  f"{e.key[:80]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
