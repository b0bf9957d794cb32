#!/usr/bin/env python3
"""Where GNN serving spends its time on one CUDA card, at
``chip_smoke.py`` phase 9's cells, TF32 off:

* PNA ``full()`` on ``ogb_products`` (``chip_smoke.ogb_products_batch``:
  2,449,408 nodes, 61,859,328 edges, 100 features): the forward's wall
  (CUDA events, the mean of 3 calls after a warm-up), the
  ops of one layer's message passing over ``[E, 75]`` messages timed
  alone (the gather, the mask fill, a sum, the square, the max and the
  min), and one forward under ``torch.profiler``;
* NequIP ``full()`` on ``molecule`` (128 molecules of 30 atoms, 64 edges
  each): one energy-and-forces call and one energy forward under the
  profiler.

A profile line gives the host wall of the call, the device time of its
kernels, the idle share, the number of kernel launches, and the ops
(``aten::*``, by the device time of the kernels each launched itself)
and kernels that took the most device time, with their shares.

    python3 scripts/time_gnn.py

Prints the card's ``nvidia-smi`` name and power limit, one line a row,
and a last JSON line of every row. Exits non-zero without a CUDA device.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

REPEATS = 3  # timed calls a row, after a warm-up
TOP = 8      # ops and kernels listed a profile


def time_ms(fn) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(REPEATS):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / REPEATS


def profile(name: str, fn) -> dict:
    """One warm call, then one call under ``torch.profiler``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile

    fn()
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    timed = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    kernels = [e for e in timed if e.device_type == DeviceType.CUDA]
    ops = [e for e in timed if e.device_type != DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    launches = sum(e.count for e in kernels)
    out = dict(wall_ms=wall_us / 1e3, device_busy_ms=busy_us / 1e3,
               idle_share=1 - busy_us / wall_us, launches=launches,
               ops=[], kernels=[])
    print(f"profile {name}: wall_ms={out['wall_ms']:.4f} "
          f"device_busy_ms={out['device_busy_ms']:.4f} "
          f"idle_share={out['idle_share']:.4f} launches={launches}",
          flush=True)
    for kind, evs in (("ops", ops), ("kernels", kernels)):
        for e in sorted(evs, key=lambda e: -e.self_device_time_total)[:TOP]:
            us = e.self_device_time_total
            out[kind].append(dict(name=e.key, ms=us / 1e3, count=e.count,
                                  share=us / busy_us))
            print(f"profile {name} {kind[:-1]:6s} {us / 1e3:10.4f} ms "
                  f"{us / busy_us:6.4f} x{e.count:<5d} {e.key[:90]}",
                  flush=True)
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("time_gnn: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from repro_torch.configs import nequip, pna
    from repro_torch.configs.common import GNN_SHAPES
    from repro_torch.data.graphs import random_molecule_batch
    from repro_torch.models import gnn as G

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    cells = {c.name: c.params for c in GNN_SHAPES}
    cell = cells["ogb_products"]
    batch = chip_smoke.ogb_products_batch("cuda", cell)
    n, e = batch.node_feat.shape[0], batch.senders.shape[0]
    snd, rcv = batch.senders, batch.receivers
    cfg = dataclasses.replace(pna.full(), d_in=cell["d_feat"])
    model = G.pna_init(cfg, torch.Generator().manual_seed(0), device="cuda")
    d = cfg.d_hidden
    rows = {}

    def row(name, ms, **kw):
        rows[name] = dict(ms=ms, **kw)
        print(f"{name}: {ms:.4f} ms {kw if kw else ''}", flush=True)

    with torch.no_grad():
        row("pna_forward", time_ms(lambda: model(batch)),
            nodes=n, edges=e)
        hp = torch.randn(n, d, device="cuda")
        msg = torch.index_select(hp, 0, snd)
        dead = ~batch.edge_mask[:, None]
        row("index_select", time_ms(lambda: torch.index_select(hp, 0, snd)))
        row("masked_fill_", time_ms(lambda: msg.masked_fill_(dead, 0.0)))
        row("index_add_", time_ms(lambda: G._seg_sum(msg, rcv, n)))
        row("msg * msg", time_ms(lambda: msg * msg))
        for op, fill in (("amax", -1e30), ("amin", 1e30)):
            row(f"scatter_reduce_ {op}", time_ms(
                lambda op=op, fill=fill: G._seg_reduce_clamped(
                    msg, rcv, n, fill, op)))
        del hp, msg, dead
        torch.cuda.empty_cache()
        rows["profile pna_forward ogb_products"] = profile(
            "pna_forward ogb_products", lambda: model(batch))
    del model, batch, snd, rcv
    torch.cuda.empty_cache()

    cell = cells["molecule"]
    mol = random_molecule_batch(n_mols=cell["batch"],
                                n_atoms=cell["n_nodes"],
                                n_edges=cell["n_edges"], device="cuda")
    nq = G.nequip_init(nequip.full(), torch.Generator().manual_seed(0),
                       device="cuda")
    rows["profile nequip energy_forces molecule"] = profile(
        "nequip energy_forces molecule", lambda: nq.energy_forces(mol))
    with torch.no_grad():
        rows["profile nequip energy molecule"] = profile(
            "nequip energy molecule", lambda: nq(mol))
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "nvidia_smi": smi, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
