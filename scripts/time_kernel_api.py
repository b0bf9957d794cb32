#!/usr/bin/env python3
"""Times the kernel API's ELL and FM kernels on one CUDA card at
``chip_smoke.py`` phase 6's shapes.

Rows: ``ell_stat`` on the ELL matrix of ``erdos_renyi(2**21, 16_000_000,
seed=0)`` with its core numbers as values: the four ops on int32 cores,
``sum`` and ``max`` on float32 cores plus seeded noise (``0.1 *
randn``, seed 1, as phase 6 draws it), ``count_ge`` and ``sum`` on int64
cores, beside ``torch.index_select`` of the int32 cores at the live ids
in row order and sorted (the same gathers alone, random and sequential:
a yardstick of the card's gather rate, which the port never calls);
``ell_aggregate`` (sum and max, float32 and bfloat16) on the same
matrix with ``[n, 100]`` features, each beside
``torch.nn.functional.embedding_bag`` over the same features with a zero
row appended (the library yardstick and this script's control: the port
never calls it); ``fm_interaction`` at DeepFM's ``serve_bulk``
``[262144, 39, 10]`` and ``serve_p99`` ``[512, 39, 10]``, float32 and
bfloat16.

    python3 scripts/time_kernel_api.py [--state FILE] [--repeats 5] [--iters 20] [--only ell_stat]
    python3 scripts/time_kernel_api.py --sass   # instruction counts only

Each repeat times every row with CUDA events (mean of ``--iters`` launches
after a warm-up), the rows in turns (forward on even repeats, backward on
odd ones), and the last line is a JSON object of each row's median. Each
``fm_interaction`` row is timed twice: as called (``--iters`` calls one
after another, which at ``[512, 39, 10]`` measures the host's time a
call) and as the replay of a CUDA graph of those calls (rows ending in
``graph``: the kernel's time on the card). Every row is held once to its
plain version first: ``ell_stat``, ``index_select`` and
``ell_aggregate`` bit for bit (``torch.equal``; the kernels fold in
column order), ``embedding_bag`` within
rtol/atol 1e-5 (float32 sum), 2e-2 (bfloat16 sum) or 0 (max),
``fm_interaction`` within 1e-4 (float32) or 1e-2 (bfloat16). Before the
medians, a ``bound`` line a ``ell_stat`` row gives its byte bound (nbrs,
the values and the output once, over 3.35 TB/s), its share of it, and
its gather figure (each live neighbour's gather as one whole 32-byte
sector, plus nbrs and the output, as ``chip_smoke.gather_bytes`` counts
``ell_aggregate``'s). ``--only S`` times only the rows whose name holds
S. Prints the card's ``nvidia-smi`` name and power limit first.

``--state FILE`` keeps the ELL matrix and the core numbers in FILE (about
330 MB): the first run builds them (the ER graph and ``ell_from_csr`` on
the host, the cores by the device peel of ``CoreMaintainer.from_graph``,
about 20 s on the H100 machine) and saves them, later runs load them;
the features and embeddings are drawn on the card from seed 0 as
``chip_smoke.py`` draws them. To compare two checkouts, copy this script
into the other checkout's ``scripts/`` (it calls only ``ell_stat``,
``ell_aggregate``, ``fm_interaction`` and their plain versions, which
both trees have) and run each copy with one ``--state`` on one card, one
after another: parent, change, change, parent.

``--sass`` prints instead, for every ``ell_stat_kernel``,
``ell_aggregate_kernel`` and ``fm_kernel`` instance of the checkout's
built library (``cuobjdump -sass``), how many global loads of each width
(``LDG``), shared loads and stores (``LDS``, ``STS``), shuffles
(``SHFL``), warp votes (``VOTE``), block barriers (``BAR``), bulk copies
(``UBLKCP``), ``cp.async`` copies (``LDGSTS``) and barrier operations
(``SYNCS``) its code holds, and its registers and spills from ``ptxas
-v``. Exits non-zero without a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

ER_N = 2**21        # chip_smoke.ER_N
ER_M = 16_000_000
D_FEAT = 100
FM_SHAPES = ((262_144, 39, 10), (512, 39, 10))
SASS_KERNELS = ("ell_stat_kernel", "ell_aggregate_kernel", "fm_kernel")
# ell_stat's rows: (op, values) on the core numbers
STAT_ROWS = (("count_ge", "i32"), ("count_gt", "i32"), ("sum", "i32"),
             ("max", "i32"), ("sum", "f32"), ("max", "f32"),
             ("count_ge", "i64"), ("sum", "i64"))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory


def time_ms(fn, iters: int, graph: bool = False) -> float:
    """Mean time of one of ``iters`` back-to-back calls after a warm-up,
    with CUDA events. ``graph``: the calls are captured in one CUDA graph
    and its replay is timed, so the host's time between launches (which
    bounds a call of a few microseconds) is left out."""
    import torch
    if graph:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(iters):
                fn()
        run = g.replay
    else:
        def run():
            for _ in range(iters):
                fn()
    run()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def sass_counts() -> dict:
    """``{kernel instance: {instruction: count}}`` for the kernels of
    ``SASS_KERNELS`` in the checkout's library, from ``cuobjdump -sass``,
    with ``registers`` and ``spills`` (bytes stored and loaded) from
    ``ptxas -v``."""
    from repro_torch.kernels import build as KB

    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    text = subprocess.run([tool, "-sass", str(KB.build())],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    parts = re.split(r"Function : (\S+)", text)
    usage = KB.ptxas_usage("")
    out = {}
    for name, body in zip(parts[1::2], parts[2::2]):
        hit = [k for k in SASS_KERNELS if k in name]
        if not hit:
            continue
        # the instance: the kernel's name and its template arguments
        short = name[name.index(hit[0]):].split("EEv")[0] + "E"
        ops = re.findall(
            r"\b((?:LDG|LDS|STS|SHFL|VOTE|BAR|UBLKCP|LDGSTS|SYNCS)[.\w]*)",
            body)
        counts = {}
        for op in ops:
            counts[op] = counts.get(op, 0) + 1
        out[short] = dict(sorted(counts.items()))
        use = usage.get(name, {})
        out[short].update(registers=use.get("registers"), spills=[
            use.get("spill_stores"), use.get("spill_loads")])
    return out


def build_state() -> dict:
    """The ELL matrix of chip_smoke.py phase 6 (on the host) and the
    graph's core numbers (the device peel, as phase 6 computes them)."""
    import torch
    from repro_torch.core.api import CoreMaintainer
    from repro_torch.graph.csr import ell_from_csr
    from repro_torch.graph.generators import erdos_renyi

    g = erdos_renyi(ER_N, ER_M, seed=0)
    core = CoreMaintainer.from_graph(g, init="jax-peel", device="cuda").core
    return {"nbrs": torch.from_numpy(ell_from_csr(g).nbrs),
            "core": core.cpu()}


def stat_values(core) -> dict:
    """``ell_stat``'s values by tag: the int32 cores, float32 cores plus
    seeded noise (chip_smoke.py phase 6's), int64 cores."""
    import torch
    gen = torch.Generator(device=core.device).manual_seed(1)
    noise = 0.1 * torch.randn(core.shape, generator=gen, device=core.device)
    return {"i32": core, "f32": core.float() + noise, "i64": core.long()}


def close(got, want, tol) -> bool:
    import torch
    if tol == 0:
        return torch.equal(got, want)
    return torch.allclose(got.float(), want.float(), rtol=tol, atol=tol)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--state", type=Path, default=None,
                    help="load the ELL matrix from FILE, or build and "
                         "save it there")
    ap.add_argument("--repeats", type=int, default=5,
                    help="timed repeats (0: build or load the state only)")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--only", default="",
                    help="time only the rows whose name holds this")
    ap.add_argument("--sass", action="store_true",
                    help="print the kernels' instruction counts and exit")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("time_kernel_api: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import fm_interaction as FM
    from repro_torch.kernels import segment_ell as SE

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.splitlines()[0], flush=True)
    print(f"source: {Path(SE.__file__).resolve()}", flush=True)
    if args.sass:
        for name, counts in sass_counts().items():
            print(f"sass {name}: {json.dumps(counts)}")
        return 0
    t0 = time.perf_counter()
    if args.state is not None and args.state.exists():
        state = torch.load(args.state)
    else:
        state = build_state()
        if args.state is not None:
            args.state.parent.mkdir(parents=True, exist_ok=True)
            torch.save(state, args.state)
    nbrs = state["nbrs"].to("cuda")
    core = state["core"].to("cuda")
    del state
    n, d = nbrs.shape
    print(f"state: nbrs=[{n}, {d}] neighbours={int((nbrs < n).sum())} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    if args.repeats == 0:
        return 0

    gen = torch.Generator(device="cuda").manual_seed(0)
    feats = torch.randn((n, D_FEAT), generator=gen, device="cuda")
    emb = torch.randn(FM_SHAPES[0], generator=gen, device="cuda")
    checks, bounds = {}, {}
    live = int((nbrs < n).sum())  # this graph has no negative ids
    svals = stat_values(core)
    for op, tag in STAT_ROWS:
        vals = svals[tag]
        name = f"ell_stat[{op},{tag}]"
        checks[name] = (
            lambda op=op, v=vals: SE.ell_stat(nbrs, v, v, op),
            lambda op=op, v=vals: SE.ell_stat_plain(nbrs, v, v, op), 0)
        size = vals.element_size()
        bounds[name] = (4 * nbrs.numel() + 2 * size * n,
                        32 * live + 4 * nbrs.numel() + size * n)
    ids = nbrs[nbrs < n]
    for name, at in (("live ids", ids), ("sorted ids", ids.sort().values)):
        checks[f"index_select[{name}]"] = (
            lambda at=at: torch.index_select(core, 0, at),
            lambda at=at: core[at.long()], 0)
    for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        fe = feats.to(dtype)
        fe_ext = torch.cat([fe, fe.new_zeros((1, D_FEAT))])
        for op in ("sum", "max"):
            checks[f"ell_aggregate[{op},{tag}]"] = (
                lambda op=op, fe=fe: SE.ell_aggregate(nbrs, fe, op),
                lambda op=op, fe=fe: SE.ell_aggregate_plain(nbrs, fe, op), 0)
            checks[f"embedding_bag[{op},{tag}]"] = (
                lambda op=op, t=fe_ext: torch.nn.functional.embedding_bag(
                    nbrs, t, mode=op, padding_idx=n),
                lambda op=op, fe=fe: SE.ell_aggregate_plain(nbrs, fe, op),
                (1e-5 if tag == "f32" else 2e-2) if op == "sum" else 0)
        for shape in FM_SHAPES:
            e = emb[:shape[0]].to(dtype)
            checks[f"fm_interaction[{tag}] {list(shape)}"] = (
                lambda e=e: FM.fm_interaction(e),
                lambda e=e: FM.fm_interaction_plain(e),
                1e-4 if tag == "f32" else 1e-2)
    if args.only:
        checks = {k: v for k, v in checks.items() if args.only in k}
    fns = {}
    for name, (run, plain, tol) in checks.items():
        if not close(run(), plain(), tol):
            print(f"time_kernel_api: {name} differs from the plain version",
                  file=sys.stderr)
            return 1
        fns[name] = (run, False)
        if name.startswith("fm_interaction"):
            fns[f"{name} graph"] = (run, True)
    del checks
    torch.cuda.synchronize()
    print("every row == its plain version (ell_stat and ell_aggregate bit "
          "for bit)", flush=True)

    ms = {k: [] for k in fns}
    for r in range(args.repeats):
        order = list(fns) if r % 2 == 0 else list(fns)[::-1]
        for k in order:
            ms[k].append(time_ms(fns[k][0], args.iters, graph=fns[k][1]))
        print(f"repeat {r}: " + ", ".join(f"{k} {ms[k][-1]:.4f} ms"
                                          for k in fns), flush=True)
    med = {k: float(np.median(t)) for k, t in ms.items()}
    for k, (nbytes, gbytes) in bounds.items():
        if k in med:
            b_ms = nbytes / HBM_BYTES_PER_S * 1e3
            g_ms = gbytes / HBM_BYTES_PER_S * 1e3
            print(f"bound {k}: ms={med[k]:.4f} bytes={nbytes} "
                  f"bound_ms={b_ms:.4f} share={b_ms / med[k]:.3f} "
                  f"gather_bytes={gbytes} gather_ms={g_ms:.4f}")
    print(json.dumps(med))
    return 0


if __name__ == "__main__":
    sys.exit(main())
