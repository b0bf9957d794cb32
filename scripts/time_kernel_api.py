#!/usr/bin/env python3
"""Times the kernel API's gather and FM kernels on one CUDA card at
``chip_smoke.py`` phase 6's shapes.

Rows: ``ell_aggregate`` (sum and max, float32 and bfloat16) on the ELL
matrix of ``erdos_renyi(2**21, 16_000_000, seed=0)`` with ``[n, 100]``
features, each beside ``torch.nn.functional.embedding_bag`` over the same
features with a zero row appended (the library yardstick and this
script's control: the port never calls it); ``fm_interaction`` at
DeepFM's ``serve_bulk`` ``[262144, 39, 10]`` and ``serve_p99``
``[512, 39, 10]``, float32 and bfloat16.

    python3 scripts/time_kernel_api.py [--state FILE] [--repeats 5] [--iters 20]
    python3 scripts/time_kernel_api.py --sass   # instruction counts only

Each repeat times every row with CUDA events (mean of ``--iters`` launches
after a warm-up), the rows in turns (forward on even repeats, backward on
odd ones), and the last line is a JSON object of each row's median. Each
``fm_interaction`` row is timed twice: as called (``--iters`` calls one
after another, which at ``[512, 39, 10]`` measures the host's time a
call) and as the replay of a CUDA graph of those calls (rows ending in
``graph``: the kernel's time on the card). Every row is held once to its
plain version first: ``ell_aggregate`` bit for bit (``torch.equal``: both
fold in column order), ``embedding_bag`` within rtol/atol 1e-5 (float32
sum), 2e-2 (bfloat16 sum) or 0 (max), ``fm_interaction`` within 1e-4
(float32) or 1e-2 (bfloat16). Prints the card's ``nvidia-smi`` name and
power limit first.

``--state FILE`` keeps the ELL matrix in FILE (about 320 MB): the first
run builds it (the ER graph and ``ell_from_csr`` on the host, about 20 s
on the H100 machine) and saves it, later runs load it; the features and
embeddings are drawn on the card from seed 0 as ``chip_smoke.py`` draws
them. To compare two checkouts, copy this script into the other
checkout's ``scripts/`` (it calls only ``ell_aggregate``,
``fm_interaction`` and their plain versions, which both trees have) and
run each copy with one ``--state`` on one card, one after another:
parent, change, change, parent.

``--sass`` prints instead, for every ``ell_aggregate_kernel`` and
``fm_kernel`` instance of the checkout's built library (``cuobjdump
-sass``), how many global loads of each width (``LDG``), shared loads
(``LDS``), shuffles (``SHFL``), warp votes (``VOTE``), bulk copies
(``UBLKCP``), ``cp.async`` copies (``LDGSTS``) and barrier operations
(``SYNCS``) its code holds. Exits non-zero without a CUDA device.
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
SASS_KERNELS = ("ell_aggregate_kernel", "fm_kernel")


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
    """``{kernel instance: {instruction: count}}`` for the two kernels of
    the checkout's library, from ``cuobjdump -sass``."""
    from repro_torch.kernels import build as KB

    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    text = subprocess.run([tool, "-sass", str(KB.build())],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    parts = re.split(r"Function : (\S+)", text)
    out = {}
    for name, body in zip(parts[1::2], parts[2::2]):
        hit = [k for k in SASS_KERNELS if k in name]
        if not hit:
            continue
        # the instance: the kernel's name and its template arguments
        short = name[name.index(hit[0]):].split("EEv")[0] + "E"
        ops = re.findall(
            r"\b((?:LDG|LDS|SHFL|VOTE|UBLKCP|LDGSTS|SYNCS)[.\w]*)", body)
        counts = {}
        for op in ops:
            counts[op] = counts.get(op, 0) + 1
        out[short] = dict(sorted(counts.items()))
    return out


def build_nbrs():
    """The ELL matrix of chip_smoke.py phase 6, on the host."""
    import torch
    from repro_torch.graph.csr import ell_from_csr
    from repro_torch.graph.generators import erdos_renyi

    ell = ell_from_csr(erdos_renyi(ER_N, ER_M, seed=0))
    return torch.from_numpy(ell.nbrs)


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
        nbrs = torch.load(args.state)
    else:
        nbrs = build_nbrs()
        if args.state is not None:
            args.state.parent.mkdir(parents=True, exist_ok=True)
            torch.save(nbrs, args.state)
    nbrs = nbrs.to("cuda")
    n, d = nbrs.shape
    print(f"state: nbrs=[{n}, {d}] neighbours={int((nbrs < n).sum())} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    if args.repeats == 0:
        return 0

    gen = torch.Generator(device="cuda").manual_seed(0)
    feats = torch.randn((n, D_FEAT), generator=gen, device="cuda")
    emb = torch.randn(FM_SHAPES[0], generator=gen, device="cuda")
    checks = {}
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
    print("every row == its plain version (ell_aggregate bit for bit)",
          flush=True)

    ms = {k: [] for k in fns}
    for r in range(args.repeats):
        order = list(fns) if r % 2 == 0 else list(fns)[::-1]
        for k in order:
            ms[k].append(time_ms(fns[k][0], args.iters, graph=fns[k][1]))
        print(f"repeat {r}: " + ", ".join(f"{k} {ms[k][-1]:.4f} ms"
                                          for k in fns), flush=True)
    print(json.dumps({k: float(np.median(t)) for k, t in ms.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
