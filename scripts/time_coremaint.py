#!/usr/bin/env python3
"""Times the core-maintenance edge passes on one CUDA card at
``chip_smoke.py`` phase 3's state: ``rmat(21, 16_000_000, seed=0)``, the
slot window of ``CoreMaintainer.from_graph`` (``init="jax-peel"``;
``weighted=True`` with weights 1-5 drawn with seed 1 for ``wsum``, at
thresholds ``(core + 1) // 2``), in its own layout (sorted by src) and in
one seeded random slot order (no runs).

Rows: every unit stat of ``coo_stat`` (``din`` and ``same_in`` under
phase 3's 50% random mask), ``fused_promotion_stats``, and ``wsum`` and
``fused_removal_round`` as controls; on the sorted window also ``din``
and ``same_in`` under the masks the main path passes them ("path
masks"): the ``aux`` of every ``din`` / ``same_in`` call of
``chip_smoke.py`` phase 4's burst pair (100,000 edges drawn with seed 0,
removed and re-inserted), recorded with ``coremaint.record_masks``; the
rows time the mask whose share of touched live slots (either endpoint
in the mask) is the median over the calls, and the one where it is the
largest.

    python3 scripts/time_coremaint.py [--state FILE] [--repeats 5] [--iters 20]
    python3 scripts/time_coremaint.py --sass   # instruction counts only

Each repeat times every row with CUDA events (mean of ``--iters``
launches after a warm-up), the rows in turns (forward on even repeats,
backward on odd ones). Every row is held once to its plain version (0
mismatches). Prints the card's ``nvidia-smi`` name and power limit, the
path masks' popcounts and touched shares, one line a repeat, and a last
JSON line with each row's median.

``--state FILE`` keeps the windows and the path masks in FILE: the first
run builds them (rmat, the peel, the burst pair and a weighted
from_graph: a few minutes) and saves them, later runs load them
(``--repeats 0`` only builds). To compare two checkouts, build the state
with this checkout's script, copy the script into the other checkout's
``scripts/`` (on a saved state it calls only ``coo_stat``,
``fused_removal_round``, ``fused_promotion_stats`` and their plain
versions, which both trees have) and run each copy with that
``--state`` on one card, one after another: parent, change, change,
parent. ``--sass`` prints instead, for each kernel of
``csrc/coremaint.cu`` in the checkout's built library, how many global
loads of each width, global atomics (``RED``/``ATOMG``), shuffles
(``SHFL``) and warp votes (``VOTE``) its SASS holds (``cuobjdump
-sass``). Exits non-zero without a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

SCALE = 21        # chip_smoke.SCALE
EDGES = 16_000_000
BURST = 100_000
MAX_WEIGHT = 5
MASK_STATS = ("din", "same_in")


def time_ms(fn, iters: int) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def touched_share(src, dst, valid, mask) -> float:
    """Share of the window's live slots with either endpoint in
    ``mask``."""
    live = valid != 0
    hit = (mask[src.long()] | mask[dst.long()]) & live
    return float(hit.sum()) / max(1, int(live.sum()))


def pick_path_masks(src, dst, valid, recorded) -> dict:
    """From ``record_masks``' list: per masked stat, every call's
    popcount and touched share over the window, and the masks of the
    median and of the largest touched share."""
    import torch
    out = {}
    for stat in MASK_STATS:
        masks = [a.bool() for s, a in recorded if s == stat and a is not None]
        touch = [touched_share(src, dst, valid, a) for a in masks]
        order = sorted(range(len(masks)), key=touch.__getitem__)
        out[f"path_{stat}_popcount"] = torch.tensor(
            [int(a.sum()) for a in masks])
        out[f"path_{stat}_touch"] = torch.tensor(touch)
        out[f"path_{stat}_median"] = masks[order[(len(order) - 1) // 2]]
        out[f"path_{stat}_max"] = masks[order[-1]]
    return out


def build_state() -> dict:
    """The unweighted and weighted maintainers' slot windows, and the path
    masks of the unweighted burst pair, on the host."""
    import torch
    from repro_torch.core.api import CoreMaintainer
    from repro_torch.graph.generators import rmat
    from repro_torch.kernels import coremaint as K

    g = rmat(SCALE, EDGES, seed=0)
    m = CoreMaintainer.from_graph(g, init="jax-peel", device="cuda")
    w = m._window(0)
    state = {k: getattr(m, k)[:w].clone() for k in ("src", "dst", "valid")}
    state.update(core=m.core.clone(), label=m.label.clone(),
                 n=torch.tensor(m.n))
    # chip_smoke.py phase 4's burst pair
    pick = np.random.default_rng(0).choice(g.m, size=BURST, replace=False)
    sample = g.edge_array()[pick]
    with K.record_masks() as recorded:
        m.apply_batch(remove_edges=sample)
        m.apply_batch(insert_edges=sample)
    state.update(pick_path_masks(state["src"], state["dst"], state["valid"],
                                 recorded))
    state = {k: v.cpu() for k, v in state.items()}
    del m, recorded
    w0 = np.random.default_rng(1).integers(1, MAX_WEIGHT + 1, g.m)
    mw = CoreMaintainer.from_graph(g, device="cuda", weighted=True,
                                   weights=w0)
    w = mw._window(0)
    for k in ("src", "dst", "valid", "w"):
        state[f"weighted_{k}"] = getattr(mw, k)[:w].cpu()
    state["weighted_core"] = mw.core.cpu()
    return state


def sass_counts() -> dict:
    """``{kernel: {instruction: count}}`` for the coremaint.cu kernels of
    the checkout's library, from ``cuobjdump -sass``."""
    import os
    import re
    import shutil
    from repro_torch.kernels import build as KB

    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    text = subprocess.run([tool, "-sass", str(KB.build())],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    parts = re.split(r"Function : (\S+)", text)
    out = {}
    for name, body in zip(parts[1::2], parts[2::2]):
        if not re.search(r"(stat|wsum|removal_round|decide|pack_mask)_kernel", name):
            continue
        ops = re.findall(r"\b((?:LDG|RED|ATOMG|SHFL|VOTE)[.\w]*)", body)
        counts = {}
        for op in ops:
            counts[op] = counts.get(op, 0) + 1
        out[name] = dict(sorted(counts.items()))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--state", type=Path, default=None,
                    help="load the windows from FILE, or build and save "
                         "them there")
    ap.add_argument("--repeats", type=int, default=5,
                    help="timed repeats (0: build or load the state only)")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--sass", action="store_true",
                    help="print the kernels' load, atomic and shuffle "
                         "instruction counts and exit")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("time_coremaint: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import coremaint as K

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.splitlines()[0], flush=True)
    print(f"source: {Path(K.__file__).resolve()}", flush=True)
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
    st = {k: v.to("cuda") for k, v in state.items()}
    n = int(state["n"])
    print(f"state: E={st['src'].shape[0]} weighted E="
          f"{st['weighted_src'].shape[0]} n={n} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    for stat in MASK_STATS:
        pop = state[f"path_{stat}_popcount"].tolist()
        touch = state[f"path_{stat}_touch"].tolist()
        print(f"path masks {stat}: {len(pop)} calls, popcount median "
              f"{float(np.median(pop))} max {max(pop)}, touched share of "
              f"live slots median {float(np.median(touch)):.6f} max "
              f"{max(touch):.6f}", flush=True)
    if args.repeats == 0:
        return 0

    gen = torch.Generator(device="cuda").manual_seed(0)
    # chip_smoke.py phase 3's 50% mask (its own generator, seed 0)
    half = torch.rand(n, device="cuda",
                      generator=torch.Generator(device="cuda").manual_seed(0)
                      ) < 0.5
    core, label = st["core"], st["label"]
    wcore = st["weighted_core"]
    thresh = (wcore + 1) // 2
    fns = {}
    for layout in ("sorted", "shuffled"):
        cols = [st[k] for k in ("src", "dst", "valid")]
        wcols = [st[f"weighted_{k}"] for k in ("src", "dst", "valid", "w")]
        if layout == "shuffled":
            perm = torch.randperm(cols[0].shape[0], generator=gen,
                                  device="cuda")
            cols = [c[perm] for c in cols]
            perm = torch.randperm(wcols[0].shape[0], generator=gen,
                                  device="cuda")
            wcols = [c[perm] for c in wcols]
        rargs = (*cols, core, label, n)
        wargs = (*wcols[:3], wcore, None, n, "wsum", thresh, wcols[3])
        checks = {
            "wsum": (lambda a=wargs: K.coo_stat(*a),
                     lambda c=wcols: K.wsum_plain(c[0], c[1], c[2], c[3],
                                                  wcore, thresh, n)),
        }
        for fn in ("fused_removal_round", "fused_promotion_stats"):
            checks[fn] = (lambda a=rargs, f=getattr(K, fn): f(*a),
                          lambda a=rargs, f=getattr(K, fn + "_plain"): f(*a))
        for stat in ("mcd_hi_dout", "hi_dout", "mcd", *MASK_STATS):
            masks = {"": None}
            if stat in MASK_STATS:
                masks = {" 50%": half}
                if layout == "sorted":
                    masks.update({f" path {k}": st[f"path_{stat}_{k}"]
                                  for k in ("median", "max")})
            for mname, aux in masks.items():
                a = (*rargs, stat, aux)
                checks[f"coo_stat[{stat}]{mname}"] = (
                    lambda a=a: K.coo_stat(*a),
                    lambda a=a: K.coo_stat_plain(*a))
        for name, (run, plain) in checks.items():
            got, want = run(), plain()
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            if not all(torch.equal(x, y) for x, y in zip(got, want)):
                print(f"time_coremaint: {name} ({layout}) differs from "
                      f"its plain version", file=sys.stderr)
                return 1
            fns[f"{name} {layout}"] = run
        del checks
    print("every row == its plain version (0 mismatches)", flush=True)

    ms = {k: [] for k in fns}
    for r in range(args.repeats):
        order = list(fns) if r % 2 == 0 else list(fns)[::-1]
        for k in order:
            ms[k].append(time_ms(fns[k], args.iters))
        print(f"repeat {r}: " + ", ".join(f"{k} {ms[k][-1]:.4f} ms"
                                          for k in fns), flush=True)
    print(json.dumps({k: float(np.median(t)) for k, t in ms.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
