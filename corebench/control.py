"""The control: the plain reference put in the program's place, with one
guarantee that the configurations state broken, to show that the check
that decides ``correct`` catches it.

The guarantee broken is exactness after removals. ``Control`` keeps the
edge set exactly, and after a batch that removes edges it takes the cores
from the decrease-only core fixpoint (a vertex loses a level while fewer
than ``core`` of its neighbours have a core at least its own) run for one
round only, where the exact fixpoint runs until nothing changes: the
shortcut of capping the removal rounds. The fixpoint starts from an exact
upper bound: the cores before the batch when it only removes, a fresh
peel of the edge set with the batch's insertions and without its
removals when it also inserts (a mixed batch). A batch that only inserts
is peeled afresh, exact. The labels are those of the last peel.

    python3 corebench/control.py --workload rmat-s21.burst --seed 7 --batches 6

runs the cell's set-up and traffic with the control in the program's
place for ``--batches`` batches from the traffic's first step (no
warm-up: each of its batches would be a peel) and prints the compared
numbers beside their limits, as a run does; the benchmark's own runs
never run it.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from corebench.references import kcore as reference  # noqa: E402

ROUNDS = 1  # removal rounds the control runs (the exact fixpoint: all)


class Control:
    def __init__(self, config: dict, n: int, indptr: np.ndarray,
                 indices: np.ndarray, device, weights=None):
        if weights is not None:
            raise ValueError("the control judges unweighted graphs")
        ip = torch.as_tensor(indptr, device=device)
        dst = torch.as_tensor(indices, device=device).long()
        src = torch.repeat_interleave(torch.arange(n, device=device),
                                      ip[1:] - ip[:-1])
        keep = src < dst
        self.n = n
        self.keys = torch.sort(src[keep] * n + dst[keep]).values
        self.core, self.label = reference.core_numbers(self.keys, n,
                                                       with_order=True)

    def apply(self, insert, remove, insert_weights=None) -> dict:
        n, dev = self.n, self.keys.device
        before = self.keys
        kept = before
        if len(remove):
            kept = reference.remove_keys(before,
                                         reference.edge_keys(remove, n, dev))
        after = kept
        if len(insert):
            new = reference.edge_keys(insert, n, dev)
            after = torch.unique(torch.cat([kept, new]))
            # exact on the edge set with the insertions, without the
            # removals: an upper bound of the cores after the batch
            self.core, self.label = reference.core_numbers(
                torch.unique(torch.cat([before, new])), n, with_order=True)
        if len(remove):
            lo, hi = after // n, after % n
            for _ in range(ROUNDS):
                c = self.core
                mcd = (torch.bincount(lo[c[hi] >= c[lo]], minlength=n)
                       + torch.bincount(hi[c[lo] >= c[hi]], minlength=n))
                self.core = c - ((mcd < c) & (c > 0)).long()
        self.keys = after
        z = torch.zeros((), dtype=torch.int64)
        return {"n_inserted": after.numel() - kept.numel(),
                "n_removed": before.numel() - kept.numel(),
                "remove_rounds": z, "insert_rounds": z, "n_promoted": z,
                "v_plus": z}

    def state(self) -> tuple:
        return self.core, self.label

    def live_keys(self) -> tuple:
        return self.keys, None

    def reset_launches(self) -> None:
        pass

    def launches(self) -> int:
        return 0

    def syncs(self):
        return None

    def entry_points(self) -> list:
        return []


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--batches", type=int, default=6)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from corebench.harness import run_cell
    if args.device == "cuda" and not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    res = run_cell(args.workload, args.seed, 1e9, False, device=args.device,
                   system=Control, max_batches=args.batches, warmup=False)
    for k, v in res["checks"].items():
        print(f"control check {k} {v['value']} limit {v['limit']}",
              file=sys.stderr)
    print(json.dumps({"workload": args.workload, "seed": args.seed,
                      "correct": res["correct"], "checks": res["checks"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
