"""The control: the plain reference put in the program's place, with one
guarantee that the configurations state broken, to show that the check
that decides ``correct`` catches it.

The guarantee broken is exactness after a removal burst: ``Control``
keeps the edge set exactly, but after a removal it runs the decrease-only
core fixpoint (a vertex loses a level while fewer than ``core`` of its
neighbours have a core at least its own) for one round only, where the
exact fixpoint runs until nothing changes: the shortcut of capping the
removal rounds. Its labels stay as they were. After an insertion it peels
afresh, so insertions are exact and the labels are a peel order.

    python3 corebench/control.py --workload rmat-s21.burst --seed 7 --batches 6

runs the cell's set-up and traffic with the control in the program's
place for ``--batches`` batches and prints the compared numbers beside
their limits, as a run does; the benchmark's own runs never run it.
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

from corebench import reference  # noqa: E402

ROUNDS = 1  # removal rounds the control runs (the exact fixpoint: all)


class Control:
    def __init__(self, config: dict, n: int, indptr: np.ndarray,
                 indices: np.ndarray, device):
        ip = torch.as_tensor(indptr, device=device)
        dst = torch.as_tensor(indices, device=device).long()
        src = torch.repeat_interleave(torch.arange(n, device=device),
                                      ip[1:] - ip[:-1])
        keep = src < dst
        self.n = n
        self.keys = torch.sort(src[keep] * n + dst[keep]).values
        self.core, self.label = reference.core_numbers(self.keys, n,
                                                       with_order=True)

    def apply(self, insert, remove) -> dict:
        n, dev = self.n, self.keys.device
        before = self.keys.numel()
        if len(remove):
            self.keys = reference.remove_keys(
                self.keys, reference.edge_keys(remove, n, dev))
        removed = before - self.keys.numel()
        if len(insert):
            self.keys = torch.unique(torch.cat(
                [self.keys, reference.edge_keys(insert, n, dev)]))
        inserted = self.keys.numel() - before + removed
        if len(insert):
            self.core, self.label = reference.core_numbers(self.keys, n,
                                                           with_order=True)
        elif len(remove):
            lo, hi = self.keys // n, self.keys % n
            for _ in range(ROUNDS):
                c = self.core
                mcd = (torch.bincount(lo[c[hi] >= c[lo]], minlength=n)
                       + torch.bincount(hi[c[lo] >= c[hi]], minlength=n))
                self.core = c - ((mcd < c) & (c > 0)).long()
        z = torch.zeros((), dtype=torch.int64)
        return {"n_inserted": inserted, "n_removed": removed,
                "remove_rounds": z, "insert_rounds": z, "n_promoted": z,
                "v_plus": z}

    def state(self) -> tuple:
        return self.core, self.label

    def live_keys(self) -> torch.Tensor:
        return self.keys

    def reset_launches(self) -> None:
        pass

    def launches(self) -> int:
        return 0

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
                   system=Control, max_batches=args.batches)
    for k, v in res["checks"].items():
        print(f"control check {k} {v['value']} limit {v['limit']}",
              file=sys.stderr)
    print(json.dumps({"workload": args.workload, "seed": args.seed,
                      "correct": res["correct"], "checks": res["checks"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
