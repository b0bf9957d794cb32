"""The benchmark of the PyTorch and CUDA port (``repro_torch``): one run
of one cell.

    python3 corebench/run.py --workload rmat-s21.burst --seed 1 --seconds 30 --trace 0

Loads the cell named in ``BENCHMARK.json``, builds its graph on the card
from the seed, builds ``repro_torch``'s ``CoreMaintainer``, warms up, drives
``apply_batch`` in a closed loop for ``--seconds`` seconds, checks the
result against the plain reference, and prints the result as the last
line of standard output (one JSON object); the compared numbers and their
limits are also the last lines of standard error. ``--trace 1`` adds
traced pairs after the window and reports the per-layer metrics.

Exits non-zero, printing no result, without enough CUDA devices, when
``repro_torch`` is missing from the checkout, or when ``jax``, ``jaxlib``,
``flax`` or the JAX package ``repro`` was imported.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

from corebench.guard import forbidden_modules  # noqa: E402

THREADS = 4  # host threads of torch's CPU pool: one process, few threads


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    import torch

    from corebench.harness import find_cell, load_bench, run_cell

    cell, _, _ = find_cell(load_bench(), args.workload)
    if not torch.cuda.is_available():
        print("corebench: no CUDA device", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        print(f"corebench: {cell['chips']} CUDA devices needed, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    torch.set_num_threads(THREADS)
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), device="cuda", t_start=T_START)
    found = forbidden_modules(sys.modules)
    if found:
        print(f"corebench: forbidden modules imported: {found}",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"corebench check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
