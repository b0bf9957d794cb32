#!/usr/bin/env python3
"""Times the attention kernels on one CUDA card at ``chip_smoke.py``
phase 6's shape (qwen2-7b's 28 query and 4 kv heads, D 128, 1 x 4,096):
causal bfloat16 and full float32, each beside
``scaled_dot_product_attention`` on the same inputs.

    python3 scripts/time_attention.py [--repeats 5] [--iters 50]

Each repeat times the kernel and SDPA with CUDA events (mean of
``--iters`` launches after a warm-up), in turns (kernel, SDPA, SDPA,
kernel, ...). Prints the card's ``nvidia-smi`` name and power limit, one
line a repeat, and a last JSON line with each row's median. To compare
two checkouts, run each one's copy of the script in one session, in the
order parent, change, change, parent. Exits non-zero without a CUDA
device.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

SHAPE = dict(b=1, h=28, hkv=4, s=4096, d=128)  # chip_smoke.ATTN


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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--iters", type=int, default=50)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("time_attention: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import flash_attention as FA

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.splitlines()[0], flush=True)
    a, out = SHAPE, {}
    for causal, dtype in ((True, torch.bfloat16), (False, torch.float32)):
        gen = torch.Generator(device="cuda").manual_seed(int(causal))
        q = torch.randn((a["b"], a["h"], a["s"], a["d"]), generator=gen,
                        device="cuda").to(dtype)
        k, v = (torch.randn((a["b"], a["hkv"], a["s"], a["d"]),
                            generator=gen, device="cuda").to(dtype)
                for _ in range(2))
        fns = {
            "kernel": lambda: FA.flash_attention(q, k, v, causal=causal),
            "sdpa": lambda: torch.nn.functional.scaled_dot_product_attention(
                q, k, v, is_causal=causal, enable_gqa=True)}
        name = FA.launch_key(causal, dtype, a["d"])
        ms = {"kernel": [], "sdpa": []}
        for r in range(args.repeats):
            order = ("kernel", "sdpa") if r % 2 == 0 else ("sdpa", "kernel")
            for which in order:
                ms[which].append(time_ms(fns[which], args.iters))
            print(f"{name} repeat {r}: kernel {ms['kernel'][-1]:.4f} ms, "
                  f"sdpa {ms['sdpa'][-1]:.4f} ms", flush=True)
        out[name] = {w: float(np.median(t)) for w, t in ms.items()}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
