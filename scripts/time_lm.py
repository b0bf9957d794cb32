#!/usr/bin/env python3
"""Where LM serving spends its time on one CUDA card, at ``chip_smoke.py``
phase 10's cells, bfloat16, TF32 off, random weights drawn on the card:

* qwen2-7b ``full()``: one 1 x 32,768 prefill on the kernel path
  (``prefill_32k`` cut to batch 1) under ``torch.profiler``; one
  ``decode_step`` at ``decode_32k`` cut to batch 16 and one at
  ``long_500k`` (batch 1), each on a seeded random cache whose length
  leaves one slot free, timed (CUDA events, the mean of 3 steps after a
  warm-up) and profiled;
* deepseek-v2-lite-16b ``full()``: one 1 x 4,096 prefill and one decode
  step on its cache, profiled.

A profile line gives the host wall of the call, the device time of its
kernels, the idle share, the number of kernel launches, and the ops
(``aten::*``, by the device time of the kernels each launched itself)
and kernels that took the most device time, with their shares
(``scripts/time_gnn.py``'s ``profile``).

    python3 scripts/time_lm.py

Prints the card's ``nvidia-smi`` name and power limit, one line a row,
and a last JSON line of every row. Exits non-zero without a CUDA device.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "scripts"))
sys.path.insert(0, str(ROOT / "src"))

from time_gnn import profile, time_ms  # noqa: E402

DECODE_BATCH = 16  # decode_32k's 128 rows cut to 16, as in phase 10


def random_cache(T, cfg, batch: int, slots: int, seed: int) -> dict:
    """A seeded random bf16 cache of ``slots`` slots at length
    ``slots - 1``."""
    import torch
    cache = T.init_cache(cfg, batch, slots, "cuda")
    gen = torch.Generator("cuda").manual_seed(seed)
    for name, x in cache.items():
        if name != "length":
            for i in range(cfg.n_layers):
                x[i].normal_(generator=gen)
    cache["length"].fill_(slots - 1)
    return cache


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("time_lm: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.configs import deepseek_v2_lite_16b, qwen2_7b
    from repro_torch.configs.common import LM_SHAPES
    from repro_torch.kernels import build as KB
    from repro_torch.models import transformer as T

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    KB.build()
    cells = {c.name: c.params for c in LM_SHAPES}
    rows = {}

    def gen():
        return torch.Generator("cuda").manual_seed(0)

    with torch.no_grad():
        cfg = qwen2_7b.full()
        model = T.init_params(cfg, gen(), device="cuda")
        s32 = cells["prefill_32k"]["seq"]
        toks = torch.randint(0, cfg.vocab, (1, s32), device="cuda",
                             generator=gen())
        rows["profile qwen2-7b prefill 1x32768 kernel"] = profile(
            "qwen2-7b prefill 1x32768 kernel",
            lambda: T.prefill(cfg, model, toks, "cuda"))
        del toks
        for cell, batch in (("decode_32k", DECODE_BATCH),
                            ("long_500k", cells["long_500k"]["batch"])):
            slots = cells[cell]["cache"]
            cache = random_cache(T, cfg, batch, slots, seed=2)
            tok = torch.zeros(batch, dtype=torch.int32, device="cuda")

            def step():
                cache["length"].fill_(slots - 1)
                return T.decode_step(cfg, model, cache, tok)
            name = f"qwen2-7b decode_step {cell} batch {batch}"
            ms = time_ms(step)
            print(f"{name}: {ms:.4f} ms a step", flush=True)
            rows[name] = dict(ms=ms, batch=batch, slots=slots)
            rows[f"profile {name}"] = profile(name, step)
            del cache
            torch.cuda.empty_cache()
        del model
        torch.cuda.empty_cache()

        cfg = deepseek_v2_lite_16b.full()
        model = T.init_params(cfg, gen(), device="cuda")
        toks = torch.randint(0, cfg.vocab, (1, 4096), device="cuda",
                             generator=gen())
        rows["profile deepseek-v2-lite-16b prefill 1x4096"] = profile(
            "deepseek-v2-lite-16b prefill 1x4096",
            lambda: T.prefill(cfg, model, toks))
        cache = random_cache(T, cfg, 1, 4096 + 1, seed=2)
        tok = torch.zeros(1, dtype=torch.int32, device="cuda")

        def step():
            cache["length"].fill_(4096)
            return T.decode_step(cfg, model, cache, tok)
        name = "deepseek-v2-lite-16b decode_step cache 4097 batch 1"
        ms = time_ms(step)
        print(f"{name}: {ms:.4f} ms a step", flush=True)
        rows[name] = dict(ms=ms)
        rows[f"profile {name}"] = profile(name, step)
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "nvidia_smi": smi, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
