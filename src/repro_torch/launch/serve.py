"""Serving launcher: prefill + batched decode with the KV cache.

  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch deepseek-v2-lite-16b --smoke --batch 2 --prompt-len 32 \\
      --gen 16 --device cpu

The port of the reference's ``launch/serve.py``, with its arguments and
its two printed lines, plus ``--device`` (default: the card) and a line
naming the resolved ``kernel_backend``. As in the reference the config
is cast to float32 and ``--smoke`` is on by default; parameters are
drawn from a ``torch.Generator`` seeded 0 and the prompt from one seeded
1, so its tokens differ from the reference's ``jax.random`` prompt. The
prefill's cache is widened to ``prompt_len + gen`` slots, and each
decode step writes into it in place.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from ..configs import get_arch
from ..device import resolve_device
from ..models import transformer as tf_mod


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="deepseek-v2-lite-16b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    mod = get_arch(args.arch)
    if mod.FAMILY != "lm":
        raise SystemExit("launch.serve drives LM archs")
    cfg = mod.smoke() if args.smoke else mod.full()
    cfg = dataclasses.replace(cfg, dtype=torch.float32)
    dev = resolve_device(args.device)
    with torch.no_grad():
        params = tf_mod.init_params(
            cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    max_seq = args.prompt_len + args.gen
    print(f"[serve] {cfg.name} device={dev} "
          f"kernel_backend={params.kernel_backend}")

    prompt = torch.randint(
        0, cfg.vocab, (args.batch, args.prompt_len), device=dev,
        generator=torch.Generator(device=dev).manual_seed(1))
    with torch.no_grad():
        t0 = time.perf_counter()
        logits, cache = params.prefill(prompt)
        # widen the cache to generation capacity
        cache = tf_mod.widen_cache(cache, max_seq)
        _sync(dev)
        t_prefill = time.perf_counter() - t0

        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        out = [tok]
        t0 = time.perf_counter()
        for _ in range(args.gen - 1):
            logits, cache = params.decode_step(cache, tok)
            tok = torch.argmax(logits, dim=-1).to(torch.int32)
            out.append(tok)
        _sync(dev)
        t_decode = time.perf_counter() - t0
    gen = torch.stack(out, dim=1)
    print(f"[serve] {cfg.name} batch={args.batch} "
          f"prefill {args.prompt_len} tok in {t_prefill*1e3:.1f} ms; "
          f"decoded {args.gen-1} steps in {t_decode*1e3:.1f} ms "
          f"({(args.gen-1)*args.batch/max(t_decode,1e-9):.1f} tok/s)")
    print("[serve] sample token ids:", gen[0, :12].tolist())


if __name__ == "__main__":
    main()
