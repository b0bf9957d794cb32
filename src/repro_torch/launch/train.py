"""Training launcher for the LM archs, on one card.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-7b \\
      --smoke --steps 20 --ckpt-dir /tmp/ckpt

The port of the reference's ``launch/train.py``: its flags and printed
lines, plus ``--device`` (default: the card). Features exercised:
microbatching (float32 gradient accumulation), the cosine schedule,
AdamW, atomic checkpoints with auto-resume (run the same command again
and it resumes from the last committed step), the preemption guard and
the straggler monitor. ``--smoke`` takes the reduced config and forces
float32, as the reference does; parameters are drawn from a
``torch.Generator`` seeded 0. The loss runs the plain attention
(``kernel_backend="torch"``): the reference trains through XLA and the
attention kernel is forward-only. The reference's multi-host sharding
and cross-pod gradient compression come with ROADMAP Queue 1 E.
"""
from __future__ import annotations

import argparse
import dataclasses

import torch

from ..configs import get_arch
from ..data.lm import synthetic_lm_batches
from ..device import resolve_device
from ..models import transformer as tf_mod
from ..train.checkpoint import latest_step
from ..train.loop import TrainConfig, run_training


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-7b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--micro-batches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    mod = get_arch(args.arch)
    if mod.FAMILY != "lm":
        raise SystemExit(
            f"launch.train drives LM archs; use "
            f"examples/train_gnn_torch.py or benchmarks for {args.arch}"
        )
    cfg = mod.smoke() if args.smoke else mod.full()
    if args.smoke:
        cfg = dataclasses.replace(cfg, dtype=torch.float32)
    dev = resolve_device(args.device)
    params = tf_mod.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    n_params = sum(p.numel() for p in params.parameters())
    print(f"[train] {cfg.name}: {n_params/1e6:.1f}M params, "
          f"1 device(s) ({dev})")

    data = synthetic_lm_batches(cfg.vocab, args.batch, args.seq, seed=0)

    def batches():
        for toks, tgts in data:
            yield (torch.from_numpy(toks).to(dev),
                   torch.from_numpy(tgts).to(dev))

    def lf(p, tokens, targets):
        return tf_mod.loss_fn(cfg, p, tokens, targets,
                              kernel_backend="torch")

    if args.ckpt_dir:
        last = latest_step(args.ckpt_dir)
        if last is not None:
            print(f"[train] resuming after committed step {last}")
    tc = TrainConfig(
        lr=args.lr, warmup=max(1, args.steps // 10),
        total_steps=args.steps, micro_batches=args.micro_batches,
        ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
    )
    params, report = run_training(
        params, lf, batches(), tc,
        on_step=lambda s, m: print(
            f"[train] step {s:05d} loss={m['loss']:.4f} "
            f"gnorm={m['grad_norm']:.3f} lr={m['lr']:.2e}"
        ) if s % 10 == 0 else None,
    )
    hist = report["history"]
    if not hist:
        print(f"[train] nothing to do: resumed at step "
              f"{report['final_step']} of {args.steps}")
        return
    print(f"[train] done @ step {report['final_step']}  "
          f"loss {hist[0]['loss']:.4f} -> {hist[-1]['loss']:.4f}  "
          f"stragglers={report['stragglers']}")


if __name__ == "__main__":
    main()
