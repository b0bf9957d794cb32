"""Train a small LM end-to-end with the full substrate (data pipeline,
AdamW, cosine schedule, microbatching, checkpoint/auto-resume), on
PyTorch (``examples/train_lm.py`` is its counterpart on the JAX
package).

The ``tiny`` preset is CPU-sized (float32); ``--preset 100m`` selects a
~100M-param bfloat16 model for the card (same code path). The loss runs
the plain attention (``kernel_backend="torch"``): the attention kernel is
forward-only, as the reference's Pallas kernel is.

    python examples/train_lm_torch.py --steps 200          # on the card
    python examples/train_lm_torch.py --preset 100m --micro-batches 2
    python examples/train_lm_torch.py --device cpu --steps 60
"""
import argparse
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.data.lm import synthetic_lm_batches  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.models.transformer import (LMConfig,  # noqa: E402
                                            init_params, loss_fn)
from repro_torch.train.loop import TrainConfig, run_training  # noqa: E402


def preset(name: str) -> LMConfig:
    if name == "tiny":
        return LMConfig(
            name="tiny", n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
            d_head=32, d_ff=384, vocab=512, dtype=torch.float32,
        )
    if name == "100m":
        return LMConfig(
            name="lm-100m", n_layers=12, d_model=768, n_heads=12,
            n_kv_heads=4, d_head=64, d_ff=2048, vocab=32768,
        )
    raise ValueError(name)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--preset", default="tiny")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--micro-batches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args()

    cfg = preset(args.preset)
    dev = resolve_device(args.device)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    n_params = sum(p.numel() for p in params.parameters())
    print(f"model {cfg.name}: {n_params/1e6:.1f}M params on {dev}")

    data = synthetic_lm_batches(cfg.vocab, args.batch, args.seq, seed=0)

    def batches():
        for toks, tgts in data:
            yield (torch.from_numpy(toks).to(dev),
                   torch.from_numpy(tgts).to(dev))

    def lf(params, tokens, targets):
        return loss_fn(cfg, params, tokens, targets, kernel_backend="torch")

    tc = TrainConfig(
        lr=1e-3, warmup=20, total_steps=args.steps, clip_norm=1.0,
        micro_batches=args.micro_batches,
        ckpt_dir=args.ckpt_dir, ckpt_every=50,
    )
    params, report = run_training(
        params, lf, batches(), tc,
        on_step=lambda s, m: print(
            f"step {s:04d} loss={m['loss']:.4f} lr={m['lr']:.2e}"
        ) if s % 20 == 0 else None,
    )
    hist = report["history"]
    print(f"\nloss: first={hist[0]['loss']:.4f} last={hist[-1]['loss']:.4f} "
          f"(stragglers: {report['stragglers']})")
    assert hist[-1]["loss"] < hist[0]["loss"]
    print("LM training improved the loss ✓")


if __name__ == "__main__":
    main()
