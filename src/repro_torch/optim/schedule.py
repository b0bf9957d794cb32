"""LR schedules: the reference's ``optim/schedule.py``."""
from __future__ import annotations

import math

import torch


def cosine_with_warmup(step, base_lr: float, warmup: int, total: int,
                       min_ratio: float = 0.1) -> torch.Tensor:
    """Linear warmup to ``base_lr`` over ``warmup`` steps, then a cosine
    down to ``min_ratio * base_lr`` at ``total``: a 0-d float32 tensor of
    the int ``step`` (a Python int or a 0-d tensor, whose device it
    keeps), in float32 as the reference computes it."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = base_lr * step / max(1, warmup)
    t = torch.clamp((step - warmup) / max(1, total - warmup), 0.0, 1.0)
    cos = base_lr * (min_ratio + (1 - min_ratio) * 0.5 *
                     (1 + torch.cos(math.pi * t)))
    return torch.where(step < warmup, warm, cos)
