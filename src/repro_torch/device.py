"""The port's default device, the card, and its kernel-backend policy."""
from __future__ import annotations

from typing import Optional

import torch

KERNEL_BACKENDS = ("torch", "cuda")


def resolve_device(device=None) -> torch.device:
    """``None`` means the card; a CUDA device without CUDA raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run on the CPU"
        )
    return dev


def resolve_backend(kernel_backend: Optional[str], dev: torch.device,
                    kernel_fits: bool = True) -> str:
    """``None`` means ``"cuda"`` on a card when ``kernel_fits`` and
    ``"torch"`` otherwise; an unknown name, or ``"cuda"`` on a CPU device,
    raises ``ValueError``."""
    if kernel_backend is None:
        kernel_backend = ("cuda" if dev.type == "cuda" and kernel_fits
                          else "torch")
    if kernel_backend not in KERNEL_BACKENDS:
        raise ValueError(
            f"unknown kernel_backend {kernel_backend!r} "
            f"(expected one of {KERNEL_BACKENDS})"
        )
    if kernel_backend == "cuda" and dev.type != "cuda":
        raise ValueError(
            "kernel_backend='cuda' needs a CUDA device (got "
            f"{dev}); the CPU runs kernel_backend='torch'"
        )
    return kernel_backend
