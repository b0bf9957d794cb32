"""Synthetic CTR batches (Criteo-like): hashed categorical ids + a planted
logistic ground truth so AUC/loss are meaningful.

A numpy copy of the reference's ``data/recsys.py``: the same seed gives
the same batches."""
from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np


def synthetic_ctr_batches(
    n_fields: int,
    rows_per_field: int,
    batch: int,
    seed: int = 0,
) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    rng = np.random.default_rng(seed)
    # planted per-field weights on a small latent id space
    latent = 1024
    w = rng.normal(size=(n_fields, latent)) * 0.5
    while True:
        ids_latent = rng.integers(0, latent, size=(batch, n_fields))
        logit = w[np.arange(n_fields)[None, :], ids_latent].sum(axis=1)
        label = (rng.random(batch) < 1 / (1 + np.exp(-logit))).astype(
            np.float32
        )
        # expand latent ids into the big hashed space (stable hash)
        ids = (ids_latent * 2654435761 % rows_per_field).astype(np.int32)
        yield ids, label
