"""Deterministic synthetic LM token pipeline: the reference's
``data/lm.py`` (numpy only), copied so the port imports nothing of it;
the same batches bit for bit.

Produces (tokens, targets) batches from a seeded Zipfian sampler with
Markov structure (so the loss is learnable — a pure-uniform stream cannot
show training progress). Sharded loading: each host materializes only its
slice of the global batch.
"""
from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np


def synthetic_lm_batches(
    vocab: int,
    batch: int,
    seq: int,
    seed: int = 0,
    host_id: int = 0,
    n_hosts: int = 1,
) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    assert batch % n_hosts == 0
    local = batch // n_hosts
    rng = np.random.default_rng(seed * 1000 + host_id)
    # Zipf unigram + a sticky bigram kernel
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    probs = 1.0 / ranks
    probs /= probs.sum()
    step = 0
    while True:
        base = rng.choice(vocab, size=(local, seq + 1), p=probs)
        # Markov stickiness: with p=0.5 copy previous token + 1 (mod vocab)
        sticky = rng.random((local, seq + 1)) < 0.5
        for t in range(1, seq + 1):
            base[:, t] = np.where(
                sticky[:, t], (base[:, t - 1] + 1) % vocab, base[:, t]
            )
        yield base[:, :-1].astype(np.int32), base[:, 1:].astype(np.int32)
        step += 1
