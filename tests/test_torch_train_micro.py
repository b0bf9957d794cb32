"""``micro_batches > 1`` with nested batch arguments: the port's
``train/loop.py`` splits every tensor of a tuple, list or dict passed as
one batch argument, as the reference's ``jax.tree.map`` splits every
leaf, and its ``run_training`` gives the reference's loss history and
parameters on the same numpy batches (float32: loss at 1e-5 relative,
parameters at 1e-5 absolute after 3 steps of AdamW at lr 1e-2)."""
import collections

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.train import loop as JL  # noqa: E402

from repro_torch.train import loop as L  # noqa: E402

Pair = collections.namedtuple("Pair", "x mask")
STEPS, B, D, K = 3, 8, 5, 3


def _batches():
    rng = np.random.default_rng(0)
    out = []
    for _ in range(STEPS):
        x = rng.normal(size=(B, D)).astype(np.float32)
        m = (rng.random(B) > 0.3).astype(np.float32)
        y = rng.normal(size=(B, K)).astype(np.float32)
        out.append(({"x": x, "mask": m}, [y]))
    return out


def _params():
    rng = np.random.default_rng(1)
    return {"w": rng.normal(size=(D, K)).astype(np.float32),
            "b": np.zeros(K, np.float32)}


def test_micro_splits_nested_containers_keeping_their_types():
    x = torch.arange(12.0).reshape(4, 3)
    batch = ({"x": x, "n": None}, [x[:, 0]], Pair(x, x[:, 1]))
    part = L._micro(batch, 2, 1)
    assert isinstance(part, tuple) and isinstance(part[0], dict)
    assert isinstance(part[1], list) and isinstance(part[2], Pair)
    assert torch.equal(part[0]["x"], x[2:]) and part[0]["n"] is None
    assert torch.equal(part[1][0], x[2:, 0])
    assert torch.equal(part[2].mask, x[2:, 1])
    with pytest.raises(TypeError, match="splits tensors"):
        L._micro({"x": 3}, 2, 0)


def test_nested_micro_batches_match_reference_run_training():
    def ref_loss(p, feats, targets):
        pred = feats["x"] @ p["w"] + p["b"]
        err = ((pred - targets[0]) ** 2).sum(-1) * feats["mask"]
        return jnp.mean(err)

    def port_loss(p, feats, targets):
        pred = feats["x"] @ p["w"] + p["b"]
        err = ((pred - targets[0]) ** 2).sum(-1) * feats["mask"]
        return torch.mean(err)

    tc = dict(lr=1e-2, warmup=1, total_steps=STEPS, micro_batches=2,
              clip_norm=1e9)
    batches = _batches()
    ref_p, ref_rep = JL.run_training(
        {k: jnp.asarray(v) for k, v in _params().items()}, ref_loss,
        [(jax.tree.map(jnp.asarray, f), [jnp.asarray(t[0])])
         for f, t in batches], JL.TrainConfig(**tc), log_every=100)
    port_p = {k: torch.from_numpy(v) for k, v in _params().items()}
    port_p, port_rep = L.run_training(
        port_p, port_loss,
        [({k: torch.from_numpy(v) for k, v in f.items()},
          [torch.from_numpy(t[0])]) for f, t in batches],
        L.TrainConfig(**tc), log_every=100)
    want = [h["loss"] for h in ref_rep["history"]]
    got = [h["loss"] for h in port_rep["history"]]
    assert len(got) == len(want) == STEPS
    np.testing.assert_allclose(got, want, rtol=1e-5)
    for k in ("w", "b"):
        np.testing.assert_allclose(port_p[k].detach().numpy(),
                                   np.asarray(ref_p[k]), atol=1e-5)
