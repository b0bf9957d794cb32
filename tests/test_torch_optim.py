"""The port's optimizer (``repro_torch.optim``) against the reference's
``repro.optim`` on the CPU, in float32 and bfloat16, inputs drawn with
numpy from a seed.

Tolerances. ``cosine_with_warmup``: rtol 1e-6 over steps 0 to
``total + 5`` (XLA's and torch's float32 ``cos`` may differ by an ulp).
``clip_by_global_norm``: the norm at rtol 1e-6 (the leaves are given in
the reference's sorted-key order; within a leaf the two packages' sums
run in different orders), the clipped leaves at rtol 1e-6 in float32 and
within one bfloat16 ulp (the scale may differ by an ulp before the
cast), each returned in its own dtype. ``adamw_update`` over 5 steps:
``m``, ``v`` at rtol 1e-5 (atol 1e-12), float32 parameters at rtol 1e-5
(atol 1e-7), bfloat16 parameters within one bfloat16 ulp (a float32
update that differs in its last bits can round either way), ``count``
exactly. ``compress_int8`` / ``decompress_int8``: bit for bit.
``error_feedback_allreduce`` on 4 gloo ranks against the reference
under ``shard_map`` on 4 forced host devices, 3 rounds: the new
residuals bit for bit (they are local), the averaged gradients at rtol
1e-6 (the four float32 scales are summed in the collective's order).
"""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.optim import adamw as JA  # noqa: E402
from repro.optim import compression as JC  # noqa: E402
from repro.optim import schedule as JSch  # noqa: E402

from repro_torch.optim import (  # noqa: E402
    adamw_init,
    adamw_update,
    clip_by_global_norm,
    compress_int8,
    cosine_with_warmup,
    decompress_int8,
)

ROOT = Path(__file__).resolve().parents[1]
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
SHAPES = {"a": (7, 5), "b": (5,), "c": (3, 4, 2), "d": ()}


def _f32(x):
    return np.array(jnp.asarray(x, jnp.float32))


def _t32(t):
    return t.detach().float().numpy()


def _tree(seed, dtype, scale=1.0):
    """The same leaves for both packages (sorted names: the reference's
    leaf order)."""
    rng = np.random.default_rng(seed)
    arrs = {k: (rng.standard_normal(s) * scale).astype(np.float32)
            for k, s in sorted(SHAPES.items())}
    jdt, tdt = DTYPES[dtype]
    return ({k: jnp.asarray(v, jdt) for k, v in arrs.items()},
            {k: torch.from_numpy(np.array(v)).to(tdt)
             for k, v in arrs.items()})


def _bf16_ulp(x):
    return np.abs(x) * 2.0 ** -7 + 1e-30


@pytest.mark.parametrize("base_lr,warmup,total,min_ratio", [
    (3e-4, 100, 1000, 0.1), (1e-3, 10, 100, 0.1), (1e-1, 2, 30, 0.1),
    (5e-3, 0, 50, 0.0), (2e-3, 20, 20, 0.5)])
def test_cosine_with_warmup_matches_reference(base_lr, warmup, total,
                                              min_ratio):
    for step in range(total + 6):
        want = float(JSch.cosine_with_warmup(jnp.int32(step), base_lr,
                                             warmup, total, min_ratio))
        got = cosine_with_warmup(step, base_lr, warmup, total, min_ratio)
        assert got.dtype == torch.float32 and got.dim() == 0
        np.testing.assert_allclose(float(got), want, rtol=1e-6, atol=0,
                                   err_msg=f"step {step}")
        # a 0-d tensor step gives the same value
        assert float(cosine_with_warmup(torch.tensor(step), base_lr, warmup,
                                        total, min_ratio)) == float(got)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_clip_by_global_norm_matches_reference(dtype, max_norm):
    jg, tg = _tree(0, dtype)
    want, want_n = JA.clip_by_global_norm(jg, max_norm)
    got, got_n = clip_by_global_norm(tg, max_norm)
    assert got_n.dtype == torch.float32
    np.testing.assert_allclose(float(got_n), float(want_n), rtol=1e-6)
    for k in SHAPES:
        assert got[k].dtype == tg[k].dtype  # each leaf in its own dtype
        w = _f32(want[k])
        if dtype == "float32":
            np.testing.assert_allclose(_t32(got[k]), w, rtol=1e-6, atol=0)
        else:
            assert (np.abs(_t32(got[k]) - w) <= _bf16_ulp(w)).all(), k
    if max_norm > float(want_n):  # no clip: the leaves come back as given
        for k in SHAPES:
            assert torch.equal(got[k], tg[k])


@pytest.mark.parametrize("dtype", DTYPES)
def test_adamw_matches_reference_over_steps(dtype):
    jp, tp = _tree(1, dtype)
    jstate, tstate = JA.adamw_init(jp), adamw_init(tp)
    assert tstate["count"].dtype == torch.int32
    assert all(m.dtype == torch.float32 for m in tstate["m"].values())
    for step in range(5):
        jg, tg = _tree(10 + step, dtype, scale=10.0 ** (step - 2))
        lr = 1e-3 * (step + 1)
        jp, jstate = JA.adamw_update(jp, jg, jstate, jnp.float32(lr))
        out_p, out_s = adamw_update(tp, tg, tstate, lr)
        assert out_p is tp and out_s is tstate  # in place
        assert int(tstate["count"]) == int(jstate["count"]) == step + 1
        for k in SHAPES:
            for name in ("m", "v"):
                np.testing.assert_allclose(
                    tstate[name][k].numpy(), _f32(jstate[name][k]),
                    rtol=1e-5, atol=1e-12, err_msg=f"{name} {k} {step}")
            assert tp[k].dtype == DTYPES[dtype][1]
            w = _f32(jp[k])
            if dtype == "float32":
                np.testing.assert_allclose(_t32(tp[k]), w, rtol=1e-5,
                                           atol=1e-7, err_msg=k)
            else:
                assert (np.abs(_t32(tp[k]) - w) <= _bf16_ulp(w)).all(), k


def test_adamw_weight_decay_reaches_every_leaf():
    """A zero gradient still decays every leaf, norms and biases
    included, as the reference's does."""
    p = {"norm": torch.ones(4), "bias": torch.full((3,), 2.0)}
    g = {k: torch.zeros_like(v) for k, v in p.items()}
    adamw_update(p, g, adamw_init(p), 0.5, weight_decay=0.1)
    assert torch.allclose(p["norm"], torch.full((4,), 0.95))
    assert torch.allclose(p["bias"], torch.full((3,), 1.9))


@pytest.mark.parametrize("dtype", DTYPES)
def test_int8_compression_bit_for_bit(dtype):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(3)
    for scale in (1e-6, 1.0, 1e4):
        x = (rng.standard_normal((64, 9)) * scale).astype(np.float32)
        jq, js = JC.compress_int8(jnp.asarray(x, jdt))
        tq, ts = compress_int8(torch.from_numpy(x).to(tdt))
        assert tq.dtype == torch.int8 and ts.dtype == torch.float32
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        assert ts.numpy().tobytes() == np.asarray(js, np.float32).tobytes()
        np.testing.assert_array_equal(
            decompress_int8(tq, ts).numpy(),
            np.asarray(JC.decompress_int8(jq, js)))


# ---------------------------------------------------------------------------
# error feedback across 4 ranks
# ---------------------------------------------------------------------------
WORLD, ROUNDS = 4, 3


_DRAWS = textwrap.dedent('''
    import numpy as np
    def grads(rank, rnd):
        rng = np.random.default_rng(100 * rnd + rank)
        return {"w": rng.standard_normal((6, 5)).astype(np.float32)
                * (rank + 1), "b": rng.standard_normal(7).astype(np.float32)}
''')

_REFERENCE = _DRAWS + textwrap.dedent('''
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P
    from repro.compat import shard_map
    from repro.optim.compression import error_feedback_allreduce
    assert len(jax.devices()) == 4
    mesh = Mesh(np.array(jax.devices()), ("pod",))
    fn = shard_map(
        lambda g, r: jax.tree.map(
            lambda x: x[None], error_feedback_allreduce(
                jax.tree.map(lambda x: x[0], g),
                jax.tree.map(lambda x: x[0], r), "pod")),
        mesh=mesh, in_specs=(P("pod"), P("pod")),
        out_specs=(P("pod"), P("pod")))
    res = {k: np.zeros((4,) + v.shape, np.float32)
           for k, v in grads(0, 0).items()}
    out = {}
    for rnd in range(3):
        g = {k: np.stack([grads(r, rnd)[k] for r in range(4)])
             for k in res}
        avg, res = fn(g, res)
        res = {k: np.asarray(v) for k, v in res.items()}
        for k in res:
            out[f"{rnd}/avg/{k}"] = np.asarray(avg[k])
            out[f"{rnd}/res/{k}"] = res[k]
    np.savez(sys.argv[1], **out)
''')

_RANK = _DRAWS + textwrap.dedent('''
    import datetime, sys
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    out, rank, store = sys.argv[1], int(sys.argv[2]), sys.argv[3]
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=4,
                            timeout=datetime.timedelta(seconds=60))
    from repro_torch.optim.compression import error_feedback_allreduce
    res = {k: torch.zeros(v.shape) for k, v in grads(rank, 0).items()}
    rec = {}
    for rnd in range(3):
        g = {k: torch.from_numpy(v) for k, v in grads(rank, rnd).items()}
        avg, res = error_feedback_allreduce(g, res)
        for k in res:
            rec[f"{rnd}/avg/{k}"] = avg[k].numpy()
            rec[f"{rnd}/res/{k}"] = res[k].numpy()
    np.savez(out, **rec)
    dist.barrier()
    dist.destroy_process_group()
''')


def test_error_feedback_allreduce_4_ranks_matches_reference(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu")
    (tmp_path / "ref.py").write_text(_REFERENCE)
    (tmp_path / "rank.py").write_text(_RANK)
    cmds = [[sys.executable, str(tmp_path / "ref.py"),
             str(tmp_path / "ref.npz")]]
    cmds += [[sys.executable, str(tmp_path / "rank.py"),
              str(tmp_path / f"rank{r}.npz"), str(r),
              str(tmp_path / "store")] for r in range(WORLD)]
    procs = [subprocess.Popen(c, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for c in cmds]
    try:
        logs = [p.communicate(timeout=180) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, (o, e) in zip(procs, logs):
        assert p.returncode == 0, e[-4000:]
    with np.load(tmp_path / "ref.npz") as z:
        ref = {k: z[k] for k in z.files}
    avgs = []
    for r in range(WORLD):
        with np.load(tmp_path / f"rank{r}.npz") as z:
            got = {k: z[k] for k in z.files}
        assert len(got) == 4 * ROUNDS
        for k, v in got.items():
            want = ref[k][r]
            if "/res/" in k:
                np.testing.assert_array_equal(v, want, err_msg=k)
            else:
                np.testing.assert_allclose(v, want, rtol=1e-6, atol=0,
                                           err_msg=k)
        avgs.append(got[f"{ROUNDS - 1}/avg/w"])
    for a in avgs[1:]:  # every rank holds the same average
        np.testing.assert_array_equal(a, avgs[0])
