"""The port's training runtime (``repro_torch.train``) on the CPU: the
counterpart of each test in ``tests/test_train_infra.py``, the toy run
held to the reference's step by step, checkpoints across the two
packages, bfloat16 checkpoints, and the preemption guard under a real
SIGTERM.

Tolerances. The toy run's ``history`` (loss, grad_norm, lr) and final
weights against the reference's at rtol 1e-5 (float32; the two packages
reduce in different orders). Resume against an uninterrupted run: bit
for bit (the port's CPU run is deterministic), and at the reference's
own rtol 1e-5 / atol 1e-6 in its counterpart. Micro-batching against the
full batch at the reference's rtol 1e-4 / atol 1e-6. Checkpoints: bit
for bit, both ways.
"""
import os
import signal
import time

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.models import gnn as JG  # noqa: E402
from repro.models import recsys as JR  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.optim.adamw import adamw_init as j_adamw_init  # noqa: E402
from repro.train import checkpoint as jckpt  # noqa: E402
from repro.train.loop import TrainConfig as JTrainConfig  # noqa: E402
from repro.train.loop import run_training as j_run_training  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.models import gnn as G  # noqa: E402
from repro_torch.models import recsys as R  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.optim.adamw import adamw_init  # noqa: E402
from repro_torch.optim.compression import compress_int8, decompress_int8
from repro_torch.optim.params import named, tensors_from_reference  # noqa
from repro_torch.optim.schedule import cosine_with_warmup
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.fault import (ElasticMesh, PreemptionGuard,
                                     StragglerMonitor)
from repro_torch.train.loop import TrainConfig, make_train_step, run_training


def _toy_setup():
    def loss_fn(params, x, y):
        pred = x @ params["w"] + params["b"]
        return torch.mean((pred - y) ** 2)

    rng = np.random.default_rng(0)
    w_true = rng.normal(size=(4, 1)).astype(np.float32)

    def batches(n, seed=0):
        r = np.random.default_rng(seed)
        for _ in range(n):
            x = r.normal(size=(16, 4)).astype(np.float32)
            y = x @ w_true + 0.01 * r.normal(size=(16, 1)).astype(np.float32)
            yield torch.from_numpy(x), torch.from_numpy(y)

    params = {"w": torch.zeros((4, 1)), "b": torch.zeros((1,))}
    return loss_fn, batches, params


def _fresh(params):
    return {k: v.detach().clone() for k, v in params.items()}


# ---------------------------------------------------------------------------
# the counterparts of tests/test_train_infra.py
# ---------------------------------------------------------------------------
def test_training_converges_and_checkpoints(tmp_path):
    loss_fn, batches, params = _toy_setup()
    tc = TrainConfig(lr=1e-1, warmup=2, total_steps=30,
                     ckpt_dir=str(tmp_path), ckpt_every=10)
    params, report = run_training(params, loss_fn, batches(40), tc)
    hist = report["history"]
    assert hist[-1]["loss"] < 0.05 * hist[0]["loss"]
    assert ckpt.latest_step(str(tmp_path)) is not None
    assert report["final_step"] == 30 and len(hist) == 30


def test_resume_reproduces_uninterrupted_run(tmp_path):
    loss_fn, batches, params0 = _toy_setup()
    tc = TrainConfig(lr=1e-1, warmup=2, total_steps=20)
    p_full, _ = run_training(_fresh(params0), loss_fn, batches(30), tc)

    dir1 = str(tmp_path / "ck")
    tc1 = TrainConfig(lr=1e-1, warmup=2, total_steps=20, ckpt_dir=dir1,
                      ckpt_every=9)
    run_training(_fresh(params0), loss_fn, batches(10), tc1)
    last = ckpt.latest_step(dir1)
    assert last == 9
    tc2 = TrainConfig(lr=1e-1, warmup=2, total_steps=20, ckpt_dir=dir1,
                      ckpt_every=100)
    stream = batches(30)
    for _ in range(last + 1):  # skip consumed batches
        next(stream)
    p_res, rep = run_training(_fresh(params0), loss_fn, stream, tc2)
    assert len(rep["history"]) == 10
    np.testing.assert_allclose(p_res["w"].detach().numpy(),
                               p_full["w"].detach().numpy(), rtol=1e-5,
                               atol=1e-6)
    for k in p_full:  # and bit for bit: the CPU run is deterministic
        assert torch.equal(p_res[k], p_full[k]), k


def test_checkpoint_commit_markers_reject_corruption(tmp_path):
    state = {"a": torch.arange(8, dtype=torch.float32)}
    ckpt.save_checkpoint(str(tmp_path), 5, state)
    assert ckpt.latest_step(str(tmp_path)) == 5
    shard = os.path.join(str(tmp_path), "step_0000000005",
                         "shard_00000.npz")
    with open(shard, "r+b") as f:
        f.seek(30)
        f.write(b"\x00\x01\x02")
    assert ckpt.latest_step(str(tmp_path)) is None


def test_uncommitted_step_is_skipped_and_prune_keeps_the_last(tmp_path):
    d = str(tmp_path)
    state = {"a": torch.ones(3)}
    for s in (1, 2, 3, 4):
        ckpt.save_checkpoint(d, s, state)
    os.remove(os.path.join(d, "step_0000000004", "COMMIT_00000"))
    assert ckpt.latest_step(d) == 3
    ckpt.prune_checkpoints(d, keep=2)
    assert sorted(os.listdir(d)) == ["step_0000000003", "step_0000000004"]
    assert ckpt.latest_step(d) == 3


def test_microbatch_accumulation_matches_full_batch():
    loss_fn, batches, params = _toy_setup()
    tc1 = TrainConfig(lr=1e-2, warmup=1, total_steps=10, micro_batches=1)
    tc4 = TrainConfig(lr=1e-2, warmup=1, total_steps=10, micro_batches=4)
    x, y = next(batches(1))
    p1, p4 = _fresh(params), _fresh(params)
    _, _, m1 = make_train_step(loss_fn, tc1)(p1, adamw_init(p1), 0, x, y)
    _, _, m4 = make_train_step(loss_fn, tc4)(p4, adamw_init(p4), 0, x, y)
    np.testing.assert_allclose(p1["w"].detach().numpy(),
                               p4["w"].detach().numpy(), rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(float(m1["loss"]), float(m4["loss"]),
                               rtol=1e-5)


def test_microbatch_gradients_accumulate_in_float32(monkeypatch):
    """bf16 parameters, 4 micro-batches whose gradients are 1, 2^-8,
    2^-8, 2^-8: added into a float32 buffer the mean is (1 + 3 2^-8) / 4;
    accumulated in bf16 each 2^-8 would round away against 1."""
    import repro_torch.train.loop as L

    def loss_fn(p, x):
        return (p["w"] * x).sum()

    got = {}

    def spy(params, grads, state, lr, **kw):
        got.update({k: g.clone() for k, g in grads.items()})
        return params, state

    monkeypatch.setattr(L, "adamw_update", spy)
    p = {"w": torch.zeros(4, dtype=torch.bfloat16)}
    x = torch.tensor([1.0, 2 ** -8, 2 ** -8, 2 ** -8])[:, None].expand(
        4, 4).to(torch.bfloat16)
    make_train_step(loss_fn, TrainConfig(micro_batches=4, clip_norm=1e9))(
        p, adamw_init(p), 0, x)
    assert got["w"].dtype == torch.float32
    assert torch.equal(got["w"], torch.full((4,), (1 + 3 * 2 ** -8) / 4))


def test_int8_compression_error_feedback_bounded():
    rng = np.random.default_rng(0)
    g = torch.from_numpy(rng.normal(size=(256,)).astype(np.float32))
    q, s = compress_int8(g)
    deq = decompress_int8(q, s)
    rel = float(torch.linalg.norm(deq - g) / torch.linalg.norm(g))
    assert rel < 0.01
    residual = torch.zeros_like(g)
    total = torch.zeros_like(g)
    for _ in range(10):
        q, s = compress_int8(g + residual)
        deq = decompress_int8(q, s)
        residual = g + residual - deq
        total = total + deq
    np.testing.assert_allclose((total / 10).numpy(), g.numpy(), rtol=0.02,
                               atol=2e-3)


def test_schedule_shapes():
    assert float(cosine_with_warmup(0, 1e-3, 10, 100)) == 0.0
    assert abs(float(cosine_with_warmup(10, 1e-3, 10, 100)) - 1e-3) < 1e-9
    assert float(cosine_with_warmup(100, 1e-3, 10, 100)) <= 0.11e-3 + 1e-9


def test_straggler_monitor_flags_outliers():
    mon = StragglerMonitor(deadline_factor=2.0, window=16)
    for i in range(12):
        mon.step_start(i)
        mon.durations.append(0.01)
    mon.step_start(99)
    mon._t0 -= 1.0  # pretend the step took 1s
    mon.step_end()
    assert 99 in mon.straggler_steps


def test_elastic_mesh_next_shape():
    avail = [8]
    em = ElasticMesh(8, lambda: avail[0])
    assert not em.needs_remesh(8) and em.next_shape() == 8
    avail[0] = 6
    assert em.needs_remesh(8) and em.next_shape() == 4


# ---------------------------------------------------------------------------
# the preemption guard under a real SIGTERM
# ---------------------------------------------------------------------------
def test_preemption_guard_catches_sigterm_and_restores_the_handler():
    seen = []
    old = signal.signal(signal.SIGTERM, lambda *a: seen.append(a[0]))
    try:
        guard = PreemptionGuard().install()
        os.kill(os.getpid(), signal.SIGTERM)
        time.sleep(0.01)
        assert guard.requested and not seen
        guard.uninstall()
        os.kill(os.getpid(), signal.SIGTERM)
        time.sleep(0.01)
        assert seen == [signal.SIGTERM]
    finally:
        signal.signal(signal.SIGTERM, old)


def test_sigterm_inside_the_loop_checkpoints_and_resumes(tmp_path):
    """A SIGTERM sent at step 6 (inside the guard's window: between the
    install in run_training and its uninstall) makes the loop save that
    step and stop; the handler outside the loop is untouched; resuming
    from the checkpoint reproduces the uninterrupted run bit for bit."""
    loss_fn, batches, params0 = _toy_setup()
    tc = TrainConfig(lr=5e-2, warmup=2, total_steps=15)
    p_full, _ = run_training(_fresh(params0), loss_fn, batches(20), tc)

    d = str(tmp_path / "ck")
    tc1 = TrainConfig(lr=5e-2, warmup=2, total_steps=15, ckpt_dir=d,
                      ckpt_every=1000)

    def kill_at_6(step, _m):
        if step == 6:
            os.kill(os.getpid(), signal.SIGTERM)
            time.sleep(0.01)

    seen = []
    old = signal.signal(signal.SIGTERM, lambda *a: seen.append(a[0]))
    try:
        _, rep = run_training(_fresh(params0), loss_fn, batches(20), tc1,
                              on_step=kill_at_6)
        assert signal.getsignal(signal.SIGTERM) is not None and not seen
        assert rep["final_step"] == 6 and len(rep["history"]) == 7
        # step 0 (ckpt_every) and step 6 (the SIGTERM) were saved
        assert ckpt.latest_step(d) == 6
        stream = batches(20)
        for _ in range(7):
            next(stream)
        p_res, rep2 = run_training(_fresh(params0), loss_fn, stream, tc1)
        assert len(rep2["history"]) == 8 and not seen
    finally:
        signal.signal(signal.SIGTERM, old)
    for k in p_full:
        assert torch.equal(p_res[k], p_full[k]), k


# ---------------------------------------------------------------------------
# the reference: the toy run step by step, checkpoints both ways
# ---------------------------------------------------------------------------
def test_toy_history_matches_reference_step_by_step():
    loss_fn, batches, params = _toy_setup()

    def j_loss(p, x, y):
        return jnp.mean((x @ p["w"] + p["b"] - y) ** 2)

    def j_batches(n):
        for x, y in batches(n):
            yield jnp.asarray(x.numpy()), jnp.asarray(y.numpy())

    kw = dict(lr=1e-1, warmup=3, total_steps=25, micro_batches=2)
    jp = {"w": jnp.zeros((4, 1), jnp.float32),
          "b": jnp.zeros((1,), jnp.float32)}
    jp, jrep = j_run_training(jp, j_loss, j_batches(30), JTrainConfig(**kw))
    tp, trep = run_training(params, loss_fn, batches(30), TrainConfig(**kw))
    assert len(trep["history"]) == len(jrep["history"]) == 25
    assert trep["final_step"] == jrep["final_step"]
    for i, (got, want) in enumerate(zip(trep["history"], jrep["history"])):
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=0,
                                       err_msg=f"step {i} {k}")
    for k in ("w", "b"):
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]),
                                   rtol=1e-5, atol=1e-7)


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda x: np.array(x, np.float32), tree)


def _models():
    """(name, reference params, port module) pairs with the same values:
    an LM (stacked layers), PNA (module lists) and DeepFM (an
    ``nn.Linear`` MLP, stored transposed), all float32."""
    import dataclasses
    from repro import configs as jc
    key = jax.random.PRNGKey(0)
    out = []
    jcfg = dataclasses.replace(jc.get_arch("qwen2-7b").smoke(),
                               dtype=jnp.float32)
    tcfg = dataclasses.replace(configs.get_arch("qwen2-7b").smoke(),
                               dtype=torch.float32)
    jp = JT.init_params(jcfg, key)
    out.append(("lm", jp, T.lm_params_from_reference(_np_tree(jp), tcfg,
                                                     "cpu")))
    pcfg = configs.get_arch("pna").smoke()
    jp = JG.pna_init(jc.get_arch("pna").smoke(), key)
    out.append(("pna", jp, G.pna_params_from_reference(_np_tree(jp), pcfg,
                                                       "cpu")))
    dcfg = configs.get_arch("deepfm").smoke()
    jp = JR.deepfm_init(jc.get_arch("deepfm").smoke(), key)
    out.append(("deepfm", jp, R.deepfm_params_from_reference(
        _np_tree(jp), dcfg, "cpu")))
    return out


def _perturbed_state(params, seed):
    """A non-zero optimizer state for ``params`` (port) and the same
    values as the reference's pytree, through the reference's layout."""
    state = adamw_init(params)
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name in ("m", "v"):
            for t in state[name].values():
                t.copy_(torch.from_numpy(rng.standard_normal(
                    tuple(t.shape)).astype(np.float32)))
    state["count"].fill_(7)
    return state


def _zeroed(params, state):
    with torch.no_grad():
        for t in list(named(params).values()) + list(
                state["m"].values()) + list(state["v"].values()):
            t.zero_()
        state["count"].zero_()


@pytest.mark.parametrize("which", ["lm", "pna", "deepfm"])
def test_checkpoint_written_by_the_reference_restores_in_the_port(
        tmp_path, which):
    name, jp, module = next(m for m in _models() if m[0] == which)
    jstate = j_adamw_init(jp)
    jstate = {"m": jax.tree_util.tree_map(lambda x: x + 0.5, jstate["m"]),
              "v": jax.tree_util.tree_map(lambda x: x + 2.0, jstate["v"]),
              "count": jnp.int32(3)}
    jckpt.save_checkpoint(str(tmp_path), 4, (jp, jstate))
    state = adamw_init(module)
    _zeroed(module, state)
    step, _ = ckpt.restore_checkpoint(str(tmp_path), (module, state))
    assert step == 4 and int(state["count"]) == 3
    want = tensors_from_reference(_np_tree(jp), module)
    for k, t in named(module).items():
        assert torch.equal(t, want[k]), k
        assert torch.equal(state["m"][k], torch.full_like(t, 0.5)), k
        assert torch.equal(state["v"][k], torch.full_like(t, 2.0)), k


@pytest.mark.parametrize("which", ["lm", "pna", "deepfm"])
def test_checkpoint_written_by_the_port_restores_in_the_reference(
        tmp_path, which):
    name, jp, module = next(m for m in _models() if m[0] == which)
    state = _perturbed_state(module, 1)
    ckpt.save_checkpoint(str(tmp_path), 9, (module, state))
    like = (jax.tree_util.tree_map(jnp.zeros_like, jp), j_adamw_init(jp))
    step, (rp, rs) = jckpt.restore_checkpoint(str(tmp_path), like)
    assert step == 9 and int(rs["count"]) == 7
    got_p = tensors_from_reference(_np_tree(rp), module)
    got_m = tensors_from_reference(_np_tree(rs["m"]), module)
    got_v = tensors_from_reference(_np_tree(rs["v"]), module)
    for k, t in named(module).items():
        assert torch.equal(got_p[k], t), k
        assert torch.equal(got_m[k], state["m"][k]), k
        assert torch.equal(got_v[k], state["v"][k]), k


def test_toy_checkpoint_keys_are_the_references(tmp_path):
    _, _, params = _toy_setup()
    ckpt.save_checkpoint(str(tmp_path / "port"), 0,
                         (params, adamw_init(params)))
    jp = {"w": jnp.zeros((4, 1), jnp.float32),
          "b": jnp.zeros((1,), jnp.float32)}
    jckpt.save_checkpoint(str(tmp_path / "ref"), 0, (jp, j_adamw_init(jp)))
    shard = os.path.join("step_0000000000", "shard_00000.npz")
    with np.load(tmp_path / "port" / shard) as a, \
            np.load(tmp_path / "ref" / shard) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k


def test_bfloat16_checkpoint_round_trip_in_the_port(tmp_path):
    cfg = configs.get_arch("qwen2-7b").smoke()  # bfloat16
    model = T.init_params(cfg, device="cpu")
    state = _perturbed_state(model, 2)
    ckpt.save_checkpoint(str(tmp_path), 1, (model, state))
    with np.load(os.path.join(str(tmp_path), "step_0000000001",
                              "shard_00000.npz")) as z:
        assert z["[0]/['embed']"].dtype == np.dtype("V2")
        assert z["[1]/['m']/['embed']"].dtype == np.float32
    other = T.init_params(cfg, torch.Generator().manual_seed(5),
                          device="cpu")
    ostate = adamw_init(other)
    step, _ = ckpt.restore_checkpoint(str(tmp_path), (other, ostate))
    assert step == 1 and int(ostate["count"]) == 7
    for k, t in named(model).items():
        got = named(other)[k]
        assert got.dtype == t.dtype and torch.equal(got, t), k
        assert torch.equal(ostate["m"][k], state["m"][k])


def test_port_restores_a_bfloat16_file_the_reference_cannot(tmp_path):
    """The reference writes a bfloat16 leaf as ``|V2`` and its own
    restore raises (``astype`` has no cast from ``|V2``); the port reads
    the same file bit for bit."""
    rng = np.random.default_rng(4)
    vals = rng.standard_normal(16).astype(np.float32)
    state = {"w": jnp.asarray(vals, jnp.bfloat16),
             "s": jnp.asarray(vals[:3], jnp.float32)}
    jckpt.save_checkpoint(str(tmp_path), 0, state)
    with pytest.raises(ValueError, match="No cast function available"):
        jckpt.restore_checkpoint(str(tmp_path), state)
    like = {"w": torch.zeros(16, dtype=torch.bfloat16),
            "s": torch.zeros(3)}
    step, got = ckpt.restore_checkpoint(str(tmp_path), like)
    assert step == 0 and got is like
    want = torch.from_numpy(np.array(jnp.asarray(state["w"], jnp.float32)))
    assert torch.equal(like["w"].float(), want)
    assert torch.equal(like["s"], torch.from_numpy(vals[:3]))
