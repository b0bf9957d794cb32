"""DeepFM serving, its data and its configs: the port
(``repro_torch.models.recsys``, ``data/recsys.py``, ``configs``) against
the reference on the CPU, at ``smoke()`` width. Parameters come from the
reference's ``deepfm_init`` and are carried over by
``deepfm_params_from_reference``; inputs are made with numpy and fed to
both. With ``use_pallas_fm=True`` the reference runs its Pallas FM kernel
in interpret mode and the port the kernel's plain version.

Tolerance for logits, scores and bags: rtol/atol 1e-4 in float32 (the
MLP's matmuls and the FM sum run in another order)."""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as ref_configs  # noqa: E402
from repro.configs import common as ref_common  # noqa: E402
from repro.data.recsys import synthetic_ctr_batches as ref_batches  # noqa: E402
from repro.models import recsys as jr  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.configs import common  # noqa: E402
from repro_torch.data.recsys import synthetic_ctr_batches  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.models import recsys as tr  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def deepfm():
    """The smoke config in both packages, the reference's parameters and
    the port's module built from them."""
    jc = ref_configs.get_arch("deepfm").smoke()
    tc = configs.get_arch("deepfm").smoke()
    params = jr.deepfm_init(jc, jax.random.PRNGKey(0))
    model = tr.deepfm_params_from_reference(
        jax.tree.map(np.asarray, params), tc, device="cpu")
    return jc, tc, params, model


def _sparse(cfg, b, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.rows_per_field, (b, cfg.n_sparse)).astype(
        np.int32)


# -- data ---------------------------------------------------------------------

@pytest.mark.parametrize("n_fields,rows,batch,seed", [(8, 1000, 16, 0),
                                                      (39, 1_000_000, 64, 3)])
def test_synthetic_ctr_batches_equal_reference(n_fields, rows, batch, seed):
    a = synthetic_ctr_batches(n_fields, rows, batch, seed=seed)
    b = ref_batches(n_fields, rows, batch, seed=seed)
    for _ in range(3):
        (ia, la), (ib, lb) = next(a), next(b)
        assert ia.dtype == ib.dtype and la.dtype == lb.dtype
        np.testing.assert_array_equal(ia, ib)
        np.testing.assert_array_equal(la, lb)


# -- configs ------------------------------------------------------------------

def test_registry_holds_the_ported_archs():
    gnn = ["pna", "gin-tu", "dimenet", "nequip"]
    assert configs.arch_names() == gnn + ["deepfm"]
    assert configs.arch_names(include_coremaint=True) == gnn + [
        "deepfm", "coremaint"]
    # the reference's order
    ref = ref_configs.arch_names(include_coremaint=True)
    assert [n for n in ref if n in configs.arch_names(True)] == \
        configs.arch_names(True)
    for name in configs.arch_names(include_coremaint=True):
        assert name in ref_configs.arch_names(include_coremaint=True)


@pytest.mark.parametrize("name", ["qwen2-7b", "yi-34b", "deepseek-v2-236b"])
def test_unported_archs_raise_key_error(name):
    ref_configs.get_arch(name)  # the reference has it
    with pytest.raises(KeyError, match="not ported yet"):
        configs.get_arch(name)


def test_unknown_arch_raises_the_reference_key_error():
    with pytest.raises(KeyError, match="unknown arch 'nope'") as got:
        configs.get_arch("nope")
    with pytest.raises(KeyError, match="unknown arch 'nope'"):
        ref_configs.get_arch("nope")
    assert "not ported" not in str(got.value)


def _fields(cfg):
    return {k: v for k, v in dataclasses.asdict(cfg).items() if k != "dtype"}


@pytest.mark.parametrize("name", ["deepfm", "coremaint"])
@pytest.mark.parametrize("size", ["full", "smoke"])
def test_arch_configs_equal_reference(name, size):
    a, b = configs.get_arch(name), ref_configs.get_arch(name)
    assert a.FAMILY == b.FAMILY
    for cells in ("SHAPES", "SHAPES_SMOKE"):
        assert [dataclasses.astuple(c) for c in getattr(a, cells)] == [
            dataclasses.astuple(c) for c in getattr(b, cells)]
    ca, cb = getattr(a, size)(), getattr(b, size)()
    assert type(ca).__name__ == type(cb).__name__
    assert _fields(ca) == _fields(cb)
    if name == "deepfm":
        assert ca.dtype == torch.float32 and cb.dtype == jnp.float32
        assert ca.vocab_total == cb.vocab_total
        assert ca.n_params == cb.n_params


@pytest.mark.parametrize("shapes", ["LM_SHAPES", "LM_SHAPES_SMOKE",
                                    "GNN_SHAPES", "GNN_SHAPES_SMOKE",
                                    "RECSYS_SHAPES", "RECSYS_SHAPES_SMOKE"])
def test_shape_lists_equal_reference(shapes):
    got, want = getattr(common, shapes), getattr(ref_common, shapes)
    assert [dataclasses.astuple(c) for c in got] == [
        dataclasses.astuple(c) for c in want]


# -- the model --------------------------------------------------------------

@pytest.mark.parametrize("use_pallas_fm", [False, True])
@pytest.mark.parametrize("b", [16, 128, 1])
def test_deepfm_forward_matches_reference(deepfm, use_pallas_fm, b):
    jc, tc, params, model = deepfm
    jc = dataclasses.replace(jc, use_pallas_fm=use_pallas_fm)
    tc = dataclasses.replace(tc, use_pallas_fm=use_pallas_fm)
    sparse = _sparse(jc, b, seed=b)
    want = np.asarray(jr.deepfm_forward(jc, params, jnp.asarray(sparse)))
    got = tr.deepfm_forward(tc, model, torch.from_numpy(sparse))
    assert got.dtype == torch.float32 and got.shape == (b,)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # the module's forward is the functional one
    if not use_pallas_fm:
        torch.testing.assert_close(model(torch.from_numpy(sparse)), got,
                                   rtol=0, atol=0)


def test_deepfm_forward_with_dense_features(deepfm):
    jc, tc, params, _ = deepfm
    jc = dataclasses.replace(jc, n_dense=3)
    tc = dataclasses.replace(tc, n_dense=3)
    params = jr.deepfm_init(jc, jax.random.PRNGKey(1))
    model = tr.deepfm_params_from_reference(
        jax.tree.map(np.asarray, params), tc, device="cpu")
    sparse = _sparse(jc, 32, seed=4)
    dense = np.random.default_rng(5).normal(size=(32, 3)).astype(np.float32)
    want = np.asarray(jr.deepfm_forward(jc, params, jnp.asarray(sparse),
                                        jnp.asarray(dense)))
    got = tr.deepfm_forward(tc, model, torch.from_numpy(sparse),
                            torch.from_numpy(dense))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_deepfm_loss_matches_reference(deepfm):
    jc, tc, params, model = deepfm
    sparse = _sparse(jc, 64, seed=9)
    labels = np.random.default_rng(9).integers(0, 2, 64).astype(np.float32)
    want = float(jr.deepfm_loss(jc, params, jnp.asarray(sparse),
                                jnp.asarray(labels)))
    got = float(tr.deepfm_loss(tc, model, torch.from_numpy(sparse),
                               torch.from_numpy(labels)))
    assert got == pytest.approx(want, rel=1e-4, abs=1e-4)


@pytest.mark.parametrize("n_cand", [1024, 512])
def test_retrieval_score_matches_reference(deepfm, n_cand):
    jc, tc, params, model = deepfm
    query = _sparse(jc, 1, seed=n_cand)
    cand = np.random.default_rng(0).normal(
        size=(n_cand, jc.embed_dim)).astype(np.float32)
    want = np.asarray(jr.retrieval_score(jc, params, jnp.asarray(query),
                                         jnp.asarray(cand)))
    got = tr.retrieval_score(tc, model, torch.from_numpy(query),
                             torch.from_numpy(cand))
    assert got.shape == (1, n_cand)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("combine", ["sum", "mean"])
@pytest.mark.parametrize("weighted", [False, True])
def test_embedding_bag_matches_reference(combine, weighted):
    """Unsorted bag ids, an empty bag (3), an out-of-range bag id (7,
    dropped as ``segment_sum`` drops it)."""
    rng = np.random.default_rng(2)
    table = rng.normal(size=(50, 6)).astype(np.float32)
    ids = rng.integers(0, 50, size=20).astype(np.int32)
    bags = np.array([4, 0, 2, 0, 1, 4, 4, 2, 0, 1,
                     5, 5, 0, 2, 7, 1, 4, 0, 2, 5], dtype=np.int32)
    w = rng.random(20).astype(np.float32) if weighted else None
    want = np.asarray(jr.embedding_bag(
        jnp.asarray(table), jnp.asarray(ids), jnp.asarray(bags), 6,
        None if w is None else jnp.asarray(w), combine))
    got = tr.embedding_bag(
        torch.from_numpy(table), torch.from_numpy(ids),
        torch.from_numpy(bags), 6,
        None if w is None else torch.from_numpy(w), combine)
    assert got.shape == (6, 6)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert not got[3].any()


def test_embedding_bag_without_bags_is_a_gather():
    rng = np.random.default_rng(3)
    table = rng.normal(size=(30, 4)).astype(np.float32)
    ids = rng.integers(0, 30, size=9)
    want = np.asarray(jr.embedding_bag(jnp.asarray(table), jnp.asarray(ids)))
    got = tr.embedding_bag(torch.from_numpy(table), torch.from_numpy(ids))
    np.testing.assert_array_equal(got.numpy(), want)


def test_deepfm_params_carry_the_mlp_layout(deepfm):
    """The reference's MLP weights are [in, out]; the module's Linear
    layers hold them as [out, in]."""
    _, tc, params, model = deepfm
    for lin, lyr, (a, b) in zip(model.mlp, params["mlp"], tc.mlp_shapes()):
        assert tuple(lyr["w"].shape) == (a, b)
        assert tuple(lin.weight.shape) == (b, a)
        np.testing.assert_array_equal(lin.weight.numpy().T,
                                      np.asarray(lyr["w"]))
    np.testing.assert_array_equal(model.embed.numpy(),
                                  np.asarray(params["embed"]))
    assert not any(p.requires_grad for p in model.parameters())


def _no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_deepfm_init_follows_the_reference_laws(monkeypatch):
    """Seeded, with the reference's shapes and scales (normal x 0.01
    tables, normal / sqrt(in) MLP, zero biases); an explicit "cpu"
    gives the same numbers from the same generator seed, and
    ``device=None`` means the card, raising without one as
    ``CoreMaintainer`` does."""
    cfg = configs.get_arch("deepfm").smoke()
    a = tr.deepfm_init(cfg, torch.Generator().manual_seed(0), "cpu")
    b = tr.deepfm_init(cfg, torch.Generator().manual_seed(0), device="cpu")
    for pa, pb in zip(a.parameters(), b.parameters()):
        assert pa.device.type == "cpu"
        assert torch.equal(pa, pb)
    assert a.embed.shape == (cfg.vocab_total, cfg.embed_dim)
    assert a.w1.shape == (cfg.vocab_total,) and a.bias.item() == 0.0
    assert 0.008 < a.embed.std().item() < 0.012
    first = a.mlp[0]
    d_in = cfg.n_sparse * cfg.embed_dim
    assert abs(first.weight.std().item() * d_in ** 0.5 - 1.0) < 0.1
    assert not any(lin.bias.any() for lin in a.mlp)
    # n_params (the reference's count) leaves out the scalar bias
    assert sum(p.numel() for p in a.parameters()) == cfg.n_params + 1
    _no_card(monkeypatch)
    with pytest.raises(RuntimeError, match="CUDA device by default"):
        tr.deepfm_init(cfg, torch.Generator().manual_seed(0))


def test_deepfm_module_defaults_to_the_card(monkeypatch):
    """``DeepFM(cfg)`` without a device is built on the card: it raises
    without one, and ``device="cpu"`` builds on the CPU."""
    cfg = configs.get_arch("deepfm").smoke()
    assert all(p.device.type == "cpu"
               for p in tr.DeepFM(cfg, device="cpu").parameters())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve_device() == torch.device("cuda")
    _no_card(monkeypatch)
    with pytest.raises(RuntimeError, match="CUDA device by default"):
        tr.DeepFM(cfg)


def test_deepfm_params_from_reference_defaults_to_the_card(deepfm,
                                                           monkeypatch):
    """The reference's parameters go to the card without a device (and
    raise without one); on ``"cpu"`` they are carried over exactly."""
    _, tc, params, model = deepfm
    arrays = jax.tree.map(np.asarray, params)
    again = tr.deepfm_params_from_reference(arrays, tc, device="cpu")
    for pa, pb in zip(again.parameters(), model.parameters()):
        assert torch.equal(pa, pb)
    _no_card(monkeypatch)
    with pytest.raises(RuntimeError, match="CUDA device by default"):
        tr.deepfm_params_from_reference(arrays, tc)
