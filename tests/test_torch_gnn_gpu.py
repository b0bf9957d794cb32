"""The GNN stack on the card: each model's output on a CUDA device against
the same module moved to the CPU, on the same batch, at ``smoke()`` width
(and PNA's ``[E, d_hidden]`` working set at a larger graph). No kernel of
``csrc/`` runs here: the message passing is PyTorch's gathers and
scatters.

Every test carries the ``gpu`` marker and skips without a CUDA device;
the module imports neither jax nor the reference package.

Tolerances, those of the CPU parity tests (``tests/test_torch_gnn_*.py``):
GIN, DimeNet float32, NequIP energies and forces rtol/atol 1e-4 (TF32
off); DimeNet bfloat16 rtol/atol 3e-2; PNA float32: rtol/atol 1e-4 on
the rows ``pna_conditioned_rows`` names, and on the rest (fed by a node
of in-degree 0 or 1, where PNA's std and attenuation scalers are
ill-conditioned; see ``tests/test_torch_gnn_models.py``) the card's
largest absolute error against the CPU's float64 output at most 3x the
CPU's own float32 output's."""
import copy
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.data.graphs import load_cora_like, random_molecule_batch
from repro_torch.graph.generators import erdos_renyi
from repro_torch.graph.sampler import NeighborSampler
from repro_torch.models import gnn as T

pytestmark = pytest.mark.gpu

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True)
def _card_no_tf32():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the card's forward is the test")
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = old


def _gen():
    return torch.Generator().manual_seed(0)


def _on_cpu(model):
    return copy.deepcopy(model).to("cpu")


@pytest.mark.parametrize("seed", [0, 1])
def test_pna_on_the_card_matches_the_cpu(seed):
    cfg = configs.get_arch("pna").smoke()
    _, batch, _ = load_cora_like(n=300, m=900, d_feat=cfg.d_in,
                                 n_classes=cfg.n_classes, seed=seed,
                                 device="cuda")
    model = T.pna_init(cfg, _gen(), device="cuda")
    with torch.no_grad():
        got = model(batch).cpu()
        cpu = _on_cpu(model)
        b_cpu = batch.to("cpu")
        want32 = cpu(b_cpu)
        b64 = dataclasses.replace(b_cpu, node_feat=b_cpu.node_feat.double())
        want64 = cpu.double()(b64)
    assert got.shape == want32.shape and torch.isfinite(got).all()
    ok = T.pna_conditioned_rows(b_cpu, cfg.n_layers)
    assert ok.any()
    torch.testing.assert_close(got[ok], want32[ok], **TOL)
    rest = ~ok
    ref_err = float((want32.double() - want64)[rest].abs().max())
    err = float((got.double() - want64)[rest].abs().max())
    assert err <= 3 * max(ref_err, 1e-6 * float(want64.abs().max()))


def test_pna_keeps_two_edge_tensors_live():
    """At ``[E, d_hidden]`` = 2,000,000 x 75 the forward's peak above its
    inputs stays under 2.2 message tensors: msg and msg * msg, and the
    layer's ``[N, ...]`` tensors (N = 20,000), none kept across layers."""
    cfg = dataclasses.replace(configs.get_arch("pna").full(), d_in=16)
    n, e = 20_000, 2_000_000
    rng = np.random.default_rng(0)
    snd = torch.from_numpy(rng.integers(0, n, e)).cuda()
    rcv = torch.from_numpy(rng.integers(0, n, e)).cuda()
    batch = T.GraphBatch(
        node_feat=torch.randn(n, cfg.d_in, device="cuda"), senders=snd,
        receivers=rcv, edge_mask=snd != rcv,
        node_mask=torch.ones(n, dtype=torch.bool, device="cuda"),
        graph_id=torch.zeros(n, dtype=torch.int64, device="cuda"),
        n_graphs=1)
    model = T.pna_init(cfg, _gen(), device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    with torch.no_grad():
        out = model(batch)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    msg = e * cfg.d_hidden * 4
    assert torch.isfinite(out).all()
    assert peak < 2.2 * msg, (peak, msg)


def test_gin_on_a_sampled_block_matches_the_cpu():
    cfg = configs.get_arch("gin-tu").smoke()
    g = erdos_renyi(1024, 2048, seed=0)
    blk = NeighborSampler(g, fanouts=(3, 2), seed=0).sample(
        np.random.default_rng(0).choice(g.n, 16, replace=False))
    feat = np.random.default_rng(1).normal(
        size=(blk.node_ids.shape[0], cfg.d_in)).astype(np.float32)
    batch = T.GraphBatch.from_block(blk, feat, device="cuda")
    model = T.gin_init(cfg, _gen(), device="cuda")
    with torch.no_grad():
        got = model(batch).cpu()
        want = _on_cpu(model)(batch.to("cpu"))
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dimenet_on_the_card_matches_the_cpu(dtype):
    cfg = dataclasses.replace(configs.get_arch("dimenet").smoke(),
                              msg_dtype=dtype)
    batch = random_molecule_batch(n_mols=4, n_atoms=8, n_edges=24, seed=0,
                                  device="cuda")
    tri = T.build_triplets(batch.senders.cpu().numpy(),
                           batch.receivers.cpu().numpy(),
                           batch.edge_mask.cpu().numpy(),
                           2 * batch.senders.shape[0])
    model = T.dimenet_init(cfg, _gen(), device="cuda")
    with torch.no_grad():
        got = model(batch, *T.triplet_tensors(tri, "cuda")).cpu()
        want = _on_cpu(model)(batch.to("cpu"), *T.triplet_tensors(tri, "cpu"))
    tol = TOL if dtype == torch.float32 else dict(rtol=3e-2, atol=3e-2)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **tol)


def test_nequip_on_the_card_matches_the_cpu_and_is_equivariant():
    cfg = configs.get_arch("nequip").smoke()
    batch = random_molecule_batch(n_mols=4, n_atoms=8, n_edges=24, seed=0,
                                  device="cuda")
    model = T.nequip_init(cfg, _gen(), device="cuda")
    e, f = model.energy_forces(batch)
    e_cpu, f_cpu = _on_cpu(model).energy_forces(batch.to("cpu"))
    np.testing.assert_allclose(e.cpu().numpy(), e_cpu.numpy(), **TOL)
    np.testing.assert_allclose(f.cpu().numpy(), f_cpu.numpy(), **TOL)
    rng = np.random.default_rng(3)
    q, r = np.linalg.qr(rng.normal(size=(3, 3)))
    q = q * np.sign(np.diag(r))
    if np.linalg.det(q) < 0:
        q[:, 0] = -q[:, 0]
    R = torch.from_numpy(q).to("cuda", torch.float32)
    e1, f1 = model.energy_forces(
        dataclasses.replace(batch, positions=batch.positions @ R.T))
    np.testing.assert_allclose(e.cpu().numpy(), e1.cpu().numpy(), **TOL)
    np.testing.assert_allclose((f @ R.T).cpu().numpy(), f1.cpu().numpy(),
                               rtol=1e-3, atol=1e-4)
