"""PNA and GIN serving: the port (``repro_torch.models.gnn``) against the
reference on the CPU, at ``smoke()`` width, on every ``GNN_SHAPES_SMOKE``
cell. Parameters come from the reference's ``pna_init`` / ``gin_init``
(every leaf, biases and GIN's ``eps`` too, moved off its initial value by
seeded noise so a misplaced one shows) and are carried over by
``*_params_from_reference``. Inputs: the reference's ``load_cora_like``
at the smoke ``full_graph_sm`` size, a sampled ``NeighborSampler`` block,
and steps-style random batches (``launch/steps.py``'s draws) with
self-loops masked, padded edges pointing at node 0, padded nodes, and a
live node whose every in-edge is masked. The input width is the cell's
``d_feat``, as the reference's cells set it. The reference runs under
``jax.jit``.

Tolerances. GIN: rtol/atol 1e-4 in float32 (the segment sums and the
MLPs' matmuls add in another order). PNA: rtol/atol 1e-4 with both
packages in float64 (the reference's functions take float64 parameters
and features; ``import repro`` turns x64 on), and in float32 the port's
largest absolute error against that float64 output is at most 3x the
reference's own float32 output's. PNA's float32 output cannot be held
elementwise: its std aggregator subtracts ``(s/deg)^2`` from ``sq/deg``,
which cancel to 1e-6 of their size at in-degree 1, and its attenuation
scaler is 2.5e6 at in-degree 0, so one ulp of difference in a message
(another matmul order) moves a logit by up to 1e-3 of the row's scale,
beyond an elementwise 1e-4. Measured on these cells: the port's largest
float32 error against the float64 output is 0.61 to 1.66x the
reference's own; the float64 outputs agree within 4.4% of the 1e-4
tolerance."""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as ref_configs  # noqa: E402
from repro.configs.common import GNN_SHAPES_SMOKE  # noqa: E402
from repro.data.graphs import load_cora_like as ref_cora  # noqa: E402
from repro.graph.generators import erdos_renyi as ref_er  # noqa: E402
from repro.graph.sampler import NeighborSampler as RefSampler  # noqa: E402
from repro.models import gnn as J  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.data.graphs import (  # noqa: E402
    load_cora_like,
    random_molecule_batch,
)
from repro_torch.graph.generators import erdos_renyi  # noqa: E402
from repro_torch.graph.sampler import NeighborSampler  # noqa: E402
from repro_torch.models import gnn as T  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
CELLS = {c.name: c for c in GNN_SHAPES_SMOKE}


def _pad512(x: int) -> int:
    return -(-x // 512) * 512


def _cell_shapes(cell):
    """``launch/steps.py::_graph_shapes_for_cell``: (n, e, d_feat, G)."""
    p = cell.params
    if cell.kind == "full_graph":
        return _pad512(p["n_nodes"]), _pad512(p["n_edges"]), p["d_feat"], 1
    if cell.kind == "minibatch":
        mult = int(np.prod([f + 1 for f in p["fanout"]]))
        n_cap = _pad512(p["batch_nodes"] * mult)
        return n_cap, 2 * n_cap, p["d_feat"], 1
    return (_pad512(p["n_nodes"] * p["batch"]),
            _pad512(p["n_edges"] * p["batch"]), 1, p["batch"])


def steps_batch(n, e, f, g, seed=0, n_pad_nodes=8, n_pad_edges=16,
                molecular=False):
    """``launch/steps.py::_concrete_graph_batch``'s draws, then padded:
    ``n_pad_nodes`` masked nodes, ``n_pad_edges`` masked edges into node
    0, and every in-edge of node 1 masked. Numpy arrays by field."""
    rng = np.random.default_rng(seed)
    snd = rng.integers(0, n, size=e).astype(np.int32)
    rcv = rng.integers(0, n, size=e).astype(np.int32)
    feat = rng.normal(size=(n, f)).astype(np.float32)
    emask = (snd != rcv) & (rcv != 1)
    gid = np.minimum(np.arange(n) * g // max(n, 1), g - 1).astype(np.int32)
    n2, pe = n + n_pad_nodes, n_pad_edges
    out = dict(
        node_feat=np.concatenate(
            [feat, rng.normal(size=(n_pad_nodes, f)).astype(np.float32)]),
        senders=np.concatenate([snd, np.zeros(pe, np.int32)]),
        receivers=np.concatenate([rcv, np.zeros(pe, np.int32)]),
        edge_mask=np.concatenate([emask, np.zeros(pe, bool)]),
        node_mask=np.arange(n2) < n,
        graph_id=np.concatenate([gid, np.full(n_pad_nodes, g - 1,
                                              np.int32)]),
    )
    if molecular:
        out["positions"] = (rng.normal(size=(n2, 3)) * 2).astype(np.float32)
        out["species"] = rng.integers(0, 8, size=n2).astype(np.int32)
    return out, g


def ref_batch(arrays, n_graphs):
    return J.GraphBatch(n_graphs=n_graphs, **{
        k: jnp.asarray(v) for k, v in arrays.items()})


def port_batch(arrays, n_graphs):
    return T.GraphBatch.from_numpy(n_graphs, **arrays).to("cpu")


def batch_arrays(b):
    """A reference batch's arrays by field, as numpy."""
    return {f.name: np.asarray(getattr(b, f.name))
            for f in dataclasses.fields(b)
            if f.name != "n_graphs" and getattr(b, f.name) is not None}


def jitter(params, seed=0, scale=0.1):
    """Every leaf plus seeded noise (biases and eps start at 0)."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda x: np.asarray(x) + scale * rng.normal(size=np.shape(x))
        .astype(np.float32), params)


def _inputs(case):
    """(numpy arrays, n_graphs) for a named input case."""
    if case == "cora":
        c = CELLS["full_graph_sm"].params
        _, b, _ = ref_cora(n=c["n_nodes"], m=c["n_edges"] // 2,
                           d_feat=c["d_feat"], n_classes=4, seed=0)
        return batch_arrays(b), b.n_graphs
    if case == "block":
        c = CELLS["minibatch_lg"].params
        g = ref_er(c["n_nodes"], c["n_edges"] // 2, seed=0)
        s = RefSampler(g, fanouts=c["fanout"], seed=0)
        seeds = np.random.default_rng(0).choice(g.n, c["batch_nodes"],
                                                replace=False)
        blk = s.sample(seeds)
        n_cap = blk.node_ids.shape[0]
        feat = np.random.default_rng(1).normal(
            size=(n_cap, c["d_feat"])).astype(np.float32)
        return dict(node_feat=feat, senders=blk.senders,
                    receivers=blk.receivers, edge_mask=blk.edge_mask,
                    node_mask=blk.node_mask,
                    graph_id=np.zeros(n_cap, np.int32)), 1
    if case == "dense":  # in-degree 8 on average: most rows conditioned
        return steps_batch(512, 4096, 16, 1, seed=4)
    return steps_batch(*_cell_shapes(CELLS[case]), seed=3)


CASES = ["cora", "full_graph_sm", "block", "minibatch_lg", "ogb_products",
         "molecule", "dense"]


@pytest.fixture(scope="module")
def inputs():
    return {case: _inputs(case) for case in CASES}


def _models(arch, d_in, seed):
    jc = dataclasses.replace(ref_configs.get_arch(arch).smoke(), d_in=d_in)
    tc = dataclasses.replace(configs.get_arch(arch).smoke(), d_in=d_in)
    init = J.pna_init if arch == "pna" else J.gin_init
    params = jitter(init(jc, jax.random.PRNGKey(seed)), seed)
    carry = (T.pna_params_from_reference if arch == "pna"
             else T.gin_params_from_reference)
    return jc, params, carry(params, tc, device="cpu")


def _as64(tree):
    return jax.tree.map(lambda x: np.asarray(x, np.float64), tree)


def _arrays64(arrays):
    return dict(arrays, node_feat=arrays["node_feat"].astype(np.float64))


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("arch", ["pna", "gin-tu"])
def test_forward_matches_reference(arch, case, inputs):
    arrays, n_graphs = inputs[case]
    jc, params, model = _models(arch, arrays["node_feat"].shape[1], 0)
    fwd = jax.jit(lambda p, b: (J.pna_forward if arch == "pna"
                                else J.gin_forward)(jc, p, b))
    want = np.asarray(fwd(params, ref_batch(arrays, n_graphs)))
    batch = port_batch(arrays, n_graphs)
    with torch.no_grad():
        got = model(batch)
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    assert tuple(got.shape) == want.shape
    assert torch.isfinite(got).all()
    # the functional form is the module's forward
    port_fwd = T.pna_forward if arch == "pna" else T.gin_forward
    assert torch.equal(port_fwd(model.cfg, model, batch), got)
    if arch == "gin-tu":
        np.testing.assert_allclose(got.numpy(), want, **TOL)
        return
    # rows that float32 computes to within rounding: elementwise; the
    # rest, fed by a node of in-degree 0 or 1, against float64 at 3x the
    # reference's own float32 error there
    ok = T.pna_conditioned_rows(batch, jc.n_layers).numpy()
    if case == "dense":
        assert ok.mean() > 0.9, ok.mean()
    np.testing.assert_allclose(got.numpy()[ok], want[ok], **TOL)
    if (~ok).any():
        want64 = np.asarray(fwd(_as64(params),
                                ref_batch(_arrays64(arrays), n_graphs)))
        ref_err = np.abs(want - want64)[~ok].max()
        port_err = np.abs(got.numpy() - want64)[~ok].max()
        assert port_err <= 3 * ref_err, (port_err, ref_err)


@pytest.mark.parametrize("case", CASES)
def test_pna_float64_matches_reference(case, inputs):
    arrays, n_graphs = inputs[case]
    jc, params, model = _models("pna", arrays["node_feat"].shape[1], 0)
    want = J.pna_forward(jc, jax.tree.map(jnp.asarray, _as64(params)),
                         ref_batch(_arrays64(arrays), n_graphs))
    assert want.dtype == jnp.float64
    model = model.double()
    with torch.no_grad():
        got = model(port_batch(_arrays64(arrays), n_graphs))
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("arch", ["pna", "gin-tu"])
def test_init_law_and_generator(arch):
    cfg = configs.get_arch(arch).smoke()
    init = T.pna_init if arch == "pna" else T.gin_init
    a = init(cfg, torch.Generator().manual_seed(5), device="cpu")
    b = init(cfg, torch.Generator().manual_seed(5), device="cpu")
    c = init(cfg, torch.Generator().manual_seed(6), device="cpu")
    pa, pc = dict(a.named_parameters()), dict(c.named_parameters())
    for k, v in b.named_parameters():
        assert torch.equal(pa[k], v) and not v.requires_grad
    w = pa["layers.0.mlp.0.w" if arch == "gin-tu" else "layers.0.pre.0.w"]
    assert not torch.equal(w, pc["layers.0.mlp.0.w" if arch == "gin-tu"
                                 else "layers.0.pre.0.w"])
    # N(0, 1) / sqrt(in) weights, zero biases (and eps), as the reference
    assert abs(float(w.std() * np.sqrt(w.shape[0])) - 1.0) < 0.2
    assert all(float(p.abs().max()) == 0.0 for k, p in pa.items()
               if k.endswith((".b", "eps")))
    # the reference's pytree carries over to the same parameter names
    jc = ref_configs.get_arch(arch).smoke()
    ref = (J.pna_init if arch == "pna" else J.gin_init)(
        jc, jax.random.PRNGKey(0))
    n_leaves = len(jax.tree.leaves(ref))
    assert n_leaves == len(pa)


def test_carry_over_refuses_a_mismatched_tree():
    jc = ref_configs.get_arch("pna").smoke()
    params = jax.tree.map(np.asarray, J.pna_init(jc, jax.random.PRNGKey(0)))
    cfg = configs.get_arch("pna").smoke()
    with pytest.raises(ValueError, match="shape"):
        T.pna_params_from_reference(
            params, dataclasses.replace(cfg, d_hidden=8), device="cpu")
    with pytest.raises(ValueError, match="entries"):
        T.pna_params_from_reference(
            params, dataclasses.replace(cfg, n_layers=3), device="cpu")


def test_models_and_data_default_to_the_card():
    cfg = configs.get_arch("gin-tu").smoke()
    if torch.cuda.is_available():
        assert next(T.GIN(cfg).parameters()).device.type == "cuda"
        assert random_molecule_batch().positions.device.type == "cuda"
    else:
        for make in (lambda: T.GIN(cfg), lambda: T.nequip_init(
                configs.get_arch("nequip").smoke()),
                lambda: load_cora_like(n=16, m=20, d_feat=4),
                random_molecule_batch):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                make()


def test_block_graph_batch_on_the_port_sampler(inputs):
    """The port's own sampler block as a ``GraphBatch`` holds the
    reference's block (the ``block`` case above)."""
    arrays, _ = inputs["block"]
    c = CELLS["minibatch_lg"].params
    g = erdos_renyi(c["n_nodes"], c["n_edges"] // 2, seed=0)
    s = NeighborSampler(g, fanouts=c["fanout"], seed=0)
    seeds = np.random.default_rng(0).choice(g.n, c["batch_nodes"],
                                            replace=False)
    batch = T.GraphBatch.from_block(s.sample(seeds), arrays["node_feat"],
                                    device="cpu")
    assert batch.senders.dtype == torch.int64
    for k in ("senders", "receivers", "edge_mask", "node_mask"):
        np.testing.assert_array_equal(getattr(batch, k).numpy(), arrays[k])
    np.testing.assert_array_equal(batch.node_feat.numpy(),
                                  arrays["node_feat"])
    assert torch.equal(batch.graph_id, torch.zeros_like(batch.graph_id))
    with pytest.raises(ValueError, match="rows"):
        T.GraphBatch.from_block(s.sample(seeds), arrays["node_feat"][:3],
                                device="cpu")
