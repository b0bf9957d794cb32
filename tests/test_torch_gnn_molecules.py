"""DimeNet and NequIP serving: the port (``repro_torch.models.gnn``)
against the reference on the CPU, at ``smoke()`` width on the
``molecule`` cell of ``GNN_SHAPES_SMOKE`` and once at ``full()`` width on
the full ``molecule`` cell (128 molecules of 30 atoms, 64 edges each).
Parameters come from the reference's ``dimenet_init`` / ``nequip_init``,
every leaf moved off its initial value by seeded noise, carried over by
``*_params_from_reference``. Inputs: the reference's
``random_molecule_batch`` (two seeds) and a steps-style random molecular
batch (``launch/steps.py``'s draws) with self-loops masked, padded edges
into node 0, padded atoms and an atom whose every in-edge is masked;
triplets from the reference's ``build_triplets`` with the cells' cap 2E.
The reference runs under ``jax.jit``.

Tolerances: DimeNet in float32, NequIP energies and forces: rtol/atol
1e-4 (the largest error measured is 1.0% of it for DimeNet and 6.7% for
NequIP, both at full width). DimeNet with ``msg_dtype=bfloat16``:
rtol/atol 3e-2; the largest error measured is 7% of it at smoke width
and 43% at full width, where the moved weights give energies of order
1e3 (an absolute error of 109). That tolerance alone would pass a
float32 computation, so the bfloat16 path is also held to its dtypes
(each block's MLP inputs and outputs and its triplet sum in bfloat16)
and, at smoke width, to lying nearer the reference's bfloat16 output
than the port's float32 one. The port's own rotation test holds
NequIP to ``tests/test_models.py``'s tolerances: energy rtol/atol 1e-4,
rotated forces rtol 1e-3 / atol 1e-4."""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as ref_configs  # noqa: E402
from repro.configs.common import GNN_SHAPES, GNN_SHAPES_SMOKE  # noqa: E402
from repro.data.graphs import random_molecule_batch as ref_molecules  # noqa: E402
from repro.models import gnn as J  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.data.graphs import random_molecule_batch  # noqa: E402
from repro_torch.models import gnn as T  # noqa: E402

from test_torch_gnn_models import (  # noqa: E402
    _cell_shapes,
    batch_arrays,
    jitter,
    port_batch,
    ref_batch,
    steps_batch,
)

TOL = dict(rtol=1e-4, atol=1e-4)
BF16_TOL = dict(rtol=3e-2, atol=3e-2)
SMOKE = {c.name: c for c in GNN_SHAPES_SMOKE}["molecule"].params
FULL = {c.name: c for c in GNN_SHAPES}["molecule"].params


def _molecules(cell, seed):
    b = ref_molecules(n_mols=cell["batch"], n_atoms=cell["n_nodes"],
                      n_edges=cell["n_edges"], seed=seed)
    return batch_arrays(b), b.n_graphs


def _case(case):
    if case == "steps":
        n, e, f, g = _cell_shapes({c.name: c for c in GNN_SHAPES_SMOKE}[
            "molecule"])
        arrays, g = steps_batch(n, e, f, g, seed=5, molecular=True)
    elif case == "full":
        arrays, g = _molecules(FULL, 0)
    else:
        arrays, g = _molecules(SMOKE, int(case[-1]))
    e = arrays["senders"].shape[0]
    tri = J.build_triplets(arrays["senders"], arrays["receivers"],
                           arrays["edge_mask"], 2 * e)
    return arrays, g, tri


CASES = ["seed0", "seed1", "steps"]


@pytest.fixture(scope="module")
def inputs():
    return {case: _case(case) for case in CASES + ["full"]}


def _config(arch, size, **kw):
    jc = dataclasses.replace(getattr(ref_configs.get_arch(arch), size)(),
                             **kw)
    dtypes = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}
    tkw = {k: dtypes.get(v, v) for k, v in kw.items()}
    tc = dataclasses.replace(getattr(configs.get_arch(arch), size)(), **tkw)
    return jc, tc


@pytest.fixture(scope="module")
def dimenet_ref():
    """Jitted reference DimeNet forwards, one per (size, msg_dtype)."""
    cache = {}

    def get(size, dt):
        if (size, dt) not in cache:
            jc, tc = _config("dimenet", size, msg_dtype=dt)
            params = jitter(J.dimenet_init(jc, jax.random.PRNGKey(0)), 0)
            fwd = jax.jit(lambda p, b, *t: J.dimenet_forward(jc, p, b, *t))
            model = T.dimenet_params_from_reference(params, tc, device="cpu")
            cache[size, dt] = (params, fwd, model)
        return cache[size, dt]
    return get


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES + ["full"])
def test_dimenet_matches_reference(case, dt, inputs, dimenet_ref):
    arrays, g, tri = inputs[case]
    size = "full" if case == "full" else "smoke"
    params, fwd, model = dimenet_ref(size, getattr(jnp, dt))
    want = np.asarray(fwd(params, ref_batch(arrays, g),
                          *map(jnp.asarray, tri))).astype(np.float32)
    batch = port_batch(arrays, g)
    trip = T.triplet_tensors(tri, device="cpu")
    with torch.no_grad():
        got = model(batch, *trip)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want,
                               **(TOL if dt == "float32" else BF16_TOL))
    assert torch.equal(T.dimenet_forward(model.cfg, model, batch, *trip),
                       got)


@pytest.mark.parametrize("case", CASES)
def test_dimenet_bfloat16_runs_its_blocks_in_bfloat16(case, inputs,
                                                      dimenet_ref,
                                                      monkeypatch):
    """Under ``msg_dtype=bfloat16`` every block's MLPs take and give
    bfloat16 and its triplet sum adds bfloat16; only the edge-to-atom and
    graph sums add float32. The output is nearer the reference's bfloat16
    output than the port's own float32 output on the same weights (at
    smoke width, measured 0.48-0.58 of it)."""
    arrays, g, tri = inputs[case]
    params, fwd, model = dimenet_ref("smoke", jnp.bfloat16)
    want = np.asarray(fwd(params, ref_batch(arrays, g),
                          *map(jnp.asarray, tri))).astype(np.float32)
    batch = port_batch(arrays, g)
    trip = T.triplet_tensors(tri, device="cpu")
    seen = []
    mlp, seg = T._mlp_apply, T._seg_sum

    def mlp_seen(p, x, *a, dtype=None, **kw):
        y = mlp(p, x, *a, dtype=dtype, **kw)
        seen.append(("mlp", dtype, x.dtype, y.dtype))
        return y

    def seg_seen(x, ids, n):
        seen.append(("seg", x.dtype))
        return seg(x, ids, n)

    monkeypatch.setattr(T, "_mlp_apply", mlp_seen)
    monkeypatch.setattr(T, "_seg_sum", seg_seen)
    with torch.no_grad():
        got = model(batch, *trip)
    monkeypatch.undo()
    bf16, f32 = torch.bfloat16, torch.float32
    n_blocks = model.cfg.n_blocks
    cast = [c for c in seen if c[0] == "mlp" and c[1] is not None]
    assert cast == [("mlp", bf16, bf16, bf16)] * (4 * n_blocks)
    assert [c for c in seen if c[0] == "seg"] == (
        [("seg", bf16)] * n_blocks + [("seg", f32)] * 2)
    as32 = T.dimenet_params_from_reference(
        params, dataclasses.replace(model.cfg, msg_dtype=f32), device="cpu")
    with torch.no_grad():
        got32 = as32(batch, *trip)
    to_ref = float((got - torch.from_numpy(want)).abs().max())
    to_f32 = float((got - got32).abs().max())
    assert to_ref < 0.75 * to_f32, (to_ref, to_f32)


@pytest.fixture(scope="module")
def nequip_ref():
    cache = {}

    def get(size):
        if size not in cache:
            jc, tc = _config("nequip", size)
            params = jitter(J.nequip_init(jc, jax.random.PRNGKey(0)), 1)
            fwd = jax.jit(lambda p, b: J.nequip_energy_forces(jc, p, b))
            model = T.nequip_params_from_reference(params, tc, device="cpu")
            cache[size] = (params, fwd, model)
        return cache[size]
    return get


@pytest.mark.parametrize("case", CASES + ["full"])
def test_nequip_energy_and_forces_match_reference(case, inputs, nequip_ref):
    arrays, g, _ = inputs[case]
    params, fwd, model = nequip_ref("full" if case == "full" else "smoke")
    e_want, f_want = map(np.asarray, fwd(params, ref_batch(arrays, g)))
    batch = port_batch(arrays, g)
    with torch.no_grad():  # the forces switch autograd back on
        e_got, f_got = model.energy_forces(batch)
        e_fwd = model(batch)
    assert not e_got.requires_grad and not f_got.requires_grad
    assert tuple(e_got.shape) == e_want.shape
    assert tuple(f_got.shape) == f_want.shape == tuple(batch.positions.shape)
    np.testing.assert_allclose(e_got.numpy(), e_want, **TOL)
    np.testing.assert_allclose(f_got.numpy(), f_want, **TOL)
    assert torch.equal(e_fwd, e_got)
    # the positions are not left requiring grad; padded atoms (no edge)
    # get no force
    assert not batch.positions.requires_grad
    assert torch.equal(f_got[~batch.node_mask],
                       torch.zeros_like(f_got[~batch.node_mask]))


def _random_rotation(seed=0):
    """``tests/test_models.py``'s rotation."""
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(3, 3))
    q, r = np.linalg.qr(a)
    q = q * np.sign(np.diag(r))
    if np.linalg.det(q) < 0:
        q[:, 0] = -q[:, 0]
    return q


@pytest.mark.parametrize("seed", [3, 4])
def test_nequip_rotation_equivariance_on_the_port(seed):
    """Energy invariant and forces equivariant under a random rotation."""
    cfg = T.NequIPConfig(n_layers=2, d_hidden=8, n_rbf=4)
    model = T.nequip_init(cfg, torch.Generator().manual_seed(0),
                          device="cpu")
    batch = random_molecule_batch(n_mols=2, n_atoms=6, n_edges=16, seed=1,
                                  device="cpu")
    e0, f0 = model.energy_forces(batch)
    R = torch.from_numpy(_random_rotation(seed)).to(torch.float32)
    rot = dataclasses.replace(batch, positions=batch.positions @ R.T)
    e1, f1 = model.energy_forces(rot)
    np.testing.assert_allclose(e0.numpy(), e1.numpy(), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose((f0 @ R.T).numpy(), f1.numpy(), rtol=1e-3,
                               atol=1e-4)
    assert float(f0.abs().max()) > 1e-3  # the forces are not all zero


@pytest.mark.parametrize("arch", ["dimenet", "nequip"])
def test_init_law_and_carry_over_names(arch):
    cfg = configs.get_arch(arch).smoke()
    init = T.dimenet_init if arch == "dimenet" else T.nequip_init
    a = init(cfg, torch.Generator().manual_seed(1), device="cpu")
    b = init(cfg, torch.Generator().manual_seed(1), device="cpu")
    pa = dict(a.named_parameters())
    for k, v in b.named_parameters():
        assert torch.equal(pa[k], v) and not v.requires_grad
    emb = pa["species_embed"]
    d = emb.shape[1]
    assert abs(float(emb.std() * np.sqrt(d)) - 1.0) < 0.2
    if arch == "dimenet":
        bil = pa["blocks.0.bilinear"]
        assert abs(float(bil.std() * d) - 1.0) < 0.2
    assert all(float(p.abs().max()) == 0.0 for k, p in pa.items()
               if k.endswith(".b"))
    jc = ref_configs.get_arch(arch).smoke()
    ref = (J.dimenet_init if arch == "dimenet" else J.nequip_init)(
        jc, jax.random.PRNGKey(0))
    leaves = jax.tree_util.tree_leaves_with_path(ref)
    assert len(leaves) == len(pa)
    for path, leaf in leaves:
        name = ".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                        for k in path)
        assert tuple(pa[name].shape) == tuple(leaf.shape), name


def test_nequip_full_depth_rotation_matches_reference(inputs, nequip_ref):
    """From 3 layers on, the reference's 2x2->2 path (``gnn.py:611-616``)
    feeds the trace of ``m2 y2 + y2 m2`` into the l=2 channel
    (``_mat_to_vec5`` reads ``1.5 * m[2, 2]``), so a rotation moves the
    energy. The port keeps the reference's semantics: on the rotated
    batch its energies and forces equal the reference's, and both move."""
    arrays, g, _ = inputs["full"]
    params, fwd, model = nequip_ref("full")
    rot = dict(arrays, positions=(arrays["positions"] @ _random_rotation(3).T)
               .astype(np.float32))
    e0, _ = map(np.asarray, fwd(params, ref_batch(arrays, g)))
    e_want, f_want = map(np.asarray, fwd(params, ref_batch(rot, g)))
    e_got, f_got = model.energy_forces(port_batch(rot, g))
    np.testing.assert_allclose(e_got.numpy(), e_want, **TOL)
    np.testing.assert_allclose(f_got.numpy(), f_want, **TOL)
    assert np.abs(e_want - e0).max() > 1e-3
