"""The port's applications of maintained cores
(src/repro_torch/core/applications.py), the graph_ops statistics that
no engine path calls (``count_gt``, ``count_same_level_after``,
``count_same_level_before_in``, ``expand_forward``), ``COOEdges`` /
``coo_from_csr`` and ``maintainer_from_edges``, each equal to the
reference's exactly (tolerance 0)."""
import warnings

import numpy as np
import pytest
import torch

pytest.importorskip("jax", reason="the reference package runs on jax")
import jax.numpy as jnp  # noqa: E402
from repro.core import applications as jax_apps
from repro.core import graph_ops as JG
from repro.core.api import CoreMaintainer as JaxMaintainer
from repro.core.api import maintainer_from_edges as jax_from_edges
from repro.graph.csr import coo_from_csr as jax_coo_from_csr
from repro.graph.generators import erdos_renyi
from repro.graph.stream import mixed_stream
from repro_torch.core import applications as apps
from repro_torch.core import graph_ops as G
from repro_torch.core.api import CoreMaintainer, maintainer_from_edges
from repro_torch.graph import COOEdges, coo_from_csr
from repro_torch.graph.csr import build_csr


@pytest.fixture(scope="module", params=["unified", "host"])
def maintained(request):
    """Both packages' maintainers after the same mixed stream."""
    g = erdos_renyi(300, 1500, seed=0)
    jm = JaxMaintainer.from_graph(g, capacity=8192, engine=request.param)
    tm = CoreMaintainer.from_graph(build_csr(g.n, g.edge_array()),
                                   capacity=8192, engine=request.param,
                                   device="cpu")
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="Some donated buffers")
        for ev in mixed_stream(g, 4, 80, seed=3):
            jm.apply_batch(insert_edges=ev.edges, remove_edges=ev.removals)
            tm.apply_batch(insert_edges=ev.edges, remove_edges=ev.removals)
    np.testing.assert_array_equal(tm.cores(), jm.cores())
    return jm, tm


def test_kcore_edge_mask_and_subgraph(maintained):
    jm, tm = maintained
    kmax = int(tm.cores().max())
    for k in (0, 2, 3, kmax, kmax + 1):
        got = apps.kcore_edge_mask(tm, k)
        assert got.dtype == torch.bool and got.device == tm.device
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jax_apps.kcore_edge_mask(jm, k)))
        (jn, je), (tn, te) = (jax_apps.kcore_subgraph(jm, k),
                              apps.kcore_subgraph(tm, k))
        for want, have in ((jn, tn), (je, te)):
            assert have.dtype == want.dtype and have.shape == want.shape
            np.testing.assert_array_equal(have, want)


@pytest.mark.parametrize("alpha", [1.0, 0.5, 2.0])
def test_core_sampling_weights(maintained, alpha):
    jm, tm = maintained
    want = jax_apps.core_sampling_weights(jm, alpha)
    got = apps.core_sampling_weights(tm, alpha)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("top_frac", [0.001, 0.05, 0.5, 1.0])
def test_densest_region_vertices(maintained, top_frac):
    jm, tm = maintained
    want = jax_apps.densest_region_vertices(jm, top_frac)
    got = apps.densest_region_vertices(tm, top_frac)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def _random_state(seed: int, n: int = 60, cap: int = 400):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, cap).astype(np.int32)
    dst = rng.integers(0, n, cap).astype(np.int32)
    valid = rng.random(cap) < 0.8
    core = rng.integers(0, 4, n).astype(np.int32)  # many ties
    label = rng.integers(-5, 5, n).astype(np.int64) << 20  # and label ties
    mask = rng.random(n) < 0.4
    return n, src, dst, valid, core, label, mask


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("fn", ["count_gt", "count_same_level_after",
                                "count_same_level_before_in",
                                "expand_forward"])
def test_unpathed_graph_ops_match_reference(fn, seed):
    n, src, dst, valid, core, label, mask = _random_state(seed)
    args = {"count_gt": (src, dst, valid, core),
            "count_same_level_after": (src, dst, valid, core, label),
            "count_same_level_before_in": (src, dst, valid, core, label,
                                           mask),
            "expand_forward": (src, dst, valid, core, label, mask)}[fn]
    want = np.asarray(getattr(JG, fn)(*map(jnp.asarray, args), n))
    got = getattr(G, fn)(*map(torch.from_numpy, args), n)
    assert got.shape == (n,)
    assert got.dtype == (torch.bool if fn == "expand_forward"
                         else torch.int32)
    assert want.dtype == got.numpy().dtype
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("capacity", [None, 1000])
def test_coo_from_csr_matches_reference(capacity):
    g = erdos_renyi(100, 400, seed=5)
    want = jax_coo_from_csr(g, capacity=capacity)
    got = coo_from_csr(build_csr(g.n, g.edge_array()), capacity=capacity,
                       device="cpu")
    assert isinstance(got, COOEdges)
    assert got.n == want.n and got.capacity == want.capacity
    for name in ("src", "dst", "valid", "n_edges"):
        t, w = getattr(got, name), np.asarray(getattr(want, name))
        assert t.device.type == "cpu"
        assert t.numpy().dtype == w.dtype, name
        np.testing.assert_array_equal(t.numpy(), w, err_msg=name)
    with pytest.raises(ValueError, match="capacity"):
        coo_from_csr(build_csr(g.n, g.edge_array()), capacity=10,
                     device="cpu")


def test_coo_from_csr_defaults_to_the_card():
    g = build_csr(4, np.array([[0, 1], [1, 2]]))
    if torch.cuda.is_available():
        assert coo_from_csr(g).src.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            coo_from_csr(g)


@pytest.mark.parametrize("engine", ["unified", "host"])
def test_maintainer_from_edges_matches_reference(engine):
    rng = np.random.default_rng(8)
    edges = rng.integers(0, 50, (200, 2))  # self-loops and repeats too
    jm = jax_from_edges(50, edges, engine=engine)
    tm = maintainer_from_edges(50, edges, engine=engine, device="cpu")
    assert tm.engine == engine
    np.testing.assert_array_equal(tm.cores(), jm.cores())
    np.testing.assert_array_equal(tm.labels(), jm.labels())
    for name in ("src", "dst", "valid"):
        np.testing.assert_array_equal(getattr(tm, name).numpy(),
                                      np.asarray(getattr(jm, name)))
    assert tm.edge_slot == jm.edge_slot
