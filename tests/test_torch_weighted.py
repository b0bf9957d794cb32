"""Weighted coreness in the port (src/repro_torch/core/weighted.py,
graph_ops.weighted_*, the weighted fixpoints and
``CoreMaintainer(weighted=True)``) against the reference, bit for bit
(tolerance 0: weights, supports and cores are integers): cores, labels,
the weight column, the slot table and all 12 BatchStats fields, batch by
batch, with the cores also held to the weighted peeling oracle."""
import warnings

import numpy as np
import pytest
import torch

pytest.importorskip("jax", reason="the reference package runs on jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import graph_ops as jG
from repro.core import weighted as jW
from repro.core.api import CoreMaintainer as JaxMaintainer
from repro.core.oracle import bz_from_csr
from repro.core.remove import weighted_core_fixpoint_pass as j_wpass
from repro.graph.generators import erdos_renyi
from repro.graph.stream import churn_stream, mixed_stream
from repro_torch.core import graph_ops as tG
from repro_torch.core import weighted as tW
from repro_torch.core.api import CoreMaintainer
from repro_torch.core.remove import weighted_core_fixpoint_pass as t_wpass
from repro_torch.graph.csr import build_csr

N, M = 120, 480


def _port_graph(g):
    return build_csr(g.n, g.edge_array())


def _norm(edges):
    return [(int(min(a, b)), int(max(a, b))) for a, b in np.asarray(edges)]


def _oracle(n, live):
    if not live:
        return np.zeros(n, dtype=np.int64)
    edges = np.asarray(sorted(live), dtype=np.int64)
    weights = np.asarray([live[tuple(e)] for e in edges.tolist()])
    return tW.weighted_core_oracle(n, edges, weights)


def _slot_arrays(n, cap, seed):
    """A slot table with live slots, tombstones and zero padding, int32
    weights 1-5, and cores 0-9."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, cap).astype(np.int32)
    dst = rng.integers(0, n, cap).astype(np.int32)
    valid = rng.random(cap) < 0.8
    valid[cap - cap // 8:] = False
    src[cap - cap // 8:] = 0
    dst[cap - cap // 8:] = 0
    w = rng.integers(1, 6, cap).astype(np.int32)
    core = rng.integers(0, 10, n).astype(np.int32)
    return src, dst, valid, w, core


def _assert_same(jm, tm, js=None, ts=None, where=""):
    np.testing.assert_array_equal(tm.cores(), jm.cores(), err_msg=where)
    np.testing.assert_array_equal(tm.labels(), jm.labels(), err_msg=where)
    for name in ("src", "dst", "valid", "w"):
        np.testing.assert_array_equal(
            getattr(tm, name).numpy(), np.asarray(getattr(jm, name)),
            err_msg=f"{where} {name}")
    assert int(tm.n_edges) == int(jm.n_edges), where
    assert tm.capacity == jm.capacity, where
    if js is not None:
        assert ts._fields == js._fields
        for f in js._fields:
            assert int(getattr(ts, f)) == int(getattr(js, f)), f"{where} {f}"


def _apply_mirror(live, ins, rm, iw):
    """The engine's weight semantics on a host live map: removals first,
    then insertions in order, skipping self-loops, in-batch duplicates
    (the first row's weight sticks) and live edges (the stored weight
    stays); a same-batch remove + insert commits the new weight."""
    for e in _norm(rm):
        live.pop(e, None)
    for e, w in zip(_norm(ins), iw):
        if e[0] != e[1] and e not in live:
            live[e] = int(w)


def _replay(stream, jm, tm, live, seed, max_w=5):
    rng = np.random.default_rng(seed)
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="Some donated buffers")
        for ev in stream:
            iw = rng.integers(1, max_w + 1, len(ev.edges))
            js = jm.apply_batch(insert_edges=ev.edges,
                                remove_edges=ev.removals, insert_weights=iw)
            ts = tm.apply_batch(insert_edges=ev.edges,
                                remove_edges=ev.removals, insert_weights=iw)
            _assert_same(jm, tm, js, ts, where=f"t={ev.t}")
            _apply_mirror(live, ev.edges, ev.removals, iw)
            np.testing.assert_array_equal(tm.cores(), _oracle(tm.n, live))
            wcol = tm.w.numpy()
            for e, slot in tm.edge_slot.items():
                assert int(wcol[slot]) == live[e], e


def _pair(g, seed, capacity=None, max_w=5, **kw):
    w0 = np.random.default_rng(seed).integers(1, max_w + 1, g.m)
    jm = JaxMaintainer.from_graph(g, capacity=capacity, weighted=True,
                                  weights=w0)
    tm = CoreMaintainer.from_graph(_port_graph(g), capacity=capacity,
                                   weighted=True, weights=w0, device="cpu",
                                   **kw)
    live = dict(zip(_norm(g.edge_array()), w0.tolist()))
    return jm, tm, live


# ---------------------------------------------------------------------------
# statistics and fixpoints
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", range(3))
def test_weighted_support_matches_reference(seed):
    n, cap = 60, 256
    src, dst, valid, w, core = _slot_arrays(n, cap, seed)
    thresh = np.random.default_rng(seed + 7).integers(0, 12, n).astype(
        np.int32)
    arrays = (src, dst, valid, w, core, thresh)
    want = jG.weighted_support(*(jnp.asarray(x) for x in arrays), n)
    got = tG.weighted_support(*(torch.from_numpy(x) for x in arrays), n)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("seed", range(3))
def test_weighted_h_index_matches_reference(seed, backend):
    """The lockstep bisection, from an upper bound with negative lanes
    (clamped at 0) and lanes far above any support; ``"cuda"`` runs the
    wsum wrapper, which takes its plain version on CPU tensors."""
    n, cap = 60, 256
    src, dst, valid, w, core = _slot_arrays(n, cap, seed)
    upper = np.random.default_rng(seed + 3).integers(-3, 60, n).astype(
        np.int32)
    arrays = (src, dst, valid, w, core, upper)
    want = jG.weighted_h_index(*(jnp.asarray(x) for x in arrays), n)
    got = tG.weighted_h_index(*(torch.from_numpy(x) for x in arrays), n,
                              backend=backend)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("seed", range(2))
def test_weighted_fixpoint_pass_matches_reference(seed):
    """``(core, rounds, max_frontier)``, from the weighted-degree bound."""
    n, cap = 60, 256
    src, dst, valid, w, _ = _slot_arrays(n, cap, seed)
    deg = np.zeros(n, np.int64)
    np.add.at(deg, src[valid], w[valid])
    np.add.at(deg, dst[valid], w[valid])
    arrays = (src, dst, valid, w, deg.astype(np.int32))
    want = j_wpass(*(jnp.asarray(x) for x in arrays), n)
    got = t_wpass(*(torch.from_numpy(x) for x in arrays), n)
    for g_, w_ in zip(got, want):
        np.testing.assert_array_equal(g_.numpy(), np.asarray(w_))


@pytest.mark.parametrize("seed", range(3))
def test_oracle_and_harness_match_reference(seed):
    g = erdos_renyi(80, 300, seed=seed)
    edges = g.edge_array()
    weights = np.random.default_rng(seed).integers(1, 6, len(edges))
    want = jW.weighted_core_oracle(g.n, edges, weights)
    np.testing.assert_array_equal(
        tW.weighted_core_oracle(g.n, edges, weights), want)
    jm = jW.WeightedCoreMaintainer(g.n, edges, weights, capacity=1024)
    tm = tW.WeightedCoreMaintainer(g.n, edges, weights, capacity=1024,
                                   device="cpu")
    np.testing.assert_array_equal(tm.cores(), jm.cores())
    np.testing.assert_array_equal(tm.cores(), want)
    rng = np.random.default_rng(seed + 100)
    live = {tuple(e) for e in _norm(edges)}
    for step in range(4):
        if step % 2:
            batch = sorted(live)[:: 9][:6]
            jm.remove_edges(np.asarray(batch))
            tm.remove_edges(np.asarray(batch))
            live.difference_update(batch)
        else:
            batch = []
            while len(batch) < 6:
                u, v = (int(x) for x in rng.integers(0, g.n, 2))
                key = (min(u, v), max(u, v))
                if u != v and key not in live and key not in batch:
                    batch.append(key)
            ws = rng.integers(1, 6, len(batch))
            jm.insert_edges(np.asarray(batch), ws)
            tm.insert_edges(np.asarray(batch), ws)
            live.update(batch)
        np.testing.assert_array_equal(tm.cores(), jm.cores())


def test_weighted_fixpoint_matches_reference():
    n, cap = 60, 256
    src, dst, valid, w, _ = _slot_arrays(n, cap, 5)
    upper = np.full(n, 40, np.int32)
    want = jW.weighted_core_fixpoint(*(jnp.asarray(x) for x in (
        src, dst, w, valid, upper)), n)
    got = tW.weighted_core_fixpoint(*(torch.from_numpy(x) for x in (
        src, dst, w, valid, upper)), n)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# CoreMaintainer(weighted=True)
# ---------------------------------------------------------------------------
STREAMS = {
    "mixed": lambda g: mixed_stream(g, 6, 48, seed=5),
    "churn": lambda g: churn_stream(g, 6, 48, same_batch_roundtrip=True,
                                    dirty=True, seed=6),
}


@pytest.mark.parametrize("tight", [False, True], ids=["roomy", "grows"])
@pytest.mark.parametrize("stream", sorted(STREAMS))
def test_weighted_replay_matches_reference(stream, tight):
    """Dirty weighted batches (the churn stream carries in-batch
    duplicates with their own random weights, live re-inserts and a
    same-batch remove + insert); ``grows`` starts with room for 20 edges,
    so both packages defrag and grow with a live weight column."""
    g = erdos_renyi(N, M, seed=11)
    capacity = g.m + 20 if tight else None
    jm, tm, live = _pair(g, seed=1, capacity=capacity)
    _assert_same(jm, tm)
    np.testing.assert_array_equal(tm.cores(), _oracle(g.n, live))
    _replay(STREAMS[stream](g), jm, tm, live, seed=2)
    if tight:
        assert tm.capacity > capacity


def test_weighted_replay_through_the_cuda_dispatch_path():
    """``kernel_backend="cuda"`` (every bisection step through the wsum
    wrapper) against the reference's ``"pallas"``; on the CPU the
    wrapper runs its plain version."""
    g = erdos_renyi(N, M, seed=12)
    w0 = np.random.default_rng(3).integers(1, 6, g.m)
    jm = JaxMaintainer.from_graph(g, weighted=True, weights=w0,
                                  kernel_backend="pallas")
    tm = CoreMaintainer.from_graph(_port_graph(g), weighted=True,
                                   weights=w0, device="cpu")
    tm.kernel_backend = "cuda"  # the CPU constructor refuses it
    live = dict(zip(_norm(g.edge_array()), w0.tolist()))
    _replay(churn_stream(g, 4, 40, seed=7), jm, tm, live, seed=4)


def test_weight_commit_rules():
    """First in-batch duplicate wins, a live re-insert keeps the stored
    weight, and a same-batch remove + insert commits the new weight."""
    e0 = np.asarray([[0, 1], [1, 2], [2, 0], [3, 4]])
    g = build_csr(8, e0)
    w0 = np.asarray([2, 3, 4, 5])
    jm = JaxMaintainer.from_graph(g, capacity=64, weighted=True, weights=w0)
    tm = CoreMaintainer.from_graph(g, capacity=64, weighted=True,
                                   weights=w0, device="cpu")
    live = dict(zip(_norm(g.edge_array()), w0.tolist()))
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="Some donated buffers")
        for ins, rm, iw in (([[4, 5], [4, 5]], None, [6, 9]),
                            ([[0, 1]], None, [9]),
                            ([[1, 2]], [[1, 2]], [7])):
            js = jm.apply_batch(insert_edges=ins, remove_edges=rm,
                                insert_weights=iw)
            ts = tm.apply_batch(insert_edges=ins, remove_edges=rm,
                                insert_weights=iw)
            _assert_same(jm, tm, js, ts)
            _apply_mirror(live, np.asarray(ins), np.asarray(
                rm if rm is not None else np.zeros((0, 2))), iw)
    assert live[(4, 5)] == 6 and live[(0, 1)] == 2 and live[(1, 2)] == 7
    for e, slot in tm.edge_slot.items():
        assert int(tm.w[slot]) == live[e], e
    np.testing.assert_array_equal(tm.cores(), _oracle(8, live))


def test_unit_weights_give_unweighted_cores():
    g = erdos_renyi(N, M, seed=13)
    tm = CoreMaintainer.from_graph(_port_graph(g), weighted=True,
                                   device="cpu")
    assert torch.equal(tm.w[:g.m], torch.ones(g.m, dtype=torch.int32))
    np.testing.assert_array_equal(tm.cores(), bz_from_csr(g))
    un = CoreMaintainer.from_graph(_port_graph(g), device="cpu")
    for ev in mixed_stream(g, 3, 40, seed=8):
        tm.apply_batch(insert_edges=ev.edges, remove_edges=ev.removals)
        un.apply_batch(insert_edges=ev.edges, remove_edges=ev.removals)
        np.testing.assert_array_equal(tm.cores(), un.cores())


def test_validate_false_drops_rows_with_their_weights():
    """The out-of-range rows go with their weights: the kept rows keep
    theirs, lane for lane."""
    g = erdos_renyi(50, 150, seed=14)
    jm, tm, live = _pair(g, seed=5, validate=False)
    jm.validate = False
    bad = np.array([[1, 2], [3, 50], [-1, 4], [5, 6]])
    iw = np.array([2, 3, 4, 5])
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="Some donated buffers")
        js = jm.apply_batch(insert_edges=bad, remove_edges=bad[1:3],
                            insert_weights=iw)
    ts = tm.apply_batch(insert_edges=bad, remove_edges=bad[1:3],
                        insert_weights=iw)
    _assert_same(jm, tm, js, ts)
    _apply_mirror(live, bad[[0, 3]], np.zeros((0, 2)), iw[[0, 3]])
    for e, slot in tm.edge_slot.items():
        assert int(tm.w[slot]) == live[e], e
    np.testing.assert_array_equal(tm.cores(), _oracle(g.n, live))


def test_checkpoints_with_w_load_in_both_directions(tmp_path):
    g = erdos_renyi(N, M, seed=15)
    jm, tm, live = _pair(g, seed=6)
    events = list(churn_stream(g, 4, 40, seed=9))
    _replay(events[:2], jm, tm, live, seed=7)
    tm.save(tmp_path / "port.npz")
    jm.save(str(tmp_path / "ref.npz"))
    with np.load(tmp_path / "port.npz") as a, \
            np.load(tmp_path / "ref.npz") as b:
        assert sorted(a.files) == sorted(b.files) and "w" in a.files
        for k in a.files:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    jm2 = JaxMaintainer.load(str(tmp_path / "port.npz"), weighted=True)
    tm2 = CoreMaintainer.load(tmp_path / "ref.npz", device="cpu",
                              weighted=True)
    _assert_same(jm2, tm2)
    _replay(events[2:], jm2, tm2, dict(live), seed=8)
    # an unweighted load ignores the column; a weighted load of an
    # unweighted checkpoint adopts unit weights
    un = CoreMaintainer.load(tmp_path / "ref.npz", device="cpu")
    assert not un.weighted and un.w is None and "w" not in un.state()
    state = {k: v for k, v in tm.state().items() if k != "w"}
    ones = CoreMaintainer.from_state(state, device="cpu", weighted=True)
    assert torch.equal(ones.w, torch.ones(tm.capacity, dtype=torch.int32))


def test_defrag_and_grow_carry_the_weight_column():
    g = erdos_renyi(N, M, seed=16)
    jm, tm, live = _pair(g, seed=9)
    _replay(churn_stream(g, 2, 40, seed=10), jm, tm, live, seed=11)
    for m in (jm, tm):
        m._defrag_to(m.capacity + 64)
    _assert_same(jm, tm)
    for m in (jm, tm):
        m._grow_to(m.capacity + 100)
    _assert_same(jm, tm)
    assert tm.w.shape == (tm.capacity,) and int(tm.w[-100:].abs().sum()) == 0
    for e, slot in tm.edge_slot.items():
        assert int(tm.w[slot]) == live[e], e
    _replay(churn_stream(g, 2, 40, seed=12), jm, tm, live, seed=13)


def test_weighted_argument_errors_match_reference():
    g = build_csr(10, np.array([[0, 1], [1, 2], [2, 3]]))
    for kw, match in ((dict(weights=[1, 2, 3]), "weighted=True"),
                      (dict(weighted=True, weights=[1, 2]), "length"),
                      (dict(weighted=True, weights=[1, 0, 2]), "positive")):
        with pytest.raises(ValueError, match=match):
            JaxMaintainer.from_graph(g, **kw)
        with pytest.raises(ValueError, match=match):
            CoreMaintainer.from_graph(g, device="cpu", **kw)
    tm = CoreMaintainer.from_graph(g, weighted=True, weights=[1, 2, 3],
                                   device="cpu")
    core0 = tm.core.clone()
    for kw, match in ((dict(insert_edges=[[4, 5]], insert_weights=[1, 2]),
                       "length"),
                      (dict(insert_edges=[[4, 5]], insert_weights=[0]),
                       "positive"),
                      (dict(insert_edges=[[4, 50]], insert_weights=[1]),
                       "out of range")):
        with pytest.raises(ValueError, match=match):
            tm.apply_batch(**kw)
    assert tm.live_edges == 3 and torch.equal(tm.core, core0)
    with pytest.raises(ValueError, match="shape"):
        CoreMaintainer(n=4, capacity=8, src=torch.zeros(8, dtype=torch.int32),
                       dst=torch.zeros(8, dtype=torch.int32),
                       valid=torch.zeros(8, dtype=torch.bool),
                       n_edges=torch.tensor(0, dtype=torch.int32),
                       core=torch.zeros(4, dtype=torch.int32),
                       label=torch.zeros(4, dtype=torch.int64), n_levels=6,
                       weighted=True, w=torch.ones(7, dtype=torch.int32))
