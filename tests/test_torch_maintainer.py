"""The port's unified CoreMaintainer (src/repro_torch/core/api.py) against
the reference's, batch by batch, bit for bit: cores, k-order labels, the
slot table, the live edge count and all 12 BatchStats fields, with the
cores also held to the BZ oracle. Plus checkpoints across the two
packages, the device peel init, and the API's errors."""
import warnings

import numpy as np
import pytest
import torch

pytest.importorskip("jax", reason="the reference package runs on jax")
from repro.core.api import CoreMaintainer as JaxMaintainer
from repro.core.decomposition import peel_decomposition as jax_peel
from repro.core.oracle import bz_from_csr
from repro.graph.csr import build_csr as jax_build_csr
from repro.graph.generators import erdos_renyi
from repro.graph.stream import churn_stream, mixed_stream
from repro_torch.core.api import CoreMaintainer
from repro_torch.graph.csr import build_csr

N, M = 300, 1200


def _port_graph(g):
    return build_csr(g.n, g.edge_array())


def _assert_same(jm, tm, js=None, ts=None, where=""):
    np.testing.assert_array_equal(tm.cores(), jm.cores(), err_msg=where)
    np.testing.assert_array_equal(tm.labels(), jm.labels(), err_msg=where)
    for name in ("src", "dst", "valid"):
        np.testing.assert_array_equal(
            getattr(tm, name).numpy(), np.asarray(getattr(jm, name)),
            err_msg=f"{where} {name}")
    assert int(tm.n_edges) == int(jm.n_edges), where
    assert tm.capacity == jm.capacity, where
    if js is not None:
        assert ts._fields == js._fields
        for f in js._fields:
            assert int(getattr(ts, f)) == int(getattr(js, f)), f"{where} {f}"


def _live_csr(m):
    e = np.stack([np.asarray(m.src), np.asarray(m.dst)], 1)
    return jax_build_csr(m.n, e[np.asarray(m.valid)])


def _replay(stream, jm, tm):
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="Some donated buffers")
        for ev in stream:
            js = jm.apply_batch(insert_edges=ev.edges,
                                remove_edges=ev.removals)
            ts = tm.apply_batch(insert_edges=ev.edges,
                                remove_edges=ev.removals)
            _assert_same(jm, tm, js, ts, where=f"t={ev.t}")
            np.testing.assert_array_equal(tm.cores(), bz_from_csr(_live_csr(jm)))


STREAMS = {
    "mixed": lambda g: mixed_stream(g, 8, 64, seed=5),
    "churn": lambda g: churn_stream(g, 8, 64, same_batch_roundtrip=True,
                                    dirty=True, seed=6),
}


@pytest.mark.parametrize("tight", [False, True], ids=["roomy", "grows"])
@pytest.mark.parametrize("stream", sorted(STREAMS))
def test_stream_replay_matches_reference(stream, tight):
    """``grows`` starts with headroom for 20 edges, less than one batch,
    so both packages take the defrag-and-grow path."""
    g = erdos_renyi(N, M, seed=1)
    capacity = g.m + 20 if tight else None
    jm = JaxMaintainer.from_graph(g, capacity=capacity)
    tm = CoreMaintainer.from_graph(_port_graph(g), capacity=capacity,
                                   device="cpu")
    _assert_same(jm, tm)
    _replay(STREAMS[stream](g), jm, tm)
    if tight:
        assert tm.capacity > capacity  # the table was regrown


def test_churn_replay_through_the_cuda_dispatch_path():
    """``kernel_backend="cuda"`` (the fused removal round, the fused
    promotion check, the din/same_in stats) against the reference's
    ``"pallas"``; on the CPU the kernel wrappers run their plain
    versions, so this holds the fused control flow to the reference."""
    g = erdos_renyi(N, M, seed=2)
    jm = JaxMaintainer.from_graph(g, kernel_backend="pallas")
    tm = CoreMaintainer.from_graph(_port_graph(g), device="cpu")
    tm.kernel_backend = "cuda"  # the CPU constructor refuses it
    _replay(churn_stream(g, 5, 48, seed=7), jm, tm)


def test_from_state_mid_stream_then_continue():
    g = erdos_renyi(N, M, seed=3)
    events = list(churn_stream(g, 8, 48, seed=8))
    jm = JaxMaintainer.from_graph(g)
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="Some donated buffers")
        for ev in events[:4]:
            jm.apply_batch(insert_edges=ev.edges, remove_edges=ev.removals)
        state = dict(n=jm.n, capacity=jm.capacity, src=np.asarray(jm.src),
                     dst=np.asarray(jm.dst), valid=np.asarray(jm.valid),
                     n_edges=np.asarray(jm.n_edges), core=jm.cores(),
                     label=jm.labels())
        tm = CoreMaintainer.from_state(state, device="cpu")
        _assert_same(jm, tm)
        # the planning bounds restart exact, as the reference's load does
        live = np.nonzero(state["valid"])[0]
        assert (tm.live_ub, tm.hwm_ub) == (live.size, live[-1] + 1)
        _replay(events[4:], jm, tm)


def test_checkpoints_load_in_both_directions(tmp_path):
    g = erdos_renyi(N, M, seed=4)
    events = list(mixed_stream(g, 6, 40, seed=9))
    jm = JaxMaintainer.from_graph(g)
    tm = CoreMaintainer.from_graph(_port_graph(g), device="cpu")
    _replay(events[:3], jm, tm)
    tm.save(tmp_path / "port.npz")
    jm.save(tmp_path / "ref.npz")
    with np.load(tmp_path / "port.npz") as a, np.load(tmp_path / "ref.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    jm2 = JaxMaintainer.load(str(tmp_path / "port.npz"))
    tm2 = CoreMaintainer.load(tmp_path / "ref.npz", device="cpu")
    _assert_same(jm2, tm2)
    _replay(events[3:], jm2, tm2)


def test_jax_peel_init_matches_reference():
    g = erdos_renyi(N, M, seed=5)
    tm = CoreMaintainer.from_graph(_port_graph(g), init="jax-peel",
                                   device="cpu")
    jm = JaxMaintainer.from_graph(g, init="jax-peel")
    _assert_same(jm, tm)
    core, rank = jax_peel(jm.src, jm.dst, jm.valid, g.n)
    np.testing.assert_array_equal(tm.cores(), np.asarray(core))
    np.testing.assert_array_equal(tm.labels(),
                                  np.asarray(rank).astype(np.int64) << 20)
    np.testing.assert_array_equal(tm.cores(), bz_from_csr(g))


def test_queries_match_reference():
    g = erdos_renyi(80, 300, seed=6)
    jm = JaxMaintainer.from_graph(g)
    tm = CoreMaintainer.from_graph(_port_graph(g), device="cpu")
    ev = next(churn_stream(g, 1, 40, seed=10))
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="Some donated buffers")
        ji = jm.insert_edges(ev.edges)
        jr = jm.remove_edges(ev.removals)
    ti = tm.insert_edges(ev.edges)
    tr = tm.remove_edges(ev.removals)
    for a, b in ((ji, ti), (jr, tr)):
        assert [int(x) for x in a] == [int(x) for x in b]
    assert tm.edge_slot == jm.edge_slot
    assert tm.live_edges == jm.live_edges
    for u, v in [(0, 1), (5, 9), (10, 3), (7, 7)]:
        assert tm.order_lt(u, v) == jm.order_lt(u, v)


@pytest.mark.parametrize("validate", [True, False])
def test_out_of_range_endpoints(validate):
    g = erdos_renyi(50, 150, seed=7)
    jm = JaxMaintainer.from_graph(g, validate=validate)
    tm = CoreMaintainer.from_graph(_port_graph(g), validate=validate,
                                   device="cpu")
    bad = np.array([[1, 2], [3, 50], [-1, 4]])
    if validate:
        for m in (jm, tm):
            with pytest.raises(ValueError, match="out of range"):
                m.apply_batch(insert_edges=bad)
            with pytest.raises(ValueError, match="out of range"):
                m.apply_batch(remove_edges=bad)
        _assert_same(jm, tm)
    else:
        with warnings.catch_warnings():
            warnings.filterwarnings("ignore", message="Some donated buffers")
            js = jm.apply_batch(insert_edges=bad, remove_edges=bad[1:])
        ts = tm.apply_batch(insert_edges=bad, remove_edges=bad[1:])
        _assert_same(jm, tm, js, ts)


def test_empty_batch_stats():
    g = erdos_renyi(50, 150, seed=8)
    jm = JaxMaintainer.from_graph(g)
    tm = CoreMaintainer.from_graph(_port_graph(g), device="cpu")
    _assert_same(jm, tm, jm.apply_batch(), tm.apply_batch())


@pytest.mark.parametrize("kw,ref_kw,exc,match", [
    (dict(engine="host", kernel_backend="cuda"),
     dict(engine="host", kernel_backend="pallas"), ValueError,
     "needs a device engine"),
    (dict(engine="host", weighted=True), dict(engine="host", weighted=True),
     ValueError, "needs a device engine"),
], ids=["host-cuda", "host-weighted"])
def test_unported_configurations_raise(kw, ref_kw, exc, match):
    """The host engine refuses the kernel backend and weighted coreness
    with ValueError, as the reference does, and before any device check,
    so the message is the same on the CPU. (The sharded engine runs:
    tests/test_torch_sharded_*.py.)"""
    g = build_csr(10, np.array([[0, 1], [1, 2]]))
    with pytest.raises(exc, match=match):
        CoreMaintainer.from_graph(g, device="cpu", **kw)
    if ref_kw is not None:
        with pytest.raises(exc, match=match):
            JaxMaintainer.from_graph(jax_build_csr(10, np.array([[0, 1]])),
                                     **ref_kw)


def test_insert_weights_raise():
    """``insert_weights`` on an unweighted maintainer raises ValueError,
    as in the reference, and leaves the state untouched."""
    g = build_csr(10, np.array([[0, 1]]))
    jm = JaxMaintainer.from_graph(g)
    tm = CoreMaintainer.from_graph(g, device="cpu")
    for m in (jm, tm):
        with pytest.raises(ValueError, match="weighted=True"):
            m.apply_batch(insert_edges=[[2, 3]], insert_weights=[4])
    assert tm.live_edges == 1 and torch.equal(tm.core, torch.tensor(
        [1, 1, 0, 0, 0, 0, 0, 0, 0, 0], dtype=torch.int32))
