"""The port's sharded engine (``engine="sharded"``,
``vertex_sharding="replicated"``) on a world of ONE gloo rank, in
process, against the reference's in-session sharded engine (one device),
batch by batch at tolerance 0: slot table, ``n_edges``, capacity, cores,
labels and the 12 BatchStats fields, on ``mixed_stream`` and
``churn_stream``, both free-list rankings, unweighted and weighted, with
garnished batches, a remove-and-reinsert batch and ``validate=False``
drops. Plus the collective schedule (one removal round and one promotion
round against the reference's traced ``record_traffic``; one free-list
gather a batch), the dispatch of ``kernel_backend="cuda"`` under a mesh
(kernel a's unit statistics, never the fused decisions b and c),
checkpoints across packages and the configuration errors. The 4-rank
runs are in ``tests/test_torch_sharded_ranks.py``.
"""
import datetime
import types
import warnings

import numpy as np
import pytest
import torch
import torch.distributed as dist

pytest.importorskip("jax", reason="the reference package runs on jax")
import jax  # noqa: E402
from repro.analysis.programs import (trace_promotion_round,  # noqa: E402
                                     trace_removal_round,
                                     trace_weighted_round)
from repro.core.api import CoreMaintainer as JaxMaintainer  # noqa: E402
from repro.core.oracle import bz_from_csr  # noqa: E402
from repro.graph.csr import build_csr as jax_build_csr  # noqa: E402
from repro.graph.generators import erdos_renyi  # noqa: E402
from repro.graph.stream import churn_stream, mixed_stream  # noqa: E402
from repro_torch.core import graph_ops as G  # noqa: E402
from repro_torch.core.api import CoreMaintainer  # noqa: E402
from repro_torch.core.insert import promotion_fixpoint  # noqa: E402
from repro_torch.core.remove import (removal_fixpoint,  # noqa: E402
                                     weighted_core_fixpoint_pass)
from repro_torch.core.sharded import make_sharded_apply  # noqa: E402
from repro_torch.core.vertex_layout import (ReplicatedVertices,  # noqa: E402
                                            make_layout, record_traffic)
from repro_torch.graph.csr import build_csr  # noqa: E402
from repro_torch.kernels import coremaint  # noqa: E402
from repro_torch.launch import mesh as port_mesh  # noqa: E402

N, M, BATCHES, BATCH = 300, 1200, 6, 64
STATS = ("n_inserted", "n_removed", "insert_rounds", "n_promoted", "v_plus",
         "remove_rounds", "n_dropped", "renumbered", "n_recycled",
         "high_water", "max_frontier", "n_overflow")


@pytest.fixture(scope="module")
def mesh(tmp_path_factory):
    """A world of one gloo rank, rendezvous through a FileStore."""
    store = dist.FileStore(str(tmp_path_factory.mktemp("pg") / "store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=30))
    try:
        yield port_mesh.make_edge_mesh()
    finally:
        dist.destroy_process_group()


def _assert_same(jm, tm, js=None, ts=None, where=""):
    np.testing.assert_array_equal(tm.cores(), jm.cores(), err_msg=where)
    np.testing.assert_array_equal(tm.labels(), jm.labels(), err_msg=where)
    state = tm.state()
    for name in ("src", "dst", "valid") + (("w",) if tm.weighted else ()):
        np.testing.assert_array_equal(
            state[name], np.asarray(getattr(jm, name)),
            err_msg=f"{where} {name}")
    assert int(tm.n_edges) == int(jm.n_edges), where
    assert tm.capacity == jm.capacity, where
    if js is not None:
        assert ts._fields == STATS
        for f in STATS:
            assert int(getattr(ts, f)) == int(getattr(js, f)), f"{where} {f}"


def _live_csr(jm):
    e = np.stack([np.asarray(jm.src), np.asarray(jm.dst)], 1)
    return jax_build_csr(jm.n, e[np.asarray(jm.valid)])


def _stream(name, g):
    if name == "mixed":
        return mixed_stream(g, BATCHES, BATCH, seed=5)
    return churn_stream(g, BATCHES, BATCH, same_batch_roundtrip=True,
                        dirty=True, seed=6)


def _pair(mesh, g, **kw):
    jm = JaxMaintainer.from_graph(g, engine="sharded", **kw)
    tm = CoreMaintainer.from_graph(build_csr(g.n, g.edge_array()),
                                   engine="sharded", device="cpu",
                                   mesh=mesh, **kw)
    return jm, tm


def _apply(m, ev, **kw):
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="Some donated buffers")
        return m.apply_batch(insert_edges=ev.edges, remove_edges=ev.removals,
                             **kw)


@pytest.mark.parametrize("freelist", ["interleaved", "hierarchical"])
@pytest.mark.parametrize("tight", [False, True], ids=["roomy", "grows"])
@pytest.mark.parametrize("stream", ["mixed", "churn"])
def test_world_of_one_matches_reference_sharded(mesh, stream, tight,
                                                freelist):
    """``grows`` starts with headroom for 20 edges, less than a batch,
    so both packages defrag and grow."""
    g = erdos_renyi(N, M, seed=1)
    jm, tm = _pair(mesh, g, capacity=g.m + 20 if tight else None,
                   freelist=freelist)
    _assert_same(jm, tm)
    cap0 = tm.capacity
    for ev in _stream(stream, g):
        js, ts = _apply(jm, ev), _apply(tm, ev)
        _assert_same(jm, tm, js, ts, where=f"t={ev.t}")
        np.testing.assert_array_equal(tm.cores(), bz_from_csr(_live_csr(jm)))
    assert tm.live_edges == jm.live_edges
    assert tm.edge_slot == jm.edge_slot
    assert (tm.capacity > cap0) == tight


@pytest.mark.parametrize("freelist", ["interleaved", "hierarchical"])
@pytest.mark.parametrize("stream", ["mixed", "churn"])
def test_weighted_world_of_one_matches_reference(mesh, stream, freelist):
    g = erdos_renyi(N, M, seed=2)
    w0 = np.random.default_rng(7).integers(1, 6, g.m)
    jm, tm = _pair(mesh, g, freelist=freelist, weighted=True, weights=w0)
    _assert_same(jm, tm)
    for ev in _stream(stream, g):
        iw = np.random.default_rng(100 + ev.t).integers(1, 6, len(ev.edges))
        js = _apply(jm, ev, insert_weights=iw)
        ts = _apply(tm, ev, insert_weights=iw)
        _assert_same(jm, tm, js, ts, where=f"t={ev.t}")


def test_garnished_batches_and_drops(mesh):
    """A self-loop, in-batch duplicates, a duplicate of a live edge, a
    remove-and-reinsert batch and ``validate=False`` drops, as the
    reference's sharded engine masks them."""
    g = erdos_renyi(70, 260, seed=3)
    jm, tm = _pair(mesh, g, capacity=int(g.m * 1.5) + 8)
    rng = np.random.default_rng(40)
    edges = g.edge_array()
    for step in range(3):
        rm = edges[rng.choice(edges.shape[0], 6, replace=False)]
        ins = rng.integers(0, 70, size=(6, 2))
        garnish = np.asarray([[3, 3], list(ins[0]), list(ins[0][::-1]),
                              list(edges[0])])
        batch = np.concatenate([ins, garnish])
        js = jm.apply_batch(insert_edges=batch, remove_edges=rm)
        ts = tm.apply_batch(insert_edges=batch, remove_edges=rm)
        _assert_same(jm, tm, js, ts, where=f"garnish {step}")
    e = np.asarray(sorted(tm.edge_slot))[:4]
    js = jm.apply_batch(insert_edges=e, remove_edges=e)
    ts = tm.apply_batch(insert_edges=e, remove_edges=e)
    assert int(ts.n_removed) == int(ts.n_inserted) == 4
    _assert_same(jm, tm, js, ts, where="remove and reinsert")
    for m in (jm, tm):
        m.validate = False
    bad = np.asarray([[5, 9999], [-1, 3], [2, 40]])
    js = jm.apply_batch(insert_edges=bad, remove_edges=bad[:2])
    ts = tm.apply_batch(insert_edges=bad, remove_edges=bad[:2])
    assert int(ts.n_inserted) == int(js.n_inserted)
    _assert_same(jm, tm, js, ts, where="validate=False")


@pytest.mark.parametrize("direction", ["port-to-ref", "ref-to-port"])
def test_checkpoints_across_packages_and_engines(mesh, tmp_path, direction):
    g = erdos_renyi(60, 200, seed=4)
    jm, tm = _pair(mesh, g)
    ev = next(mixed_stream(g, 1, 30, seed=2))
    _apply(jm, ev)
    _apply(tm, ev)
    path = str(tmp_path / "ckpt.npz")
    (tm if direction == "port-to-ref" else jm).save(path)
    j2 = JaxMaintainer.load(path, engine="unified")
    t2 = CoreMaintainer.load(path, device="cpu", engine="sharded", mesh=mesh,
                             freelist="hierarchical")
    ins = np.asarray([[0, 7], [3, 11], [5, 50]])
    for m in (jm, tm, j2, t2):
        m.apply_batch(insert_edges=ins)
    _assert_same(jm, tm)
    _assert_same(j2, t2)


def _state(n, cap):
    """The reference tracers' inputs: no live slot, every core 0."""
    z = torch.zeros(cap, dtype=torch.int32)
    return (z, torch.ones(cap, dtype=torch.int32),
            torch.zeros(cap, dtype=torch.bool),
            torch.zeros(n, dtype=torch.int32),
            torch.zeros(n, dtype=torch.int64))


def _ops(log):
    return [(t.op, t.recv_bytes) for t in log]


def test_removal_round_traffic_matches_reference(mesh):
    """One removal round issues the reference's traced collectives: the
    [n, 3] int32 psum of the packed (mcd, hi, dout)."""
    n, cap = 24, 32
    want, _ = trace_removal_round("replicated", n, cap,
                                  jax.make_mesh((1,), ("data",)))
    layout = ReplicatedVertices(n, mesh.get_group("data"))
    src, dst, valid, core, label = _state(n, cap)
    with record_traffic() as log:
        out = removal_fixpoint(src, dst, valid, core, label, n, n + 2,
                               layout=layout)
    assert int(out[2]) == 1  # one round
    assert _ops(log) == _ops(want) == [("psum", n * 3 * 4)]


def test_promotion_round_traffic_matches_reference(mesh):
    """One promotion round: the forward wave's din, the eviction's
    same-level count and the next round's (hi, dout) — three psums, as
    the reference traces them."""
    n, cap, lanes = 24, 32, 8
    want, _ = trace_promotion_round("replicated", n, cap,
                                    jax.make_mesh((1,), ("data",)),
                                    lanes=lanes)
    layout = ReplicatedVertices(n, mesh.get_group("data"))
    src, dst, valid, core, label = _state(n, cap)
    nu = torch.zeros(lanes, dtype=torch.int32)
    nv = torch.ones(lanes, dtype=torch.int32)
    nok = torch.zeros(lanes, dtype=torch.bool)
    hi = torch.zeros(n, dtype=torch.int32)
    with record_traffic() as log:
        out = promotion_fixpoint(src, dst, valid, core, label, nu, nv, nok,
                                 hi, hi.clone(), n, n + 2, layout=layout)
    assert int(out[2]) == 1
    assert _ops(log) == _ops(want) == [("psum", n * 4), ("psum", n * 4),
                                       ("psum", n * 8)]


def test_weighted_round_traffic_matches_reference(mesh):
    """The weighted fixpoint completes one [n] support psum a bisection
    step (the reference's traced loop body holds exactly one)."""
    n, cap = 24, 32
    want, _ = trace_weighted_round(n, cap, jax.make_mesh((1,), ("data",)))
    layout = ReplicatedVertices(n, mesh.get_group("data"))
    src = torch.tensor([0, 1, 2, 0], dtype=torch.int32)
    dst = torch.tensor([1, 2, 0, 3], dtype=torch.int32)
    valid = torch.ones(4, dtype=torch.bool)
    w = torch.tensor([3, 1, 2, 5], dtype=torch.int32)
    upper = torch.full((n,), 6, dtype=torch.int32)
    with record_traffic() as log:
        core, rounds, _ = weighted_core_fixpoint_pass(src, dst, valid, w,
                                                      upper, n, layout)
    assert _ops(want) == [("psum", n * 4)]
    assert log and set(_ops(log)) == set(_ops(want))
    plain, _, _ = weighted_core_fixpoint_pass(src, dst, valid, w, upper, n)
    assert torch.equal(core, plain)


@pytest.mark.parametrize("freelist,shape", [("interleaved", "window"),
                                            ("hierarchical", "scalar")])
def test_one_freelist_gather_a_batch(mesh, freelist, shape):
    """A batch gathers the free-list once: the windowed dead mask
    ([world, window] bytes) or one int32 free count ([world])."""
    g = erdos_renyi(60, 200, seed=5)
    tm = CoreMaintainer.from_graph(build_csr(g.n, g.edge_array()),
                                   engine="sharded", device="cpu",
                                   mesh=mesh, freelist=freelist)
    ev = next(mixed_stream(g, 1, 16, seed=1))
    window = tm._window(len(ev.edges))
    with record_traffic() as log:
        tm.apply_batch(insert_edges=ev.edges, remove_edges=ev.removals)
    gathers = [t for t in log if t.op == "gather_freelist"]
    assert len(gathers) == 1
    assert gathers[0].recv_bytes == (window if shape == "window" else 4)
    # the table collectives: n_removed, the membership verdict,
    # n_recycled and the high-water pmax
    assert [t.op for t in log if t.op != "psum"] == [
        "psum_table", "psum_table", "gather_freelist", "psum_table",
        "pmax_scalar"]


def test_cuda_backend_under_a_mesh_runs_unit_stats_not_fused(mesh,
                                                             monkeypatch):
    """Under a mesh axis ``kernel_backend="cuda"`` routes every local
    partial through ``coo_stat`` (kernel a: mcd_hi_dout, hi_dout, din,
    same_in; its CPU path here) and never a fused decision (b, c), and
    gives the torch backend's result."""
    calls = []
    real = coremaint.coo_stat

    def spy(*a, stat="mcd_hi_dout", **kw):
        calls.append(stat)
        return real(*a, stat=stat, **kw)

    def refuse(*a, **kw):
        raise AssertionError("a fused decision ran before completion")

    g = erdos_renyi(N, M, seed=6)
    base = CoreMaintainer.from_graph(build_csr(g.n, g.edge_array()),
                                     device="cpu")
    ev = next(mixed_stream(g, 1, 64, seed=3))
    lanes = []
    for e in (ev.edges, ev.removals):
        lanes += [torch.from_numpy(e[:, 0].astype(np.int32)),
                  torch.from_numpy(e[:, 1].astype(np.int32)),
                  torch.ones(len(e), dtype=torch.bool)]
    out = {}
    for backend in ("torch", "cuda"):
        if backend == "cuda":
            monkeypatch.setattr(coremaint, "coo_stat", spy)
            monkeypatch.setattr(coremaint, "fused_removal_round", refuse)
            monkeypatch.setattr(coremaint, "fused_promotion_stats", refuse)
        fn = make_sharded_apply(mesh, base.n, base.n_levels,
                                local_active=base._window(64),
                                kernel_backend=backend)
        state = [base.src.clone(), base.dst.clone(), base.valid.clone(),
                 base.core, base.label, base.n_edges]
        out[backend] = fn(*state, *lanes)
    for a, b in zip(out["torch"][:6], out["cuda"][:6]):
        assert torch.equal(a, b)
    assert [int(x) for x in out["torch"][6]] == [int(x)
                                                 for x in out["cuda"][6]]
    assert {"mcd_hi_dout", "hi_dout", "din", "same_in"} <= set(calls)


def test_configuration_errors(mesh, monkeypatch):
    g = build_csr(10, np.array([[0, 1], [1, 2]]))
    for kw, exc, match in [
            (dict(engine="unified", vertex_sharding="range"),
             ValueError, "engine='sharded'"),
            (dict(engine="sharded", vertex_sharding="halo", mesh=mesh),
             ValueError, "2-axis"),
            (dict(engine="sharded", vertex_sharding="range",
                  mesh_shape=(1, 1)), ValueError, "mesh_shape"),
            (dict(engine="sharded", vertex_sharding="halo", mesh=mesh,
                  mesh_shape=(1, 1)), ValueError, "not both"),
            (dict(engine="sharded", frontier_exchange="sparse"),
             ValueError, "vertex_sharding='range' or 'halo'"),
            (dict(engine="sharded", vertex_sharding="range",
                  frontier_cap=8), ValueError, "frontier_cap"),
            (dict(engine="unified", mesh=mesh), ValueError, "mesh="),
            (dict(freelist="hierarchical"), ValueError, "engine='sharded'"),
            (dict(engine="sharded", freelist="bogus"), ValueError,
             "unknown freelist")]:
        with pytest.raises(exc, match=match):
            CoreMaintainer.from_graph(g, device="cpu", **kw)
    # a mesh holds tensors of its own device type
    cuda_mesh = types.SimpleNamespace(mesh_dim_names=("data",),
                                      device_type="cuda")
    with pytest.raises(ValueError, match="NCCL meshes hold CUDA"):
        CoreMaintainer.from_graph(g, device="cpu", engine="sharded",
                                  mesh=cuda_mesh)
    fn = make_sharded_apply(mesh, 10, 12, local_active=64)
    with pytest.raises(ValueError, match="PER-SHARD"):
        fn(*[torch.zeros(16, dtype=t) for t in (torch.int32, torch.int32,
                                                 torch.bool)],
           torch.zeros(10, dtype=torch.int32),
           torch.zeros(10, dtype=torch.int64), torch.tensor(0),
           *[torch.zeros(1, dtype=t) for t in (torch.int32, torch.int32,
                                                torch.bool)] * 2)
    with pytest.raises(ValueError, match="sparse"):
        make_sharded_apply(mesh, 10, 12, frontier_exchange="sparse")
    with pytest.raises(ValueError, match="ranks"):
        port_mesh.make_edge_mesh(n_devices=3)
    m2 = port_mesh.make_edge_vertex_mesh(mesh_shape=(1, 1))
    assert (m2.mesh_dim_names, tuple(m2.mesh.shape)) == (("edge", "data"),
                                                         (1, 1))
    assert port_mesh.table_group(m2) is port_mesh.table_group(m2)
    for shape, match in [((2, 2), "needs 4 devices"), ((0, 1), "positive")]:
        with pytest.raises(ValueError, match=match):
            port_mesh.make_edge_vertex_mesh(mesh_shape=shape)
    with pytest.raises(ValueError, match="vertex_sharding='halo'"):
        make_sharded_apply(m2, 10, 12)
    assert make_layout("replicated", 10, None) == ReplicatedVertices(10)
    with pytest.raises(ValueError, match="unknown vertex layout"):
        make_layout("bogus", 10, None)
    with pytest.raises(ValueError, match="mesh axis"):
        make_layout("range", 10, None)
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    with pytest.raises(ValueError, match="init_process_group"):
        port_mesh.make_edge_mesh()


def test_record_traffic_does_not_nest():
    with record_traffic() as log:
        with pytest.raises(RuntimeError, match="does not nest"):
            with record_traffic():
                pass
        assert log == []


def test_slot_high_water_and_completion(mesh):
    """The high-water mark is the max over shards of the local one; only
    a layout without a mesh axis completes locally (and may fuse)."""
    valid = torch.tensor([True, False, True, False])
    assert int(G.slot_high_water(valid)) == 3
    assert int(G.slot_high_water(valid, mesh.get_group("data"))) == 3
    assert G.completes_locally(None)
    assert not G.completes_locally(
        ReplicatedVertices(4, mesh.get_group("data")))
