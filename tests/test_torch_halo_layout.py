"""The port's 2-axis halo layout and sparse frontier exchange on a world
of ONE gloo rank, in process, against the reference: the sparse halo
refresh across the overflow boundary (masks and (core, label) values,
the overflow flags) on the reference's own case; one sparse removal
round and one sparse promotion round against the reference's traced
``record_traffic`` (op and bytes; the port issues one arm, so the
non-overflow arm is the reference's records with ``branch="overflow"``
filtered out, and an overflowing round adds exactly the filtered
records), on the range layout and on the 2-axis ``(1, 1)`` mesh (the
``psum_edge`` all-reduce); ``make_layout``, ``make_sharded_apply``,
``CoreMaintainer`` and ``make_edge_vertex_mesh`` raising where the
reference raises ``ValueError``; ``plan_frontier_cap`` and
``bucket_lattice`` equal to the reference's over a grid; and the halo
engine on a ``(1, 1)`` mesh against the reference's on one device,
batch by batch at tolerance 0, dense and sparse. The 4-rank runs are in
``tests/test_torch_halo_ranks.py``.
"""
import datetime
import itertools
import warnings

import numpy as np
import pytest
import torch
import torch.distributed as dist

pytest.importorskip("jax", reason="the reference package runs on jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402
from repro.analysis.programs import (trace_promotion_round,  # noqa: E402
                                     trace_removal_round)
from repro.compat import shard_map  # noqa: E402
from repro.core import api as jax_api  # noqa: E402
from repro.core import sharded as jax_sharded  # noqa: E402
from repro.core import vertex_layout as jax_layout  # noqa: E402
from repro.graph.generators import erdos_renyi  # noqa: E402
from repro.graph.stream import churn_stream, mixed_stream  # noqa: E402
from repro.launch import mesh as jax_mesh  # noqa: E402
from repro_torch.core import api as port_api  # noqa: E402
from repro_torch.core.engine import build_halo_ids  # noqa: E402
from repro_torch.core.insert import promotion_fixpoint_halo  # noqa: E402
from repro_torch.core.remove import removal_fixpoint_halo  # noqa: E402
from repro_torch.core.sharded import make_sharded_apply  # noqa: E402
from repro_torch.core.vertex_layout import (make_layout,  # noqa: E402
                                            record_traffic)
from repro_torch.graph.csr import build_csr  # noqa: E402
from repro_torch.launch import mesh as port_mesh  # noqa: E402

STATS = ("n_inserted", "n_removed", "insert_rounds", "n_promoted", "v_plus",
         "remove_rounds", "n_dropped", "renumbered", "n_recycled",
         "high_water", "max_frontier", "n_overflow")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """A world of one gloo rank (FileStore rendezvous); yields the 1-D
    mesh and the 2-axis ``(1, 1)`` mesh."""
    store = dist.FileStore(str(tmp_path_factory.mktemp("pg") / "store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=30))
    try:
        yield (port_mesh.make_edge_mesh(),
               port_mesh.make_edge_vertex_mesh(mesh_shape=(1, 1)))
    finally:
        dist.destroy_process_group()


def _ops(log):
    return [(t.op, t.recv_bytes) for t in log]


@pytest.mark.parametrize("k_mode", ["empty", "cap-1", "cap", "cap+1", "all"])
def test_sparse_refresh_roundtrip_across_overflow_boundary(world, k_mode):
    """The reference's case (n = 13, cap 4, halo cap 16, one shard):
    ``refresh_mask`` and ``refresh_values`` give the reference's halo
    mask, cores, labels and overflow flags at every frontier size, and
    the refreshed halo is the committed state's exact image."""
    n, cap, hcap = 13, 4, 16
    k = {"empty": 0, "cap-1": cap - 1, "cap": cap,
         "cap+1": cap + 1, "all": n}[k_mode]
    rng = np.random.default_rng(3 + k)
    changed = np.zeros(n, dtype=bool)
    changed[rng.choice(n, size=k, replace=False)] = True
    old_core = rng.integers(0, 50, n).astype(np.int32)
    old_label = rng.integers(0, 1 << 40, n).astype(np.int64)
    new_core = np.where(changed, old_core + 1, old_core).astype(np.int32)
    new_label = np.where(changed, old_label + 7, old_label).astype(np.int64)
    ids = np.concatenate([np.arange(n), np.full(hcap - n, n)]).astype(
        np.int32)
    args = (ids, old_core, old_label, new_core, new_label, changed)

    jlay = jax_layout.make_layout("range", n, "data", 1, frontier_cap=cap)
    all_ids = jnp.arange(n, dtype=jnp.int32)

    def kernel(ids, old_core, old_label, new_core, new_label, changed):
        sess = jlay.bind(ids)
        core_h = sess.gather_values(old_core)
        label_h = sess.gather_values(old_label)
        halo_mask, m_ovf = sess.refresh_mask(changed)
        core_h, label_h, v_ovf = sess.refresh_values(
            new_core, new_label, changed, core_h, label_h)
        return sess.locate(all_ids), halo_mask, core_h, label_h, m_ovf, v_ovf

    f = jax.jit(shard_map(kernel, mesh=jax.make_mesh((1,), ("data",)),
                          in_specs=(P(),) + (P("data"),) * 5,
                          out_specs=(P(),) * 6, check_vma=False))
    want = [np.asarray(x) for x in f(*[jnp.asarray(a) for a in args])]

    lay = make_layout("range", n, world[0].get_group("data"), 1,
                      frontier_cap=cap)
    t = [torch.from_numpy(a) for a in args]
    sess = lay.bind(t[0])
    core_h = sess.gather_values(t[1])
    label_h = sess.gather_values(t[2])
    halo_mask, m_ovf = sess.refresh_mask(t[5])
    core_h, label_h, v_ovf = sess.refresh_values(t[3], t[4], t[5], core_h,
                                                 label_h)
    got = [sess.locate(torch.arange(n, dtype=torch.int32)), halo_mask,
           core_h, label_h]
    for g, w, name in zip(got, want, ("pos", "mask_h", "core_h", "label_h")):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
        assert g.numpy().dtype == w.dtype, name
    assert (m_ovf, v_ovf) == (bool(want[4]), bool(want[5])) == (k > cap,) * 2
    pos = want[0]
    np.testing.assert_array_equal(got[1].numpy()[pos], changed)
    np.testing.assert_array_equal(got[2].numpy()[pos], new_core)
    np.testing.assert_array_equal(got[3].numpy()[pos], new_label)


def _state(n, cap, lanes, core_value):
    """The reference tracers' inputs: no live slot, every core
    ``core_value`` (0: nothing moves; 1: every vertex drops in round 1,
    since no edge supports it)."""
    return (torch.zeros(cap, dtype=torch.int32),
            torch.ones(cap, dtype=torch.int32),
            torch.zeros(cap, dtype=torch.bool),
            torch.full((n,), core_value, dtype=torch.int32),
            torch.zeros(n, dtype=torch.int64),
            torch.zeros(lanes, dtype=torch.int32),
            torch.ones(lanes, dtype=torch.int32))


def _layout(world, kind, n, fcap):
    mesh = world[0] if kind == "range" else world[1]
    edge = () if kind == "range" else (mesh.get_group("edge"),)
    return make_layout(kind, n, mesh.get_group("data"), 1, fcap, edge)


def _jmesh(kind):
    return (jax.make_mesh((1,), ("data",)) if kind == "range"
            else jax.make_mesh((1, 1), ("edge", "data")))


def _removal(lay, n, state):
    src, dst, valid, core, label, ru, rv = state
    sess = lay.bind(build_halo_ids(lay, src, dst, ru, rv, ru, rv, n))
    return removal_fixpoint_halo(
        sess.locate(src), sess.locate(dst), valid, core, label,
        sess.gather_values(core), sess.gather_values(label), sess, n + 2)


@pytest.mark.parametrize("kind", ["range", "halo"])
def test_sparse_removal_round_traffic_matches_reference(world, kind):
    """A sparse removal round: set-up (``gather_halo``, two entry
    ``regather``), ``gather_stats`` (+ ``psum_edge`` on the 2-axis
    mesh), the ring's 5 ``ppermute``, the three ``gather_frontier``
    columns (ids, cores, labels) and the vote — the reference's traced
    budget with the overflow arm filtered out. With every core at 1 and
    no edge, all 24 vertices drop in round 1 (24 > cap 8): that round
    adds the overflow arm's two dense ``regather``, the next round (no
    drop) is the non-overflow budget again, and ``n_overflow`` is 1."""
    n, cap, lanes, fcap = 24, 32, 8, 8
    log, _ = trace_removal_round(kind, n, cap, _jmesh(kind), lanes=lanes,
                                 frontier_cap=fcap)
    main = _ops([t for t in log if t.branch != "overflow"])
    fallback = _ops([t for t in log if t.branch == "overflow"])
    assert [op for op, _ in fallback] == ["regather", "regather"]
    round_ops = [op for op, _ in main[3:]]
    assert round_ops == (
        ["gather_stats"] + (["psum_edge"] if kind == "halo" else [])
        + ["ppermute"] * 5 + ["gather_frontier"] * 3 + ["psum_scalar"])
    lay = _layout(world, kind, n, fcap)
    with record_traffic() as quiet:
        out = _removal(lay, n, _state(n, cap, lanes, 0))
    assert int(out[4]) == 1 and int(out[8]) == 0
    assert _ops(quiet) == main
    with record_traffic() as loud:
        out = _removal(lay, n, _state(n, cap, lanes, 1))
    assert int(out[4]) == 2 and int(out[8]) == 1
    assert torch.equal(out[0], torch.zeros(n, dtype=torch.int32))
    # round 1 took the overflow arm: the dense regathers follow the
    # gathered columns, before the vote
    assert _ops(loud) == (main[:-1] + fallback + main[-1:]
                          + main[3:])


@pytest.mark.parametrize("kind", ["range", "halo"])
def test_sparse_promotion_round_traffic_matches_reference(world, kind):
    """A sparse promotion round: a forward wave and an eviction round
    (each a ``gather_frontier`` of the mask, a stats gather and a vote),
    the two ring placements, the three ``gather_frontier`` columns of
    the value refresh, the next round's ``(hi, dout)`` and the vote —
    the reference's traced non-overflow budget, op for op and byte for
    byte (``psum_edge`` after every stats gather on the 2-axis mesh)."""
    n, cap, lanes, fcap = 24, 32, 8, 8
    log, _ = trace_promotion_round(kind, n, cap, _jmesh(kind), lanes=lanes,
                                   frontier_cap=fcap)
    main = [t for t in log if t.branch != "overflow"]
    src, dst, valid, core, label, nu, nv = _state(n, cap, lanes, 0)
    hi = torch.zeros(n, dtype=torch.int32)
    lay = _layout(world, kind, n, fcap)
    with record_traffic() as got:
        sess = lay.bind(build_halo_ids(lay, src, dst, nu, nv, nu, nv, n))
        out = promotion_fixpoint_halo(
            sess.locate(src), sess.locate(dst), valid, core, label,
            sess.gather_values(core), sess.gather_values(label), nu, nv,
            sess.locate(nu), sess.locate(nv), torch.zeros(lanes, dtype=bool),
            hi, hi.clone(), sess, n + 2)
    assert int(out[4]) == 1 and int(out[7]) == 0
    assert [op for op, _ in _ops(got)].count("gather_frontier") == 5
    assert ("psum_edge" in [op for op, _ in _ops(got)]) == (kind == "halo")
    assert _ops(got) == _ops(main)


def _both_raise(ref_fn, port_fn, match):
    with pytest.raises(ValueError, match=match):
        ref_fn()
    with pytest.raises(ValueError, match=match):
        port_fn()


LAYOUT_ERRORS = [
    (("replicated", 10, "data", 1, 8, ()), "frontier_cap"),
    (("replicated", 10, "data", 1, None, ("edge",)), "edge_axes"),
    (("range", 10, "data", 2, 0, ()), "frontier_cap must be >= 1"),
    (("range", 10, "data", 2, None, ("edge",)), "needs\\s+vertex_sharding"),
    (("halo", 10, "data", 2, None, ()), "pure-edge axes"),
    (("halo", 10, None, 2, 8, ("edge",)), "needs a mesh axis"),
    (("ring", 10, "data", 2, None, ()), "unknown vertex layout"),
]


@pytest.mark.parametrize("args,match", LAYOUT_ERRORS,
                         ids=[str(i) for i in range(len(LAYOUT_ERRORS))])
def test_make_layout_raises_as_reference(world, args, match):
    kind, n, axis, shards, fcap, edge = args
    groups = {"data": world[1].get_group("data"), None: None}
    _both_raise(
        lambda: jax_layout.make_layout(*args),
        lambda: make_layout(kind, n, groups[axis], shards, fcap,
                            tuple(world[1].get_group(a) for a in edge)),
        match)


APPLY_ERRORS = [
    ("1d", dict(vertex_sharding="halo"), "vertex_sharding='halo' needs"),
    ("2d", dict(vertex_sharding="range"), "multi-axis mesh"),
    ("2d", dict(), "multi-axis mesh"),
    ("1d", dict(axis="owner"), "no vertex/owner axis"),
    ("1d", dict(frontier_exchange="dense"), "unknown frontier_exchange"),
    ("1d", dict(frontier_exchange="sparse", frontier_cap=8),
     "needs vertex_sharding='range'"),
    ("2d", dict(vertex_sharding="halo", frontier_exchange="sparse"),
     "frontier_cap >= 1"),
    ("1d", dict(vertex_sharding="range", frontier_cap=8),
     "only consumed by"),
]


@pytest.mark.parametrize("mesh_kind,kw,match", APPLY_ERRORS,
                         ids=[str(i) for i in range(len(APPLY_ERRORS))])
def test_make_sharded_apply_raises_as_reference(world, mesh_kind, kw,
                                                match):
    jm = _jmesh("range" if mesh_kind == "1d" else "halo")
    pm = world[0] if mesh_kind == "1d" else world[1]
    _both_raise(lambda: jax_sharded.make_sharded_apply(jm, 10, 12, **kw),
                lambda: make_sharded_apply(pm, 10, 12, **kw), match)


MAINTAINER_ERRORS = [
    (dict(engine="sharded", vertex_sharding="range", mesh_shape=(1, 1)),
     "only consumed by\\s+vertex_sharding='halo'"),
    (dict(engine="sharded", vertex_sharding="halo", mesh_shape=(0, 1)),
     "mesh_shape must be positive"),
    (dict(engine="sharded", vertex_sharding="halo", mesh_shape=(1, 1),
          mesh="1d"), "not both"),
    (dict(engine="sharded", vertex_sharding="halo", mesh="1d"),
     "needs a 2-axis"),
    (dict(engine="sharded", vertex_sharding="range", mesh="2d"),
     "multi-axis mesh"),
    (dict(engine="unified", vertex_sharding="halo"), "engine='sharded'"),
    (dict(engine="sharded", frontier_exchange="sparse"),
     "needs vertex_sharding="),
    (dict(engine="sharded", vertex_sharding="halo", frontier_exchange="x"),
     "unknown frontier_exchange"),
    (dict(engine="sharded", vertex_sharding="range",
          frontier_exchange="sparse", frontier_cap=-1), "must be >= 0"),
    (dict(engine="sharded", vertex_sharding="range", frontier_cap=8),
     "only consumed by\\s+frontier_exchange='sparse'"),
]


@pytest.mark.parametrize("kw,match", MAINTAINER_ERRORS,
                         ids=[str(i) for i in range(len(MAINTAINER_ERRORS))])
def test_core_maintainer_raises_as_reference(world, kw, match):
    g = erdos_renyi(12, 20, seed=1)

    def mk(kw, meshes, **extra):
        kw = dict(kw)
        if "mesh" in kw:
            kw["mesh"] = meshes[kw["mesh"]]
        return kw | extra

    jm = {"1d": _jmesh("range"), "2d": _jmesh("halo")}
    pm = {"1d": world[0], "2d": world[1]}
    _both_raise(
        lambda: jax_api.CoreMaintainer.from_graph(g, **mk(kw, jm)),
        lambda: port_api.CoreMaintainer.from_graph(
            build_csr(g.n, g.edge_array()), **mk(kw, pm, device="cpu")),
        match)


@pytest.mark.parametrize("shape,match", [((0, 1), "positive"),
                                         ((1, -2), "positive"),
                                         ((2, 1), "needs 2 devices"),
                                         ((1, 3), "needs 3 devices")])
def test_make_edge_vertex_mesh_raises_as_reference(world, shape, match):
    _both_raise(lambda: jax_mesh.make_edge_vertex_mesh(mesh_shape=shape),
                lambda: port_mesh.make_edge_vertex_mesh(mesh_shape=shape),
                match)


def test_plan_frontier_cap_matches_reference():
    """The pure planner over a grid of (exchange, pinned cap, padded
    batch, owned range, observed quantile)."""
    grid = itertools.product(("bitmask", "sparse"), (0, 1, 8, 4096),
                             (1, 2, 8, 64, 512, 4096),
                             (1, 3, 30, 1000, 2**21),
                             (0, 1, 17, 300, 10**6))
    n = 0
    for fe, pinned, b_pad, n_owned, observed in grid:
        want = jax_api.plan_frontier_cap(fe, pinned, b_pad, n_owned,
                                         observed)
        assert port_api.plan_frontier_cap(fe, pinned, b_pad, n_owned,
                                          observed) == want
        n += want > 0
    assert n > 0


def test_bucket_lattice_matches_reference():
    grid = itertools.product((16, 100, 4096, 2**20), (1, 64, 1000),
                             ("bitmask", "sparse"), (0, 8), (1, 30, 5000))
    for local_cap, lanes, fe, pinned, n_owned in grid:
        assert port_api.bucket_lattice(local_cap, lanes, fe, pinned,
                                       n_owned) == jax_api.bucket_lattice(
            local_cap, lanes, fe, pinned, n_owned)


def _apply(m, ev, **kw):
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="Some donated buffers")
        return m.apply_batch(insert_edges=ev.edges, remove_edges=ev.removals,
                             **kw)


@pytest.mark.parametrize("weighted", [False, True], ids=["unit", "weighted"])
@pytest.mark.parametrize("exchange", ["dense", "cap1", "cap8", "planned"])
def test_world_of_one_halo_matches_reference(world, exchange, weighted):
    """The halo engine on a ``(1, 1)`` mesh of one gloo rank against the
    reference's on ``mesh_shape=(1, 1)`` of one device, batch by batch:
    the table, ``n_edges``, cores, labels and the 12 stats (cap 1
    overflows on every refresh that moves more than one vertex; the
    planned cap plans the same buckets from the same observations)."""
    g = erdos_renyi(200, 800, seed=2)
    w0 = (np.random.default_rng(7).integers(1, 6, g.m) if weighted
          else None)
    kw = dict(engine="sharded", vertex_sharding="halo", weighted=weighted,
              weights=w0, capacity=g.m + 40)
    if exchange != "dense":
        kw |= dict(frontier_exchange="sparse",
                   frontier_cap={"cap1": 1, "cap8": 8, "planned": 0}[
                       exchange])
    jm = jax_api.CoreMaintainer.from_graph(g, mesh_shape=(1, 1), **kw)
    tm = port_api.CoreMaintainer.from_graph(
        build_csr(g.n, g.edge_array()), device="cpu", mesh=world[1], **kw)
    overflows = 0
    for ev in churn_stream(g, 4, 48, same_batch_roundtrip=True, dirty=True,
                           seed=6):
        iw = (np.random.default_rng(100 + ev.t).integers(1, 6, len(ev.edges))
              if weighted else None)
        js = _apply(jm, ev, insert_weights=iw)
        ts = _apply(tm, ev, insert_weights=iw)
        np.testing.assert_array_equal(tm.cores(), jm.cores())
        np.testing.assert_array_equal(tm.labels(), jm.labels())
        state = tm.state()
        for name in ("src", "dst", "valid") + (("w",) if weighted else ()):
            np.testing.assert_array_equal(state[name],
                                          np.asarray(getattr(jm, name)))
        assert int(tm.n_edges) == int(jm.n_edges)
        for f in STATS:
            assert int(getattr(ts, f)) == int(getattr(js, f)), (ev.t, f)
        overflows += int(ts.n_overflow)
    # the weighted fixpoints never refresh sparsely; cap 1 overflows
    if weighted or exchange == "dense":
        assert overflows == 0
    elif exchange == "cap1":
        assert overflows > 0
    caps = {c for _, c in tm._sharded_fns}
    want = {"dense": {0}, "cap1": {1}, "cap8": {8}}.get(exchange)
    assert caps == want if want else min(caps) >= 32


def test_mixed_stream_sparse_range_world_of_one(world):
    """``frontier_exchange="sparse"`` on the 1-D range engine: the same
    states as the reference's, a pinned cap of 2 overflowing somewhere
    and not everywhere."""
    g = erdos_renyi(300, 1200, seed=3)
    kw = dict(engine="sharded", vertex_sharding="range",
              frontier_exchange="sparse", frontier_cap=2)
    jm = jax_api.CoreMaintainer.from_graph(g, **kw)
    tm = port_api.CoreMaintainer.from_graph(
        build_csr(g.n, g.edge_array()), device="cpu", mesh=world[0], **kw)
    seen = []
    for ev in mixed_stream(g, 4, 64, seed=5):
        js, ts = _apply(jm, ev), _apply(tm, ev)
        np.testing.assert_array_equal(tm.cores(), jm.cores())
        np.testing.assert_array_equal(tm.labels(), jm.labels())
        assert [int(getattr(ts, f)) for f in STATS] == [
            int(getattr(js, f)) for f in STATS]
        seen.append(int(ts.n_overflow))
    assert max(seen) > 0
