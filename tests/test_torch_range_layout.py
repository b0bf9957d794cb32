"""The port's range-sharded vertex layout (``vertex_sharding="range"``:
``HaloShardedVertices``, ``HaloSession``, the ring placement) on a world
of ONE gloo rank, in process, against the reference's: the session's
round trips (``gather_values``, ``locate``, ``complete``, ``add_at``,
``any_owned``) on the reference's own case, the ``make_layout`` checks,
the collectives of one removal round, one promotion round
and one weighted bisection step against the reference's traced
``record_traffic`` (op and bytes), the ring placement against
``place_block``, the dispatch of ``kernel_backend="cuda"`` at halo
width (kernels a and d, never the fused b and c), and the range engine
against the reference's range engine on one device, batch by batch at
tolerance 0 (slot table, ``n_edges``, cores, labels, the 12
BatchStats). The 4-rank runs are in ``tests/test_torch_range_ranks.py``.
"""
import datetime
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
from repro.core import engine as jax_engine  # noqa: E402
from repro.core import remove as jax_remove  # noqa: E402
from repro.core import vertex_layout as jax_layout  # noqa: E402
from repro.core.api import CoreMaintainer as JaxMaintainer  # noqa: E402
from repro.graph.generators import erdos_renyi  # noqa: E402
from repro.graph.stream import churn_stream, mixed_stream  # noqa: E402
from repro_torch.core import order  # noqa: E402
from repro_torch.core.api import CoreMaintainer  # noqa: E402
from repro_torch.core.engine import build_halo_ids, halo_cap_for  # noqa: E402
from repro_torch.core.insert import promotion_fixpoint_halo  # noqa: E402
from repro_torch.core.remove import (removal_fixpoint_halo,  # noqa: E402
                                     weighted_core_fixpoint_pass_halo)
from repro_torch.core.sharded import make_sharded_apply  # noqa: E402
from repro_torch.core.vertex_layout import (HaloShardedVertices,  # noqa: E402
                                            _note, make_layout,
                                            record_shapes, record_traffic)
from repro_torch.graph.csr import build_csr  # noqa: E402
from repro_torch.kernels import coremaint  # noqa: E402
from repro_torch.launch import mesh as port_mesh  # noqa: E402

STATS = ("n_inserted", "n_removed", "insert_rounds", "n_promoted", "v_plus",
         "remove_rounds", "n_dropped", "renumbered", "n_recycled",
         "high_water", "max_frontier", "n_overflow")


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """A world of one gloo rank, rendezvous through a FileStore; yields
    the mesh's ``"data"`` group."""
    store = dist.FileStore(str(tmp_path_factory.mktemp("pg") / "store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=30))
    try:
        yield port_mesh.make_edge_mesh().get_group("data")
    finally:
        dist.destroy_process_group()


def _jmesh():
    return jax.make_mesh((1,), ("data",))


def _ops(log):
    return [(t.op, t.recv_bytes) for t in log]


def test_halo_session_roundtrips_one_shard(group):
    """The reference's round-trip case (n = 13, halo cap 16, one shard),
    through both packages: halo values are exact images of the owned
    state, halo partials complete to the owned sums, the mask refresh,
    the owner scatter-add of replicated lanes and ``any_owned``."""
    n, hcap = 13, 16
    ids = np.concatenate([np.arange(n), np.full(hcap - n, n)]).astype(
        np.int32)
    core = (np.arange(n) * 7 - 3).astype(np.int32)
    mask = (np.arange(n) % 3) == 0
    lay = jax_layout.make_layout("range", n, "data", 1)
    all_ids = jnp.arange(n, dtype=jnp.int32)

    def kernel(ids, core, mask):
        sess = lay.bind(ids)
        pos = sess.locate(all_ids)
        stats = jnp.zeros(hcap, jnp.int32).at[pos].add(all_ids)
        halo_mask, _ = sess.refresh_mask(mask)  # dense: a regather
        delta = sess.add_at(sess.zeros(), jnp.array([0, 12, 12]),
                            jnp.array([5, 1, 1], jnp.int32))
        return (sess.gather_values(core), pos, sess.complete(stats),
                halo_mask, delta, sess.any_owned(mask))

    f = shard_map(kernel, mesh=_jmesh(),
                  in_specs=(P(), P("data"), P("data")),
                  out_specs=(P(), P(), P("data"), P(), P("data"), P()),
                  check_vma=False)
    want = [np.asarray(x) for x in jax.jit(f)(jnp.asarray(ids),
                                              jnp.asarray(core),
                                              jnp.asarray(mask))]

    tl = make_layout("range", n, group, 1)
    assert isinstance(tl, HaloShardedVertices)
    assert (tl.n_owned, tl.n_pad) == (13, 13)
    sess = tl.bind(torch.from_numpy(ids))
    pos = sess.locate(torch.arange(n, dtype=torch.int32))
    assert pos.dtype == torch.int32
    stats = torch.zeros(hcap, dtype=torch.int32).index_add_(
        0, pos, torch.arange(n, dtype=torch.int32))
    halo_mask = sess.gather_values(torch.from_numpy(mask).int()) > 0
    delta = sess.add_at(sess.zeros(), torch.tensor([0, 12, 12]),
                        torch.tensor([5, 1, 1], dtype=torch.int32))
    got = [sess.gather_values(torch.from_numpy(core)), pos,
           sess.complete(stats), halo_mask, delta,
           sess.any_owned(torch.from_numpy(mask))]
    for g, w, name in zip(got, want, ("core_h", "pos", "complete", "mask_h",
                                      "add_at", "any_owned")):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    np.testing.assert_array_equal(got[2].numpy(), np.arange(n))


def test_locate_keeps_src_runs(group):
    """``locate`` is monotone and exact on the referenced ids: equal src
    ids keep one position and distinct ones stay distinct, so the
    kernels' runs of one src over a sorted window stay runs."""
    lay = make_layout("range", 50, group, 1)
    src = torch.tensor([3, 3, 3, 7, 7, 9, 20, 20, 41], dtype=torch.int32)
    dst = torch.tensor([8, 1, 4, 2, 30, 5, 6, 49, 0], dtype=torch.int32)
    z = torch.zeros(2, dtype=torch.int32)
    ids = build_halo_ids(lay, src, dst, z, z, z, z, 50)
    assert ids.shape[0] == halo_cap_for(9, 4, 50) == 32
    sess = lay.bind(ids)
    ps, pd = sess.locate(src), sess.locate(dst)
    assert torch.equal(sess.halo_ids[ps.long()], src)
    assert torch.equal(sess.halo_ids[pd.long()], dst)
    assert bool((ps[1:] >= ps[:-1]).all())
    assert torch.equal(ps[1:] == ps[:-1], src[1:] == src[:-1])


def test_make_layout_checks_and_refusals(group):
    """The reference's construction-time checks; the 2-axis layout (with
    pure-edge groups) and the sparse exchange (with a ``frontier_cap``)
    build, and a mesh that does not fit the layout is refused by
    ``make_sharded_apply``."""
    lay = make_layout("range", 10, group, 4)
    assert (lay.kind, lay.n_owned, lay.n_pad) == ("halo", 3, 12)
    for args, exc, match in [
            (("range", 5, None), ValueError, "mesh axis"),
            (("diagonal", 5, group), ValueError, "unknown vertex layout"),
            (("replicated", 10, group, 8), ValueError, "n_shards"),
            (("replicated", 10, group, 1, 16), ValueError, "frontier_cap"),
            (("replicated", 10, group, 1, None, ("edge",)), ValueError,
             "edge_axes"),
            (("range", 10, group, 2, 0), ValueError, "frontier_cap"),
            (("range", 10, group, 2, None, ("edge",)), ValueError, "halo"),
            (("halo", 10, group, 2), ValueError, "edge axes")]:
        with pytest.raises(exc, match=match):
            make_layout(*args)
    halo = make_layout("halo", 10, group, 2, None, (group,))
    assert (halo.edge_axes, halo.frontier_cap) == ((group,), None)
    sparse = make_layout("range", 10, group, 2, 8)
    assert (sparse.edge_axes, sparse.frontier_cap) == ((), 8)
    assert callable(make_sharded_apply(
        port_mesh.make_edge_mesh(), 10, 12, vertex_sharding="range",
        frontier_exchange="sparse", frontier_cap=8))
    with pytest.raises(ValueError, match="2-axis"):
        make_sharded_apply(port_mesh.make_edge_mesh(), 10, 12,
                           vertex_sharding="halo")


def _zero_state(n, cap, lanes):
    """The reference tracers' inputs: no live slot, every core 0."""
    return (torch.zeros(cap, dtype=torch.int32),
            torch.ones(cap, dtype=torch.int32),
            torch.zeros(cap, dtype=torch.bool),
            torch.zeros(n, dtype=torch.int32),
            torch.zeros(n, dtype=torch.int64),
            torch.zeros(lanes, dtype=torch.int32),
            torch.ones(lanes, dtype=torch.int32))


def _open(lay, src, dst, ru, rv, n, core, label):
    """The batch program's halo set-up: membership, bind, the entry
    regathers, the window's positions."""
    sess = lay.bind(build_halo_ids(lay, src, dst, ru, rv, ru, rv, n))
    core_h = sess.gather_values(core)
    label_h = None if label is None else sess.gather_values(label)
    return sess, core_h, label_h, sess.locate(src), sess.locate(dst)


def test_removal_round_traffic_matches_reference(group):
    """One removal round: the per-batch set-up (``gather_halo``, two
    ``regather``), then the round's ``gather_stats``, the ring's 5
    ``ppermute``, the dense refresh and the continue vote — the
    reference's traced budget, op for op and byte for byte."""
    n, cap, lanes = 24, 32, 8
    want, _ = trace_removal_round("range", n, cap, _jmesh(), lanes=lanes)
    src, dst, valid, core, label, ru, rv = _zero_state(n, cap, lanes)
    lay = make_layout("range", n, group, 1)
    with record_traffic() as log:
        sess, ch, lh, sh, dh = _open(lay, src, dst, ru, rv, n, core, label)
        out = removal_fixpoint_halo(sh, dh, valid, core, label, ch, lh,
                                    sess, n + 2)
    assert int(out[4]) == 1  # one round
    assert [op for op, _ in _ops(log)] == (
        ["gather_halo", "regather", "regather", "gather_stats"]
        + ["ppermute"] * 5 + ["regather", "regather", "psum_scalar"])
    assert _ops(log) == _ops(want)


def test_promotion_round_traffic_matches_reference(group):
    """One promotion round: a forward wave and an eviction round (each a
    mask regather, a stats gather and a vote), two ring placements (10
    ``ppermute``), the refresh, the next round's ``(hi, dout)`` and the
    vote — as the reference traces it."""
    n, cap, lanes = 24, 32, 8
    want, _ = trace_promotion_round("range", n, cap, _jmesh(), lanes=lanes)
    src, dst, valid, core, label, nu, nv = _zero_state(n, cap, lanes)
    nok = torch.zeros(lanes, dtype=torch.bool)
    hi = torch.zeros(n, dtype=torch.int32)
    lay = make_layout("range", n, group, 1)
    with record_traffic() as log:
        sess, ch, lh, sh, dh = _open(lay, src, dst, nu, nv, n, core, label)
        out = promotion_fixpoint_halo(
            sh, dh, valid, core, label, ch, lh, nu, nv, sess.locate(nu),
            sess.locate(nv), nok, hi, hi.clone(), sess, n + 2)
    assert int(out[4]) == 1
    assert _ops(log).count(("ppermute", n * 4)) == 6
    assert _ops(log) == _ops(want)


def test_weighted_step_traffic_matches_reference(group):
    """One weighted round of one bisection step: the entry ``regather``
    of the cores, the bisection's opening vote, then a step's
    ``gather_stats`` (the weighted support), ``regather`` (the ``ok``
    verdict into the halo) and vote, then the round's vote — the
    reference's traced weighted fixpoint on its halo (one loop body
    each). Cores 0/1 with a weighted triangle make exactly one step of
    one round."""
    n, cap, lanes = 24, 32, 8
    jlay = jax_layout.make_layout("range", n, "data", 1)

    def kernel(src, dst, valid, ew, core, ru, rv):
        sess = jlay.bind(jax_engine.build_halo_ids(jlay, src, dst, ru, rv,
                                                   ru, rv, n))
        core_h = sess.gather_values(core)
        return jax_remove.weighted_core_fixpoint_pass_halo(
            sess.locate(src), sess.locate(dst), valid, ew, core, core_h,
            sess)

    sm = shard_map(kernel, mesh=_jmesh(),
                   in_specs=(P("data"),) * 5 + (P(), P()),
                   out_specs=(P("data"), P(), P(), P()), check_vma=False)
    z = jnp.zeros(cap, jnp.int32)
    with jax_layout.record_traffic() as want:
        jax.make_jaxpr(sm)(z, z + 1, jnp.zeros(cap, bool), z + 1,
                           jnp.zeros(n, jnp.int32),
                           jnp.zeros(lanes, jnp.int32),
                           jnp.ones(lanes, jnp.int32))
    src, dst, valid, core, _, ru, rv = _zero_state(n, cap, lanes)
    src[:3] = torch.tensor([0, 1, 0], dtype=torch.int32)
    dst[:3] = torch.tensor([1, 2, 2], dtype=torch.int32)
    valid[:3] = True
    w = torch.tensor([3, 1, 2] + [1] * (cap - 3), dtype=torch.int32)
    core[:3] = 1
    lay = make_layout("range", n, group, 1)
    with record_traffic() as log:
        sess, ch, _, sh, dh = _open(lay, src, dst, ru, rv, n, core, None)
        got, _, rounds, _ = weighted_core_fixpoint_pass_halo(
            sh, dh, valid, w, core, ch, sess)
    assert int(rounds) == 1 and torch.equal(got, core)
    assert [op for op, _ in _ops(log)] == [
        "gather_halo", "regather", "psum_scalar", "gather_stats",
        "regather", "psum_scalar", "psum_scalar"]
    assert _ops(log) == _ops(want)


@pytest.mark.parametrize("at_head", [True, False])
@pytest.mark.parametrize("keyed", [False, True], ids=["plain", "round_key"])
def test_ring_placement_equals_place_block(group, at_head, keyed):
    """At one shard the ring placement equals ``place_block`` on the
    whole state, with and without a round key; the ring renumber equals
    ``renumber``. One placement records 5 ``ppermute``, and at one
    shard no rank sends to itself (the rotation is the identity)."""
    rng = np.random.default_rng(3)
    n, n_levels = 200, 12
    core = torch.from_numpy(rng.integers(0, 10, n).astype(np.int32))
    label = torch.from_numpy(rng.permutation(n).astype(np.int64)
                             * order.LABEL_GAP)
    moving = torch.from_numpy(rng.random(n) < 0.3)
    rkey = (torch.from_numpy(rng.integers(0, 4, n).astype(np.int32))
            if keyed else None)
    with record_traffic() as log:
        got = order.place_block_ring(core, label, moving, at_head, n_levels,
                                     group, 1, round_key=rkey, note=_note)
    want = order.place_block(core, label, moving, at_head, n_levels,
                             round_key=rkey)
    assert torch.equal(got, want)
    assert [op for op, _ in _ops(log)] == ["ppermute"] * 5
    assert torch.equal(order.renumber_ring(core, got, group, 1),
                       order.renumber(core, got))


def test_cuda_backend_at_halo_width_runs_kernels_a_and_d(group,
                                                         monkeypatch):
    """Under ``"range"`` ``kernel_backend="cuda"`` routes every local
    partial through ``coo_stat`` at halo width (kernel a's
    ``mcd_hi_dout``, ``hi_dout``, ``din``, ``same_in``; kernel d's
    ``wsum`` weighted; their CPU path here) and never a fused decision
    (b, c), and gives the torch backend's result."""
    calls = []
    real = coremaint.coo_stat

    def spy(src, dst, valid, core, label, n, stat="mcd_hi_dout", **kw):
        calls.append((stat, n, core.shape[0]))
        return real(src, dst, valid, core, label, n, stat=stat, **kw)

    def refuse(*a, **kw):
        raise AssertionError("a fused decision ran under a range layout")

    mesh = port_mesh.make_edge_mesh()
    g = erdos_renyi(4096, 240, seed=6)  # sparse: the halo is not all n
    ev = next(mixed_stream(g, 1, 32, seed=3))
    for weighted in (False, True):
        base = CoreMaintainer.from_graph(
            build_csr(g.n, g.edge_array()), device="cpu", engine="sharded",
            mesh=mesh, vertex_sharding="range", weighted=weighted)
        lanes = []
        for e in (ev.edges, ev.removals):
            lanes += [torch.from_numpy(e[:, 0].astype(np.int32)),
                      torch.from_numpy(e[:, 1].astype(np.int32)),
                      torch.ones(len(e), dtype=torch.bool)]
        if weighted:
            lanes.insert(2, torch.full((len(ev.edges),), 2,
                                       dtype=torch.int32))
        out = {}
        for backend in ("torch", "cuda"):
            if backend == "cuda":
                monkeypatch.setattr(coremaint, "coo_stat", spy)
                monkeypatch.setattr(coremaint, "fused_removal_round", refuse)
                monkeypatch.setattr(coremaint, "fused_promotion_stats",
                                    refuse)
            fn = make_sharded_apply(mesh, base.n, base.n_levels,
                                    local_active=base._window(32),
                                    vertex_sharding="range",
                                    kernel_backend=backend,
                                    weighted=weighted)
            table = [base.src.clone(), base.dst.clone(), base.valid.clone()]
            if weighted:
                table.append(base.w.clone())
            out[backend] = fn(*table, base.core, base.label, base.n_edges,
                              *lanes)
            monkeypatch.undo()
        k = len(out["torch"]) - 1
        for a, b in zip(out["torch"][:k], out["cuda"][:k]):
            assert torch.equal(a, b)
        assert [int(x) for x in out["torch"][k]] == [
            int(x) for x in out["cuda"][k]]
    stats = {s for s, _, _ in calls}
    assert {"mcd_hi_dout", "hi_dout", "din", "same_in", "wsum"} <= stats
    # every launch is at halo width, not n
    hcap = halo_cap_for(base._window(32),
                        len(ev.edges) + len(ev.removals), g.n)
    assert hcap < g.n
    assert {(n, rows) for _, n, rows in calls} == {(hcap, hcap)}


def _apply(m, ev, **kw):
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="Some donated buffers")
        return m.apply_batch(insert_edges=ev.edges, remove_edges=ev.removals,
                             **kw)


def _assert_same(jm, tm, js=None, ts=None, where=""):
    np.testing.assert_array_equal(tm.cores(), jm.cores(), err_msg=where)
    np.testing.assert_array_equal(tm.labels(), jm.labels(), err_msg=where)
    state = tm.state()
    for name in ("src", "dst", "valid") + (("w",) if tm.weighted else ()):
        np.testing.assert_array_equal(
            state[name], np.asarray(getattr(jm, name)),
            err_msg=f"{where} {name}")
    assert int(tm.n_edges) == int(jm.n_edges), where
    if js is not None:
        for f in STATS:
            assert int(getattr(ts, f)) == int(getattr(js, f)), f"{where} {f}"


@pytest.mark.parametrize("weighted", [False, True],
                         ids=["unit", "weighted"])
@pytest.mark.parametrize("stream", ["mixed", "churn"])
def test_world_of_one_matches_reference_range(group, stream, weighted):
    """The range engine on one gloo rank against the reference's range
    engine on one device, batch by batch: the table, ``n_edges``,
    cores, labels and the 12 stats; the owned slice is the whole
    (unpadded) state, and a vertex-domain tensor of the layout never
    outgrows ``max(n_owned, halo_cap)``."""
    g = erdos_renyi(200, 800, seed=2)
    w0 = (np.random.default_rng(7).integers(1, 6, g.m) if weighted
          else None)
    kw = dict(engine="sharded", vertex_sharding="range", weighted=weighted,
              weights=w0, capacity=g.m + 40)
    jm = JaxMaintainer.from_graph(g, **kw)
    tm = CoreMaintainer.from_graph(build_csr(g.n, g.edge_array()),
                                   device="cpu",
                                   mesh=port_mesh.make_edge_mesh(), **kw)
    _assert_same(jm, tm)
    if stream == "mixed":
        st = mixed_stream(g, 5, 48, seed=5)
    else:
        st = churn_stream(g, 5, 48, same_batch_roundtrip=True, dirty=True,
                          seed=6)
    for ev in st:
        iw = (np.random.default_rng(100 + ev.t).integers(1, 6, len(ev.edges))
              if weighted else None)
        js = _apply(jm, ev, insert_weights=iw)
        with record_shapes() as shapes:
            ts = _apply(tm, ev, insert_weights=iw)
        _assert_same(jm, tm, js, ts, where=f"t={ev.t}")
        assert tm.core.shape == (g.n,) and tm.label.shape == (g.n,)
        hcap = [r for op, r in shapes if op == "halo_ids"][0]
        assert max(r for _, r in shapes) <= max(g.n, hcap)
