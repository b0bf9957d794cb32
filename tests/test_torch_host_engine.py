"""The port's ``engine="host"`` (src/repro_torch/core/api.py, the seed
two-call path) against the reference's ``engine="host"``, batch by
batch, bit for bit: cores, k-order labels, the slot table, ``n_edges``
(the bump pointer), ``capacity``, the ``edge_slot`` dict and all 12
BatchStats fields (or the InsertStats / RemoveStats of the single-kind
calls), with tolerance 0. Plus the port's host and unified engines
against each other, mid-batch compaction, growth, a forced renumber,
atomic rejection, ``validate=False``, checkpoints across both packages
and both engines, and ``write_edge_slots`` / ``insert_batch`` /
``remove_batch`` called directly."""
import contextlib
import warnings

import numpy as np
import pytest
import torch

pytest.importorskip("jax", reason="the reference package runs on jax")
import jax.numpy as jnp  # noqa: E402
from repro.core import insert as jax_insert
from repro.core import remove as jax_remove
from repro.core.api import CoreMaintainer as JaxMaintainer
from repro.core.oracle import bz_from_csr
from repro.graph.csr import add_edges_csr, remove_edges_csr
from repro.graph.generators import erdos_renyi
from repro.graph.stream import churn_stream, mixed_stream, synthetic_stream
from repro_torch.core import insert as port_insert
from repro_torch.core import remove as port_remove
from repro_torch.core.api import CoreMaintainer
from repro_torch.core.order import LABEL_GAP, needs_renumber
from repro_torch.graph.csr import build_csr
from repro_torch.kernels import coremaint

from conftest import sample_absent

N, M = 200, 800


def _port(g, **kw):
    return CoreMaintainer.from_graph(build_csr(g.n, g.edge_array()),
                                     device="cpu", **kw)


def _assert_same(jm, tm, js=None, ts=None, where=""):
    np.testing.assert_array_equal(tm.cores(), jm.cores(), err_msg=where)
    np.testing.assert_array_equal(tm.labels(), jm.labels(), err_msg=where)
    for name in ("src", "dst", "valid"):
        np.testing.assert_array_equal(
            getattr(tm, name).numpy(), np.asarray(getattr(jm, name)),
            err_msg=f"{where} {name}")
    assert int(tm.n_edges) == int(jm.n_edges), where
    assert tm.capacity == jm.capacity, where
    assert tm.edge_slot == jm.edge_slot, where
    if js is not None:
        assert ts._fields == js._fields
        for f in js._fields:
            assert int(getattr(ts, f)) == int(getattr(js, f)), f"{where} {f}"


def _live_csr(m):
    return build_csr(m.n, np.asarray(sorted(m.edge_slot),
                                     dtype=np.int64).reshape(-1, 2))


@contextlib.contextmanager
def _quiet():
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="Some donated buffers")
        yield


STREAMS = {
    "mixed": lambda g, s: mixed_stream(g, 6, 48, seed=s),
    "churn": lambda g, s: churn_stream(g, 6, 48, same_batch_roundtrip=True,
                                       dirty=True, seed=s),
}


@pytest.mark.parametrize("seed", [5, 9])
@pytest.mark.parametrize("tight", [False, True], ids=["roomy", "compacts"])
@pytest.mark.parametrize("stream", sorted(STREAMS))
def test_apply_batch_matches_reference(stream, tight, seed):
    """``compacts`` starts with headroom for 20 edges, less than one
    batch, so the host path reclaims its tombstones by ``_compact``
    inside the insert call. The port's unified engine rides along and
    must agree on cores and labels."""
    g = erdos_renyi(N, M, seed=seed)
    capacity = g.m + 20 if tight else None
    jm = JaxMaintainer.from_graph(g, capacity=capacity, engine="host")
    tm = _port(g, capacity=capacity, engine="host")
    um = _port(g, capacity=capacity)
    assert tm.kernel_backend == "torch"
    _assert_same(jm, tm)
    with _quiet():
        for ev in STREAMS[stream](g, seed + 1):
            js = jm.apply_batch(insert_edges=ev.edges,
                                remove_edges=ev.removals)
            ts = tm.apply_batch(insert_edges=ev.edges,
                                remove_edges=ev.removals)
            um.apply_batch(insert_edges=ev.edges, remove_edges=ev.removals)
            _assert_same(jm, tm, js, ts, where=f"t={ev.t}")
            np.testing.assert_array_equal(tm.cores(),
                                          bz_from_csr(_live_csr(jm)))
            np.testing.assert_array_equal(um.cores(), tm.cores())
            np.testing.assert_array_equal(um.labels(), tm.labels())
            assert tm.live_edges == len(tm.edge_slot)


@pytest.mark.parametrize("tight", [False, True], ids=["roomy", "grows"])
def test_single_kind_calls_match_reference(tight):
    """``insert_edges`` / ``remove_edges`` under ``engine="host"`` call
    the host paths directly; their InsertStats / RemoveStats equal the
    reference's. ``grows`` starts with headroom for 8 edges and the
    stream inserts more than it removes, so the table is compacted and
    then grown."""
    g = erdos_renyi(N, M, seed=3)
    capacity = g.m + 8 if tight else None
    jm = JaxMaintainer.from_graph(g, capacity=capacity, engine="host")
    tm = _port(g, capacity=capacity, engine="host")
    with _quiet():
        for ev in synthetic_stream(g, 8, 40, p_insert=0.7, seed=4):
            call = "insert_edges" if ev.kind == "insert" else "remove_edges"
            js = getattr(jm, call)(ev.edges)
            ts = getattr(tm, call)(ev.edges)
            assert type(ts).__name__ == type(js).__name__
            assert [int(x) for x in ts] == [int(x) for x in js], ev.t
            _assert_same(jm, tm, where=f"t={ev.t}")
    if tight:
        assert tm.capacity > g.m + 8  # the table was grown
    np.testing.assert_array_equal(tm.cores(), bz_from_csr(_live_csr(jm)))


def test_midbatch_compaction_keeps_the_new_slots():
    """The reference's regression (test_unified_engine.py): when
    ``_compact`` fires inside the host insert, the new edges land in the
    POST-compaction ``edge_slot`` dict, so later removals see them."""
    g = erdos_renyi(40, 100, seed=13)
    jm = JaxMaintainer.from_graph(g, capacity=g.m + 10, engine="host")
    tm = _port(g, capacity=g.m + 10, engine="host")
    rng = np.random.default_rng(7)
    edges = g.edge_array()
    rm = edges[rng.choice(edges.shape[0], size=15, replace=False)]
    cur = remove_edges_csr(g, rm)
    ins = sample_absent(cur, rng, 18)  # forces _compact mid-insert
    with _quiet():
        for m in (jm, tm):
            m.remove_edges(rm)  # tombstones eat the headroom
            m.insert_edges(ins)
        _assert_same(jm, tm)
        assert int(tm.n_edges) == cur.m + len(ins)  # packed, then bumped
        cur = add_edges_csr(cur, ins)
        for a, b in ins:
            assert (int(a), int(b)) in tm.edge_slot
        js, ts = jm.remove_edges(ins[:3]), tm.remove_edges(ins[:3])
    assert [int(x) for x in ts] == [int(x) for x in js]
    assert int(ts.rounds) > 0
    cur = remove_edges_csr(cur, ins[:3])
    np.testing.assert_array_equal(tm.cores(), bz_from_csr(cur))
    assert tm.live_edges == cur.m
    _assert_same(jm, tm)


@pytest.mark.parametrize("half", ["insert", "remove"])
def test_forced_renumber_matches_reference(half):
    """Labels shifted out of headroom (as ``test_in_program_renumber_gate``
    does): the host path's gate renumbers after the call that finds them
    so (``insert``: an insert-only batch, whose labels end evenly
    spaced; ``remove``: a mixed batch, renumbered after its removal
    half) and reports it in ``stats.renumbered``, in both packages
    alike."""
    g = erdos_renyi(40, 160, seed=7)
    jm = JaxMaintainer.from_graph(g, capacity=1024, engine="host")
    tm = _port(g, capacity=1024, engine="host")
    rng = np.random.default_rng(3)
    with _quiet():
        ins = sample_absent(g, rng, 4)
        js, ts = jm.apply_batch(insert_edges=ins), tm.apply_batch(
            insert_edges=ins)
        assert not bool(ts.renumbered)
        _assert_same(jm, tm, js, ts)
        jm.label = jm.label - (jnp.int64(1) << 61) - 1
        tm.label = tm.label - (1 << 61) - 1
        assert bool(needs_renumber(tm.label))
        ins = sample_absent(build_csr(tm.n, np.asarray(sorted(tm.edge_slot))),
                            rng, 4)
        rm = np.asarray(sorted(tm.edge_slot)[:2]) if half == "remove" \
            else None
        js = jm.apply_batch(insert_edges=ins, remove_edges=rm)
        ts = tm.apply_batch(insert_edges=ins, remove_edges=rm)
    assert bool(ts.renumbered)
    _assert_same(jm, tm, js, ts)
    assert not bool(needs_renumber(tm.label))
    if half == "insert":
        diffs = np.diff(np.sort(tm.labels()))
        assert (diffs == LABEL_GAP).all()


def test_mixed_batch_rejected_whole():
    """One bad insert and one valid removal: both packages raise and
    neither commits the removal (the host path removes first, so both
    lists are validated before any state changes)."""
    g = erdos_renyi(50, 150, seed=7)
    jm = JaxMaintainer.from_graph(g, engine="host")
    tm = _port(g, engine="host")
    before = tm.state()
    rm = g.edge_array()[:1]
    for m in (jm, tm):
        with pytest.raises(ValueError, match="out of range"):
            m.apply_batch(insert_edges=[[1, 2], [3, 50]], remove_edges=rm)
    _assert_same(jm, tm)
    for k, v in tm.state().items():
        np.testing.assert_array_equal(v, before[k], err_msg=k)
    assert tuple(rm[0]) in tm.edge_slot


def test_validate_false_drops_rows():
    g = erdos_renyi(50, 150, seed=7)
    jm = JaxMaintainer.from_graph(g, engine="host", validate=False)
    tm = _port(g, engine="host", validate=False)
    bad = np.array([[1, 2], [3, 50], [-1, 4], [5, 5]])
    rm = np.concatenate([g.edge_array()[:3], [[0, 77]]])
    with _quiet():
        js = jm.apply_batch(insert_edges=bad, remove_edges=rm)
    ts = tm.apply_batch(insert_edges=bad, remove_edges=rm)
    _assert_same(jm, tm, js, ts)
    assert int(ts.n_inserted) == 1 and int(ts.n_removed) == 3


def test_host_path_calls_no_kernel_wrapper(monkeypatch):
    """Under ``engine="host"`` no statistic goes through the kernel
    wrappers of ``kernels/coremaint.py``: the host path runs plain
    PyTorch on every device, as the reference's host path runs lax."""
    def refuse(*a, **kw):
        raise AssertionError("the host path reached a kernel wrapper")

    for name in ("coo_stat", "fused_removal_round",
                 "fused_promotion_stats"):
        monkeypatch.setattr(coremaint, name, refuse)
    g = erdos_renyi(N, M, seed=2)
    tm = _port(g, engine="host")
    for ev in mixed_stream(g, 3, 48, seed=3):
        tm.apply_batch(insert_edges=ev.edges, remove_edges=ev.removals)
    np.testing.assert_array_equal(tm.cores(), bz_from_csr(_live_csr(tm)))


@pytest.mark.parametrize("direction", ["host_to_unified", "unified_to_host"])
def test_checkpoints_across_packages_and_engines(tmp_path, direction):
    """A checkpoint saved by one package under one engine loads in the
    other package under the other engine, and back: the host engine
    raises the saved ``n_edges`` (a live count when unified saved it) to
    the slot high-water mark, its bump pointer."""
    first, second = (("host", "unified") if direction == "host_to_unified"
                     else ("unified", "host"))
    g = erdos_renyi(N, M, seed=4)
    events = list(churn_stream(g, 6, 40, seed=9))
    jm = JaxMaintainer.from_graph(g, engine=first)
    tm = _port(g, engine=first)
    with _quiet():
        for ev in events[:3]:
            jm.apply_batch(insert_edges=ev.edges, remove_edges=ev.removals)
            tm.apply_batch(insert_edges=ev.edges, remove_edges=ev.removals)
        _assert_same(jm, tm)
        tm.save(tmp_path / "port.npz")
        jm.save(tmp_path / "ref.npz")
        with np.load(tmp_path / "port.npz") as a, \
                np.load(tmp_path / "ref.npz") as b:
            assert sorted(a.files) == sorted(b.files)
            for k in a.files:
                assert a[k].dtype == b[k].dtype, k
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        # each package loads the other's checkpoint under the other engine
        jm2 = JaxMaintainer.load(str(tmp_path / "port.npz"), engine=second)
        tm2 = CoreMaintainer.load(tmp_path / "ref.npz", device="cpu",
                                  engine=second)
        _assert_same(jm2, tm2)
        if second == "host":
            live = np.nonzero(np.asarray(jm.valid))[0]
            assert int(tm2.n_edges) == live[-1] + 1
        for ev in events[3:]:
            js = jm2.apply_batch(insert_edges=ev.edges,
                                 remove_edges=ev.removals)
            ts = tm2.apply_batch(insert_edges=ev.edges,
                                 remove_edges=ev.removals)
            _assert_same(jm2, tm2, js, ts, where=f"t={ev.t}")
        # and back to the first engine, across the packages again
        tm2.save(tmp_path / "port2.npz")
        jm2.save(tmp_path / "ref2.npz")
        jm3 = JaxMaintainer.load(str(tmp_path / "port2.npz"), engine=first)
        tm3 = CoreMaintainer.load(tmp_path / "ref2.npz", device="cpu",
                                  engine=first)
        _assert_same(jm3, tm3)
        ev = next(mixed_stream(build_csr(g.n, np.asarray(
            sorted(tm3.edge_slot))), 1, 40, seed=10))
        js = jm3.apply_batch(insert_edges=ev.edges, remove_edges=ev.removals)
        ts = tm3.apply_batch(insert_edges=ev.edges, remove_edges=ev.removals)
    _assert_same(jm3, tm3, js, ts)
    np.testing.assert_array_equal(tm3.cores(), bz_from_csr(_live_csr(jm3)))


def _tables(seed: int, cap: int = 64, n: int = 20, m: int = 30):
    rng = np.random.default_rng(seed)
    src = np.zeros(cap, np.int32)
    dst = np.zeros(cap, np.int32)
    valid = np.zeros(cap, bool)
    e = build_csr(n, rng.integers(0, n, (m, 2))).edge_array()
    src[: len(e)], dst[: len(e)], valid[: len(e)] = e[:, 0], e[:, 1], True
    return n, len(e), src, dst, valid


def test_write_edge_slots_matches_reference():
    """Padding lanes (new_ok=False) leave the table as the reference's
    parking on the last slot leaves it."""
    n, m, src, dst, valid = _tables(1)
    new_src = np.array([3, 0, 7, 5, 0, 9, 0, 0], np.int32)
    new_dst = np.array([4, 0, 8, 6, 0, 11, 0, 0], np.int32)
    new_ok = np.array([1, 0, 1, 1, 0, 1, 0, 0], bool)
    want = jax_insert.write_edge_slots(
        jnp.asarray(src), jnp.asarray(dst), jnp.asarray(valid),
        jnp.int32(m), jnp.asarray(new_src), jnp.asarray(new_dst),
        jnp.asarray(new_ok))
    got = port_insert.write_edge_slots(
        torch.from_numpy(src), torch.from_numpy(dst),
        torch.from_numpy(valid), torch.tensor(m, dtype=torch.int32),
        torch.from_numpy(new_src), torch.from_numpy(new_dst),
        torch.from_numpy(new_ok))
    for w, t in zip(want, got):
        np.testing.assert_array_equal(t.numpy(), np.asarray(w))
    assert int(got[3]) == m + 4


def test_insert_and_remove_batch_match_reference():
    """The device halves of the host path on the same tables: a removal
    whose -1 padding collides with a real removal of slot 0, then an
    insertion with padded lanes."""
    from repro.core.decomposition import peel_decomposition as jax_peel
    from repro.core.decomposition import rank_to_labels
    n, m, src, dst, valid = _tables(2)
    core, rank = jax_peel(jnp.asarray(src), jnp.asarray(dst),
                          jnp.asarray(valid), n)
    label = np.array(rank_to_labels(rank))
    core = np.array(core)
    slots = np.array([0, 5, 2, -1, -1, -1, -1, -1], np.int32)
    jr = jax_remove.remove_batch(
        jnp.asarray(src), jnp.asarray(dst), jnp.asarray(valid),
        jnp.asarray(core), jnp.asarray(label), jnp.asarray(slots), n, n + 2)
    tr = port_remove.remove_batch(
        torch.from_numpy(src), torch.from_numpy(dst),
        torch.from_numpy(valid), torch.from_numpy(core),
        torch.from_numpy(label), torch.from_numpy(slots), n, n + 2)
    for w, t in zip(jr[:3], tr[:3]):
        np.testing.assert_array_equal(t.numpy(), np.asarray(w))
    assert [int(x) for x in tr[3]] == [int(x) for x in jr[3]]
    assert not tr[0][0] and not tr[0][5] and not tr[0][2]
    assert int(tr[0].sum()) == m - 3
    valid2, core2, label2 = (np.array(x) for x in jr[:3])
    new_src = np.array([1, 4, 0, 0], np.int32)
    new_dst = np.array([17, 9, 0, 0], np.int32)
    new_ok = np.array([1, 1, 0, 0], bool)
    ji = jax_insert.insert_batch(
        jnp.asarray(src), jnp.asarray(dst), jnp.asarray(valid2),
        jnp.asarray(core2), jnp.asarray(label2), jnp.asarray(new_src),
        jnp.asarray(new_dst), jnp.asarray(new_ok), jnp.int32(m), n, n + 2)
    ti = port_insert.insert_batch(
        torch.from_numpy(src), torch.from_numpy(dst),
        torch.from_numpy(valid2), torch.from_numpy(core2),
        torch.from_numpy(label2), torch.from_numpy(new_src),
        torch.from_numpy(new_dst), torch.from_numpy(new_ok),
        torch.tensor(m, dtype=torch.int32), n, n + 2)
    for w, t in zip(ji[:6], ti[:6]):
        np.testing.assert_array_equal(t.numpy(), np.asarray(w))
    assert [int(x) for x in ti[6]] == [int(x) for x in ji[6]]
