"""The unified engine's helpers and batch program in the port
(src/repro_torch/core/engine.py, insert.py) against the reference, bit for
bit — including the slot chosen for each insert lane."""
import warnings

import numpy as np
import pytest
import torch

pytest.importorskip("jax", reason="the reference package runs on jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import engine as jeng
from repro.core import insert as jins
from repro_torch.core import engine as teng
from repro_torch.core import insert as tins


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _table(n, cap, seed, live_frac=0.6):
    """A slot table of distinct live edges, tombstones that kept their
    endpoints, and never-used zero slots at the tail."""
    rng = np.random.default_rng(seed)
    keys = rng.choice(n * n, size=cap, replace=False)
    a, b = keys // n, keys % n
    keep = a != b
    src = np.where(keep, a, 0).astype(np.int32)
    dst = np.where(keep, b, 1).astype(np.int32)
    lo, hi = np.minimum(src, dst), np.maximum(src, dst)
    _, first = np.unique(lo.astype(np.int64) * n + hi, return_index=True)
    valid = np.zeros(cap, bool)
    valid[first] = rng.random(first.shape[0]) < live_frac
    valid[cap - cap // 8:] = False
    src[cap - cap // 8:] = 0
    dst[cap - cap // 8:] = 0
    return src, dst, valid


def _both(*arrays):
    return ([jnp.asarray(x) for x in arrays],
            [torch.from_numpy(np.array(x)) for x in arrays])


@pytest.mark.parametrize("seed", range(3))
def test_table_lookup_matches(seed):
    n, cap = 50, 256
    src, dst, valid = _table(n, cap, seed)
    rng = np.random.default_rng(seed + 10)
    live = np.nonzero(valid)[0]
    dead = np.nonzero(~valid)[0]
    # live keys (both orientations of the table), tombstoned keys, absent
    q_lo = np.concatenate([src[live[:20]], dst[dead[:10]],
                           rng.integers(0, n, 20)])
    q_hi = np.concatenate([dst[live[:20]], src[dead[:10]],
                           rng.integers(0, n, 20)])
    lo, hi = np.minimum(q_lo, q_hi), np.maximum(q_lo, q_hi)
    (j_s, j_d, j_v), (t_s, t_d, t_v) = _both(src, dst, valid)
    jf, js = jeng.table_lookup(j_s, j_d, j_v, n)(
        jeng.edge_key(jnp.asarray(lo), jnp.asarray(hi), n))
    tf, ts = teng.table_lookup(t_s, t_d, t_v, n)(
        teng.edge_key(torch.from_numpy(lo), torch.from_numpy(hi), n))
    np.testing.assert_array_equal(_np(tf), np.asarray(jf))
    np.testing.assert_array_equal(_np(ts), np.asarray(js))
    assert _np(tf)[:20].all() and not _np(tf)[20:30].any()


def test_batch_dedup_matches():
    """Duplicates (either orientation), self-loops and masked lanes: the
    first lane of each duplicate run is kept."""
    n = 30
    u = np.array([1, 2, 5, 2, 7, 7, 3, 9, 1, 4, 0, 0], np.int32)
    v = np.array([2, 1, 5, 1, 8, 8, 4, 9, 2, 3, 0, 0], np.int32)
    ok = np.array([1, 1, 1, 1, 1, 0, 1, 1, 1, 1, 0, 0], bool)
    (ju, jv, jo), (tu, tv, to) = _both(u, v, ok)
    want = jeng.batch_dedup(ju, jv, jo, n)
    got = teng.batch_dedup(tu, tv, to, n)
    for g_, w_ in zip(got, want):
        np.testing.assert_array_equal(_np(g_), np.asarray(w_))
    assert _np(got[2]).tolist() == [1, 0, 0, 0, 1, 0, 1, 0, 0, 0, 0, 0]


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("b", [1, 8, 64])
def test_freelist_alloc_matches(seed, b):
    rng = np.random.default_rng(seed)
    cap = 48
    valid = rng.random(cap) < [0.3, 0.7, 0.95, 1.0][seed]
    iok = rng.random(b) < 0.7
    (jv, jo), (tv, to) = _both(valid, iok)
    jl, jk = jins.freelist_alloc(jv, jo)
    tl, tk = tins.freelist_alloc(tv, to)
    np.testing.assert_array_equal(_np(tl), np.asarray(jl))
    np.testing.assert_array_equal(_np(tk), np.asarray(jk))


def _lanes(u, v, ok):
    return _both(np.asarray(u, np.int32), np.asarray(v, np.int32),
                 np.asarray(ok, bool))


@pytest.mark.parametrize("backends", [("lax", "torch"), ("pallas", "cuda")],
                         ids=["lax", "pallas"])
def test_apply_batch_same_batch_roundtrip(backends):
    """One batch removes live edges, re-inserts one of them, inserts a
    duplicate pair, a self-loop, a live edge and fresh edges: table,
    state and all 12 statistics equal the reference's. The ``cuda``
    dispatch path runs the kernels' plain versions on the CPU."""
    from repro.core.api import CoreMaintainer
    from repro.graph.generators import erdos_renyi

    g = erdos_renyi(60, 200, seed=4)
    jm = CoreMaintainer.from_graph(g, capacity=512)
    edges = g.edge_array()
    rm = edges[[0, 5, 9, 17]]
    ins = np.concatenate([edges[[5]], [[3, 40], [40, 3], [7, 7]],
                          edges[[30]], [[1, 59], [2, 58]]])
    b = 16
    pad = lambda x: np.concatenate([x, np.zeros(b - len(x), x.dtype)])  # noqa
    iu, iv = pad(ins[:, 0]), pad(ins[:, 1])
    iok = np.arange(b) < len(ins)
    ru, rv = pad(rm[:, 0]), pad(rm[:, 1])
    rok = np.arange(b) < len(rm)
    state = (np.asarray(jm.src), np.asarray(jm.dst), np.asarray(jm.valid),
             np.asarray(jm.core), np.asarray(jm.label),
             np.asarray(jm.n_edges))
    (js, jd, jv, jc, jl, jn), (ts, td, tv, tc, tl, tn) = _both(*state)
    (jiu, jiv, jio), (tiu, tiv, tio) = _lanes(iu, iv, iok)
    (jru, jrv, jro), (tru, trv, tro) = _lanes(ru, rv, rok)
    window = 256
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="Some donated buffers")
        want = jeng.apply_batch(js, jd, jv, jc, jl, jn, jiu, jiv, jio, jru,
                                jrv, jro, g.n, g.n + 2, window,
                                kernel_backend=backends[0])
    got = teng.apply_batch(ts, td, tv, tc, tl, tn, tiu, tiv, tio, tru, trv,
                           tro, g.n, g.n + 2, window,
                           kernel_backend=backends[1])
    for g_, w_ in zip(got[:6], want[:6]):
        np.testing.assert_array_equal(_np(g_), np.asarray(w_))
    assert got[0] is ts  # the slot table was updated in place
    for f in teng.BatchStats._fields:
        assert int(getattr(got[6], f)) == int(getattr(want[6], f)), f
    assert int(got[6].n_removed) == 4 and int(got[6].n_inserted) == 3
