"""k-order label maintenance and decomposition of the port
(src/repro_torch/core/order.py, decomposition.py) against the reference,
bit for bit — ties in the sort keys included."""
import numpy as np
import pytest
import torch

pytest.importorskip("jax", reason="the reference package runs on jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import decomposition as jdec
from repro.core import order as jorder
from repro.graph.generators import erdos_renyi, rmat
from repro_torch.core import decomposition as tdec
from repro_torch.core import order as torder


def _state(n, seed, n_core=5, tie_labels=True):
    """Random (core, label, moving, round_key); with ``tie_labels`` the
    labels come from a small set, so the sort keys tie within a level."""
    rng = np.random.default_rng(seed)
    core = rng.integers(0, n_core, size=n).astype(np.int32)
    if tie_labels:
        label = rng.integers(-4, 4, size=n).astype(np.int64) << 20
    else:
        label = (rng.permutation(n).astype(np.int64) - n // 2) << 20
    moving = rng.random(n) < 0.4
    round_key = rng.integers(0, 3, size=n).astype(np.int32)
    return core, label, moving, round_key


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("seed", range(3))
def test_lexsort_matches_jnp(seed):
    core, label, _, rk = _state(200, seed)
    keys = (label, rk, core)
    want = jnp.lexsort(tuple(jnp.asarray(k) for k in keys))
    got = torder.lexsort(tuple(torch.from_numpy(k) for k in keys))
    np.testing.assert_array_equal(_np(got), np.asarray(want))


@pytest.mark.parametrize("fn", ["level_min_labels", "level_max_labels"])
def test_level_extremes_match(fn):
    """Levels with only excluded members read the +-2^62 sentinel, levels
    with no vertex at all the int64 identity — as segment_min/max do."""
    core, label, moving, _ = _state(120, 4)
    n_levels = 8  # levels 5..7 hold no vertex
    want = getattr(jorder, fn)(jnp.asarray(core), jnp.asarray(label),
                               jnp.asarray(moving), n_levels)
    got = getattr(torder, fn)(torch.from_numpy(core), torch.from_numpy(label),
                              torch.from_numpy(moving), n_levels)
    np.testing.assert_array_equal(_np(got), np.asarray(want))


@pytest.mark.parametrize("at_head", [True, False])
@pytest.mark.parametrize("with_round_key", [False, True])
@pytest.mark.parametrize("seed,ties", [(0, True), (1, True), (2, False)])
def test_place_block_matches(at_head, with_round_key, seed, ties):
    n = 257
    core, label, moving, rk = _state(n, seed, tie_labels=ties)
    n_levels = n + 2
    want = jorder.place_block(
        jnp.asarray(core), jnp.asarray(label), jnp.asarray(moving),
        at_head=at_head, n_levels=n_levels,
        round_key=jnp.asarray(rk) if with_round_key else None,
    )
    got = torder.place_block(
        torch.from_numpy(core), torch.from_numpy(label),
        torch.from_numpy(moving), at_head=at_head, n_levels=n_levels,
        round_key=torch.from_numpy(rk) if with_round_key else None,
    )
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(_np(got), np.asarray(want))


def test_place_block_every_vertex_moving():
    """A level whose members all move takes its base label from the
    sentinel (read as 0)."""
    n = 64
    core, label, _, _ = _state(n, 7)
    moving = np.ones(n, dtype=bool)
    for at_head in (True, False):
        want = jorder.place_block(jnp.asarray(core), jnp.asarray(label),
                                  jnp.asarray(moving), at_head, n + 2)
        got = torder.place_block(torch.from_numpy(core),
                                 torch.from_numpy(label),
                                 torch.from_numpy(moving), at_head, n + 2)
        np.testing.assert_array_equal(_np(got), np.asarray(want))


@pytest.mark.parametrize("seed", range(3))
def test_renumber_matches_with_ties(seed):
    core, label, _, _ = _state(300, seed, tie_labels=True)
    want = jorder.renumber(jnp.asarray(core), jnp.asarray(label))
    got = torder.renumber(torch.from_numpy(core), torch.from_numpy(label))
    np.testing.assert_array_equal(_np(got), np.asarray(want))


@pytest.mark.parametrize("shift,force", [(0, None), (61, None), (0, True),
                                         (0, False), (-61, False)])
def test_maybe_renumber_matches(shift, force):
    core, label, _, _ = _state(100, 3, tie_labels=False)
    if shift:  # push one label past the headroom limit
        label = label.copy()
        label[5] = (1 << 61) + 1 if shift > 0 else -(1 << 61) - 1
    jf = None if force is None else jnp.bool_(force)
    tf = None if force is None else torch.tensor(force)
    wl, wn = jorder.maybe_renumber(jnp.asarray(core), jnp.asarray(label), jf)
    gl, gn = torder.maybe_renumber(torch.from_numpy(core),
                                   torch.from_numpy(label), tf)
    np.testing.assert_array_equal(_np(gl), np.asarray(wl))
    assert bool(gn) == bool(wn)
    assert bool(torder.needs_renumber(torch.from_numpy(label))) == bool(
        jorder.needs_renumber(jnp.asarray(label)))


def _coo(g, capacity):
    e = g.edge_array()
    m = e.shape[0]
    src = np.zeros(capacity, np.int32)
    dst = np.zeros(capacity, np.int32)
    val = np.zeros(capacity, bool)
    src[:m], dst[:m], val[:m] = e[:, 0], e[:, 1], True
    val[: m // 10] = False  # tombstones
    return src, dst, val


@pytest.mark.parametrize("g", [erdos_renyi(300, 1500, seed=2),
                               rmat(9, 3000, seed=3)],
                         ids=["er", "rmat"])
def test_decompositions_match(g):
    src, dst, val = _coo(g, 2 * g.m)
    jcore, jrank = jdec.peel_decomposition(
        jnp.asarray(src), jnp.asarray(dst), jnp.asarray(val), g.n)
    tsrc, tdst, tval = (torch.from_numpy(x) for x in (src, dst, val))
    tcore, trank = tdec.peel_decomposition(tsrc, tdst, tval, g.n)
    np.testing.assert_array_equal(_np(tcore), np.asarray(jcore))
    np.testing.assert_array_equal(_np(trank), np.asarray(jrank))
    np.testing.assert_array_equal(
        _np(tdec.rank_to_labels(trank)),
        np.asarray(jdec.rank_to_labels(jrank)))
    hcore = tdec.h_index_decomposition(tsrc, tdst, tval, g.n)
    np.testing.assert_array_equal(
        _np(hcore),
        np.asarray(jdec.h_index_decomposition(
            jnp.asarray(src), jnp.asarray(dst), jnp.asarray(val), g.n)))
