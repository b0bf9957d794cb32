"""The port's core-maintenance kernels (src/repro_torch/kernels/coremaint.py)
against the reference's Pallas kernels run in interpret mode, bit for bit
(tolerance 0: every statistic is an integer count or an integer weight
sum).

On the CPU the port's wrappers run their plain PyTorch versions;
tests/test_torch_gpu.py holds the CUDA kernels to those plain versions
on the card."""
import numpy as np
import pytest
import torch

pytest.importorskip("jax", reason="the reference package runs on jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import coremaint as ref
from repro_torch.kernels import build
from repro_torch.kernels import coremaint as K

UNIT_STATS = ("mcd_hi_dout", "hi_dout", "mcd", "din", "same_in")


def _window(n, e, seed, oor=()):
    """A random slot window: live slots, tombstones (dead slots that kept
    their endpoints) and masked padding (dead, endpoints 0); ``oor``
    endpoints are planted on live slots."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, size=e).astype(np.int32)
    dst = rng.integers(0, n, size=e).astype(np.int32)
    valid = rng.random(e) < 0.8
    pad = rng.random(e) < 0.1
    src[pad] = 0
    dst[pad] = 0
    valid[pad] = False
    for i, v in enumerate(oor):
        (src if i % 2 else dst)[3 * i] = v
        valid[3 * i] = True
    core = rng.integers(0, 5, size=n).astype(np.int32)
    label = (rng.permutation(n).astype(np.int64) - n // 2) << 20
    aux = rng.random(n) < 0.5
    return src, dst, valid, core, label, aux


def _ref(fn, arrays, *a, **kw):
    return fn(*(jnp.asarray(x) for x in arrays), *a, interpret=True, **kw)


def _port(fn, arrays, *a, **kw):
    return fn(*(torch.from_numpy(x) for x in arrays), *a, **kw)


def _eq(got, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("stat", UNIT_STATS)
@pytest.mark.parametrize("n,e", [(300, 512), (300, 700), (37, 5)])
def test_coo_stat_matches_pallas(stat, n, e):
    src, dst, valid, core, label, aux = _window(n, e, seed=n + e)
    a = aux if stat in ("din", "same_in") else None
    want = ref.coo_stat(*(jnp.asarray(x) for x in (src, dst, valid, core,
                                                   label)), n, stat=stat,
                        aux=None if a is None else jnp.asarray(a),
                        interpret=True)
    got = K.coo_stat(*(torch.from_numpy(x) for x in (src, dst, valid, core,
                                                     label)), n, stat=stat,
                     aux=None if a is None else torch.from_numpy(a))
    assert got.dtype == torch.int32 and got.shape == want.shape
    _eq(got, want)


@pytest.mark.parametrize("n,e", [(300, 512), (300, 700)])
def test_fused_removal_round_matches_pallas(n, e):
    arrays = _window(n, e, seed=e)[:5]
    want = _ref(ref.fused_removal_round, arrays, n)
    got = _port(K.fused_removal_round, arrays, n)
    for g_, w_ in zip(got, want):
        _eq(g_, w_)
    assert got[4].dtype == torch.bool


@pytest.mark.parametrize("n,e", [(300, 512), (300, 700)])
def test_fused_promotion_stats_matches_pallas(n, e):
    arrays = _window(n, e, seed=e + 1)[:5]
    want = _ref(ref.fused_promotion_stats, arrays, n)
    got = _port(K.fused_promotion_stats, arrays, n)
    for g_, w_ in zip(got, want):
        _eq(g_, w_)
    assert got[2].dtype == torch.bool


@pytest.mark.parametrize("stat", UNIT_STATS)
def test_out_of_range_endpoints_match_pallas(stat):
    """Endpoints outside [0, n) read as jnp.take(fill_value=0) reads them
    (a negative index wraps once) and their scatter is dropped."""
    n = 40
    src, dst, valid, core, label, aux = _window(
        n, 300, seed=5, oor=(n, n + 7, -1, -n, 10 * n, -3 * n))
    arrays = (src, dst, valid, core, label)
    want = ref.coo_stat(*(jnp.asarray(x) for x in arrays), n, stat=stat,
                        aux=jnp.asarray(aux), interpret=True)
    got = K.coo_stat(*(torch.from_numpy(x) for x in arrays), n, stat=stat,
                     aux=torch.from_numpy(aux))
    _eq(got, want)


@pytest.mark.parametrize("fn", ["coo_stat", "fused_removal_round",
                                "fused_promotion_stats"])
@pytest.mark.parametrize("n,e", [(0, 16), (10, 0)])
def test_empty_window_or_no_vertices(fn, n, e):
    src, dst, valid, core, label, _ = _window(max(n, 1), e, seed=1)
    arrays = (src, dst, valid, core[:n], label[:n])
    want = _ref(getattr(ref, fn), arrays, n)
    got = _port(getattr(K, fn), arrays, n)
    for g_, w_ in zip(got if fn != "coo_stat" else (got,),
                      want if fn != "coo_stat" else (want,)):
        assert tuple(g_.shape) == tuple(w_.shape)
        _eq(g_, w_)


@pytest.mark.parametrize("fn", ["coo_stat", "fused_removal_round",
                                "fused_promotion_stats"])
def test_int32_label_raises_type_error(fn):
    src, dst, valid, core, label, _ = _window(20, 64, seed=2)
    arrays = (src, dst, valid, core, label.astype(np.int32))
    with pytest.raises(TypeError):
        _ref(getattr(ref, fn), arrays, 20)
    with pytest.raises(TypeError):
        _port(getattr(K, fn), arrays, 20)


@pytest.mark.parametrize("stat", ["mcd", "same_in"])
def test_label_free_stats_take_no_label(stat):
    """The stats whose predicates read no label take ``label=None`` and
    match the reference run with labels."""
    src, dst, valid, core, label, aux = _window(300, 700, seed=6)
    a = aux if stat == "same_in" else None
    want = ref.coo_stat(*(jnp.asarray(x) for x in (src, dst, valid, core,
                                                   label)), 300, stat=stat,
                        aux=None if a is None else jnp.asarray(a),
                        interpret=True)
    got = K.coo_stat(*(torch.from_numpy(x) for x in (src, dst, valid, core)),
                     None, 300, stat=stat,
                     aux=None if a is None else torch.from_numpy(a))
    _eq(got, want)


@pytest.mark.parametrize("stat", ["mcd_hi_dout", "hi_dout", "din"])
def test_label_stats_raise_without_label(stat):
    src, dst, valid, core, _, aux = _window(20, 64, seed=7)
    with pytest.raises(TypeError):
        K.coo_stat(*(torch.from_numpy(x) for x in (src, dst, valid, core)),
                   None, 20, stat=stat, aux=torch.from_numpy(aux))


def test_unknown_stat_raises_key_error():
    arrays = _window(20, 64, seed=3)[:5]
    with pytest.raises(KeyError):
        _ref(ref.coo_stat, arrays, 20, stat="nope")
    with pytest.raises(KeyError):
        _port(K.coo_stat, arrays, 20, stat="nope")
    # "wsum" is a known stat that needs edge_w and aux
    with pytest.raises(ValueError, match="edge_w"):
        _ref(ref.coo_stat, arrays, 20, stat="wsum")
    with pytest.raises(ValueError, match="edge_w"):
        _port(K.coo_stat, arrays, 20, stat="wsum")


def _wsum_inputs(n, e, seed, oor=()):
    """A window with int32 weights 1-5 and int32 thresholds 0-7 (the
    cores are 0-4, so the predicate falls on both sides)."""
    src, dst, valid, core, label, _ = _window(n, e, seed, oor)
    rng = np.random.default_rng(seed + 1)
    w = rng.integers(1, 6, size=e).astype(np.int32)
    thresh = rng.integers(0, 8, size=n).astype(np.int32)
    return src, dst, valid, core, label, w, thresh


def _wsum_both(src, dst, valid, core, label, w, thresh, n, **kw):
    j = lambda x: None if x is None else jnp.asarray(x)  # noqa: E731
    t = lambda x: None if x is None else torch.from_numpy(x)  # noqa: E731
    want = ref.coo_stat(j(src), j(dst), j(valid), j(core), j(label), n,
                        stat="wsum", aux=j(thresh), edge_w=j(w),
                        interpret=True)
    got = K.coo_stat(t(src), t(dst), t(valid), t(core), None, n,
                     stat="wsum", aux=t(thresh), edge_w=t(w), **kw)
    return got, want


@pytest.mark.parametrize("n,e", [(300, 512), (300, 700), (37, 5)])
def test_wsum_matches_pallas(n, e):
    arrays = _wsum_inputs(n, e, seed=n * e)
    got, want = _wsum_both(*arrays, n)
    assert got.dtype == torch.int32 and got.shape == want.shape == (n, 1)
    _eq(got, want)
    src, dst, valid, core, _, w, thresh = (torch.from_numpy(x)
                                           for x in arrays)
    _eq(K.wsum_plain(src, dst, valid, w, core, thresh, n), want)


def test_wsum_out_of_range_endpoints_match_pallas():
    """A gather index in [-n, 0) wraps once, any other outside [0, n)
    reads 0, and the scatter to an endpoint outside [0, n) is dropped."""
    n = 40
    got, want = _wsum_both(*_wsum_inputs(
        n, 300, seed=5, oor=(n, n + 7, -1, -n, 10 * n, -3 * n)), n)
    _eq(got, want)


@pytest.mark.parametrize("n,e", [(0, 16), (10, 0)])
def test_wsum_empty_window_or_no_vertices(n, e):
    src, dst, valid, core, label, w, thresh = _wsum_inputs(max(n, 1), e, 1)
    got, want = _wsum_both(src, dst, valid, core[:n], label[:n], w,
                           thresh[:n], n)
    assert tuple(got.shape) == tuple(want.shape) == (n, 1)
    _eq(got, want)


@pytest.mark.parametrize("missing", ["edge_w", "aux"])
def test_wsum_without_inputs_raises_value_error(missing):
    src, dst, valid, core, label, w, thresh = _wsum_inputs(30, 64, 2)
    kw = dict(edge_w=w, aux=thresh)
    kw[missing] = None
    j = {k: None if v is None else jnp.asarray(v) for k, v in kw.items()}
    t = {k: None if v is None else torch.from_numpy(v)
         for k, v in kw.items()}
    with pytest.raises(ValueError, match="edge_w"):
        ref.coo_stat(*(jnp.asarray(x) for x in (src, dst, valid, core,
                                                label)), 30, stat="wsum",
                     interpret=True, **j)
    with pytest.raises(ValueError, match="edge_w"):
        K.coo_stat(*(torch.from_numpy(x) for x in (src, dst, valid, core,
                                                   label)), 30, stat="wsum",
                   **t)


def test_wsum_unit_weights_at_core_is_mcd():
    """With unit weights and ``thresh == core`` the weighted support is
    the mcd count."""
    src, dst, valid, core, label, w, _ = _wsum_inputs(300, 700, 3)
    t = torch.from_numpy
    got = K.coo_stat(t(src), t(dst), t(valid), t(core), None, 300,
                     stat="wsum", aux=t(core), edge_w=t(np.ones_like(w)))
    mcd = K.coo_stat(t(src), t(dst), t(valid), t(core), None, 300,
                     stat="mcd")
    assert torch.equal(got, mcd)


def _run_inputs(n, e, seed, shuffle):
    """The windows the card's run-folding kernels are tested on, small:
    sorted by src, one hub run of ``e // 3`` slots, dead slots, zero
    weights, and src and dst outside [0, n) inside runs; ``shuffle`` puts
    the slots in a random order."""
    src, dst, valid, core, label, w, thresh = _wsum_inputs(n, e, seed)
    rng = np.random.default_rng(seed + 2)
    src = np.sort(src)
    src[e // 3: 2 * e // 3] = 3
    src = np.sort(src)
    w[rng.random(e) < 0.1] = 0
    bad = np.array([n, n + 5, -1, -n, -3 * n], dtype=np.int32)
    src[rng.choice(e, e // 20, replace=False)] = rng.choice(bad, e // 20)
    dst[rng.choice(e, e // 20, replace=False)] = rng.choice(bad, e // 20)
    if shuffle:
        order = rng.permutation(e)
        src, dst, valid, w = src[order], dst[order], valid[order], w[order]
    return src, dst, valid, core, label, w, thresh


@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("fn", ["wsum", "fused_removal_round",
                                "fused_promotion_stats",
                                *(f"coo_stat[{s}]" for s in UNIT_STATS)])
def test_run_windows_match_pallas(fn, shuffle):
    n = 60
    src, dst, valid, core, label, w, thresh = _run_inputs(n, 700, 11,
                                                          shuffle)
    if fn == "wsum":
        got, want = _wsum_both(src, dst, valid, core, label, w, thresh, n)
        _eq(got, want)
        return
    arrays = (src, dst, valid, core, label)
    if fn.startswith("coo_stat"):
        stat = fn[len("coo_stat["):-1]
        aux = np.random.default_rng(12).random(n) < 0.5
        _eq(K.coo_stat(*(torch.from_numpy(x) for x in arrays), n, stat,
                       torch.from_numpy(aux)),
            ref.coo_stat(*(jnp.asarray(x) for x in arrays), n, stat=stat,
                         aux=jnp.asarray(aux), interpret=True))
        return
    for g_, w_ in zip(_port(getattr(K, fn), arrays, n),
                      _ref(getattr(ref, fn), arrays, n)):
        _eq(g_, w_)


def _run_mask(kind, n, src):
    """The masks ``din`` and ``same_in`` are tested under: none set, the
    vertex with the longest run of slots, about 1% and 50% of the
    vertices at random, all set."""
    rng = np.random.default_rng(13)
    if kind == "hub":
        keys, counts = np.unique(src[(src >= 0) & (src < n)],
                                 return_counts=True)
        mask = np.zeros(n, dtype=bool)
        mask[keys[counts.argmax()]] = True
        return mask
    return {"empty": np.zeros(n, dtype=bool),
            "1%": rng.random(n) < 0.01,
            "50%": rng.random(n) < 0.5,
            "all": np.ones(n, dtype=bool)}[kind]


@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("mask", ["empty", "hub", "1%", "50%", "all"])
@pytest.mark.parametrize("stat", ["din", "same_in"])
def test_masked_stats_match_pallas(stat, mask, shuffle):
    """The mask-gated stats on run windows under masks from empty to
    full (the card's kernel skips the slots that touch no masked
    vertex)."""
    n = 200
    src, dst, valid, core, label, _, _ = _run_inputs(n, 1500, 17, shuffle)
    aux = _run_mask(mask, n, src)
    if mask == "1%":
        assert 0 < aux.sum() < n // 20
    arrays = (src, dst, valid, core, label)
    want = ref.coo_stat(*(jnp.asarray(x) for x in arrays), n, stat=stat,
                        aux=jnp.asarray(aux), interpret=True)
    _eq(K.coo_stat(*(torch.from_numpy(x) for x in arrays), n, stat,
                   torch.from_numpy(aux)), want)
    if mask == "empty":
        assert not np.asarray(want).any()


def test_record_masks_keeps_copies_of_the_masked_calls():
    """``record_masks`` keeps a copy of the mask of every din / same_in
    call inside the block (None for a call without one), and nothing of
    the other stats or of calls outside it."""
    src, dst, valid, core, label, aux = (torch.from_numpy(x) for x in
                                         _window(50, 128, seed=4))
    args = (src, dst, valid, core, label, 50)
    K.coo_stat(*args, "din", aux)
    with K.record_masks() as rec:
        K.coo_stat(*args, "din", aux)
        K.coo_stat(*args, "mcd")
        K.coo_stat(*args, "same_in")
        K.coo_stat(*args, "same_in", aux.to(torch.int32))
        aux.logical_not_()  # the record is a copy
    K.coo_stat(*args, "same_in", aux)
    assert [s for s, _ in rec] == ["din", "same_in", "same_in"]
    assert torch.equal(rec[0][1], ~aux) and rec[1][1] is None
    assert rec[2][1].dtype == torch.int32
    assert torch.equal(rec[2][1].bool(), ~aux)
    assert K._recorded is None


def test_plain_versions_need_no_build():
    """The CPU path never touches nvcc or the CUDA library, and launches
    nothing."""
    before = dict(K.LAUNCHES)
    arrays = _window(50, 128, seed=4)[:5]
    _port(K.fused_removal_round, arrays, 50)
    src, dst, valid, core, _, w, thresh = _wsum_inputs(50, 128, 4)
    K.coo_stat(*(torch.from_numpy(x) for x in (src, dst, valid, core)),
               None, 50, stat="wsum", aux=torch.from_numpy(thresh),
               edge_w=torch.from_numpy(w))
    assert build._lib is None
    assert K.LAUNCHES == before
