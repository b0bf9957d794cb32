"""The port's CUDA kernels on the card: each against its plain PyTorch
version on the same inputs (tolerance 0: integer counts and weight
sums), and the unified maintainer, unweighted and weighted, with
``kernel_backend="cuda"`` against ``kernel_backend="torch"`` and the
BZ / weighted peeling oracle, batch by batch.

Every test here carries the ``gpu`` marker and skips without a CUDA
device; the module imports neither jax nor the reference package, so it
runs on a machine with the card alone:
``python -m pytest -q -m gpu tests/test_torch_gpu.py``."""
import numpy as np
import pytest
import torch

from repro_torch.core.api import CoreMaintainer
from repro_torch.core.oracle import bz_from_csr
from repro_torch.core.weighted import weighted_core_oracle
from repro_torch.graph.csr import build_csr
from repro_torch.graph.generators import erdos_renyi, rmat
from repro_torch.graph.stream import churn_stream, mixed_stream
from repro_torch.kernels import coremaint as K

pytestmark = pytest.mark.gpu

UNIT_STATS = ("mcd_hi_dout", "hi_dout", "mcd", "din", "same_in")


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run on the card only")
    return torch.device("cuda")


def _window(n, e, seed, oor=()):
    """A random slot window on the card: live slots, tombstones, masked
    padding, and ``oor`` endpoints planted on live slots."""
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
    return [torch.from_numpy(x).to(_card())
            for x in (src, dst, valid, core, label, aux)]


@pytest.mark.parametrize("stat", UNIT_STATS)
@pytest.mark.parametrize("n,e", [(1000, 4096), (1 << 16, 1 << 20)])
def test_coo_stat_kernel_matches_plain(stat, n, e):
    src, dst, valid, core, label, aux = _window(n, e, seed=n)
    a = aux if stat in ("din", "same_in") else None
    before = K.LAUNCHES[f"coo_stat[{stat}]"]
    got = K.coo_stat(src, dst, valid, core, label, n, stat, a)
    torch.cuda.synchronize()
    assert K.LAUNCHES[f"coo_stat[{stat}]"] == before + 1
    want = K.coo_stat_plain(src, dst, valid, core, label, n, stat, a)
    assert got.dtype == want.dtype and torch.equal(got, want)


@pytest.mark.parametrize("fn", ["fused_removal_round",
                                "fused_promotion_stats"])
def test_fused_kernels_match_plain(fn):
    n = 5000
    args = _window(n, 1 << 18, seed=9)[:5] + [n]
    before = K.LAUNCHES[fn]
    got = getattr(K, fn)(*args)
    torch.cuda.synchronize()
    assert K.LAUNCHES[fn] == before + 2
    want = getattr(K, fn + "_plain")(*args)
    for g_, w_ in zip(got, want):
        assert g_.dtype == w_.dtype and torch.equal(g_, w_)


@pytest.mark.parametrize("stat", UNIT_STATS)
def test_out_of_range_endpoints_match_plain(stat):
    n = 40
    src, dst, valid, core, label, aux = _window(
        n, 300, seed=5, oor=(n, n + 7, -1, -n, 10 * n, -3 * n))
    got = K.coo_stat(src, dst, valid, core, label, n, stat, aux)
    want = K.coo_stat_plain(src, dst, valid, core, label, n, stat, aux)
    assert torch.equal(got, want)


@pytest.mark.parametrize("stat", UNIT_STATS)
@pytest.mark.parametrize("mask_dtype", [torch.int32, torch.uint8])
def test_non_bool_masks_match_plain(stat, mask_dtype):
    """``valid`` and ``aux`` given as integer masks: the wrapper's byte
    copies of both must stay alive until the launch is queued."""
    n = 3000
    src, dst, valid, core, label, aux = _window(n, 1 << 16, seed=8)
    valid = valid.to(mask_dtype) * 3
    aux = aux.to(mask_dtype) * 5
    lab = label if stat in K._LABEL_STATS else None
    got = K.coo_stat(src, dst, valid, core, lab, n, stat, aux)
    want = K.coo_stat_plain(src, dst, valid.bool(), core, label, n, stat,
                            aux.bool())
    assert torch.equal(got, want)


def test_cpu_tensors_never_launch():
    _card()
    before = dict(K.LAUNCHES)
    args = [x.cpu() for x in _window(50, 128, seed=4)[:5]] + [50]
    K.fused_removal_round(*args)
    assert K.LAUNCHES == before


@pytest.mark.parametrize("graph", ["er", "rmat"])
@pytest.mark.parametrize("stream", ["mixed", "churn"])
def test_maintainer_cuda_matches_torch_backend_and_bz(graph, stream):
    _card()
    g = (erdos_renyi(500, 2500, seed=3) if graph == "er"
         else rmat(9, 3000, seed=3))
    events = (mixed_stream(g, 5, 80, seed=4) if stream == "mixed"
              else churn_stream(g, 5, 80, seed=4))
    a = CoreMaintainer.from_graph(g)
    b = CoreMaintainer.from_graph(g, kernel_backend="torch")
    assert (a.device.type, a.kernel_backend) == ("cuda", "cuda")
    K.reset_launches()
    for ev in events:
        sa = a.apply_batch(insert_edges=ev.edges, remove_edges=ev.removals)
        sb = b.apply_batch(insert_edges=ev.edges, remove_edges=ev.removals)
        for f in sa._fields:
            assert int(getattr(sa, f)) == int(getattr(sb, f)), f
        np.testing.assert_array_equal(a.cores(), b.cores())
        np.testing.assert_array_equal(a.labels(), b.labels())
        assert torch.equal(a.valid, b.valid) and torch.equal(a.src, b.src)
        live = np.stack([a.src.cpu().numpy(), a.dst.cpu().numpy()], 1)
        cur = build_csr(g.n, live[a.valid.cpu().numpy()])
        np.testing.assert_array_equal(a.cores(), bz_from_csr(cur))
    for k in ("fused_removal_round", "fused_promotion_stats",
              "coo_stat[din]", "coo_stat[same_in]"):
        assert K.LAUNCHES[k] > 0, k


def _wsum_window(n, e, seed, oor=()):
    src, dst, valid, core, _, _ = _window(n, e, seed, oor)
    rng = np.random.default_rng(seed + 1)
    w = torch.from_numpy(rng.integers(1, 6, e).astype(np.int32)).to(_card())
    thresh = torch.from_numpy(
        rng.integers(0, 8, n).astype(np.int32)).to(_card())
    return src, dst, valid, w, core, thresh


def _wsum(src, dst, valid, w, core, thresh, n):
    return K.coo_stat(src, dst, valid, core, None, n, stat="wsum",
                      aux=thresh, edge_w=w)


@pytest.mark.parametrize("n,e", [(1000, 4096), (1 << 16, 1 << 20)])
def test_wsum_kernel_matches_plain(n, e):
    args = _wsum_window(n, e, seed=n)
    before = K.LAUNCHES["coo_stat[wsum]"]
    got = _wsum(*args, n)
    torch.cuda.synchronize()
    assert K.LAUNCHES["coo_stat[wsum]"] == before + 1
    want = K.wsum_plain(*args, n)
    assert got.dtype == want.dtype == torch.int32
    assert got.shape == (n, 1) and torch.equal(got, want)


def test_wsum_out_of_range_endpoints_match_plain():
    n = 40
    args = _wsum_window(n, 300, seed=5, oor=(n, n + 7, -1, -n, 10 * n,
                                             -3 * n))
    assert torch.equal(_wsum(*args, n), K.wsum_plain(*args, n))


@pytest.mark.parametrize("dtype", [torch.int32, torch.uint8, torch.int64])
def test_wsum_non_bool_inputs_match_plain(dtype):
    """``valid`` as an integer mask, weights and thresholds in another
    integer type: the wrapper's converted copies must stay alive until
    the launch is queued."""
    n = 3000
    src, dst, valid, w, core, thresh = _wsum_window(n, 1 << 16, seed=8)
    valid = valid.to(dtype) * 3
    got = _wsum(src, dst, valid, w.to(dtype), core, thresh.to(torch.int64),
                n)
    want = K.wsum_plain(src, dst, valid.bool(), w, core, thresh, n)
    assert torch.equal(got, want)


def test_wsum_non_contiguous_inputs_raise():
    """The kernel takes contiguous tensors and the wrapper raises on
    strided ones; their contiguous copies match the plain version run
    on the strided views."""
    n = 500
    src, dst, valid, w, core, thresh = _wsum_window(n, 1 << 12, seed=9)
    strided = (src[::2], dst[::2], valid[::2], w[::2])
    with pytest.raises(ValueError, match="contiguous"):
        _wsum(*strided, core, thresh, n)
    with pytest.raises(ValueError, match="contiguous"):
        _wsum(src, dst, valid, torch.stack([w, w], 1)[:, 0], core, thresh,
              n)
    got = _wsum(*(x.contiguous() for x in strided), core, thresh, n)
    assert torch.equal(got, K.wsum_plain(*strided, core, thresh, n))


@pytest.mark.parametrize("graph", ["er", "rmat"])
@pytest.mark.parametrize("stream", ["mixed", "churn"])
def test_weighted_maintainer_cuda_matches_torch_backend_and_oracle(graph,
                                                                  stream):
    _card()
    g = (erdos_renyi(400, 2000, seed=3) if graph == "er"
         else rmat(9, 2500, seed=3))
    rng = np.random.default_rng(5)
    w0 = rng.integers(1, 6, g.m)
    events = (mixed_stream(g, 4, 60, seed=4) if stream == "mixed"
              else churn_stream(g, 4, 60, seed=4))
    a = CoreMaintainer.from_graph(g, weighted=True, weights=w0)
    b = CoreMaintainer.from_graph(g, weighted=True, weights=w0,
                                  kernel_backend="torch")
    assert (a.device.type, a.kernel_backend) == ("cuda", "cuda")
    live = {tuple(e): int(w) for e, w in zip(g.edge_array().tolist(), w0)}
    K.reset_launches()
    for ev in events:
        iw = rng.integers(1, 6, len(ev.edges))
        sa = a.apply_batch(insert_edges=ev.edges, remove_edges=ev.removals,
                           insert_weights=iw)
        sb = b.apply_batch(insert_edges=ev.edges, remove_edges=ev.removals,
                           insert_weights=iw)
        for f in sa._fields:
            assert int(getattr(sa, f)) == int(getattr(sb, f)), f
        for name in ("core", "label", "src", "valid", "w"):
            assert torch.equal(getattr(a, name), getattr(b, name)), name
        for e in np.asarray(ev.removals).reshape(-1, 2).tolist():
            live.pop((min(e), max(e)), None)
        for e, wt in zip(np.asarray(ev.edges).reshape(-1, 2).tolist(), iw):
            key = (min(e), max(e))
            if key[0] != key[1] and key not in live:
                live[key] = int(wt)
        edges = np.asarray(sorted(live), dtype=np.int64)
        want = weighted_core_oracle(g.n, edges,
                                    [live[k] for k in sorted(live)])
        np.testing.assert_array_equal(a.cores(), want)
    assert K.LAUNCHES["coo_stat[wsum]"] > 0
    assert K.LAUNCHES["fused_removal_round"] == 0


def test_cpu_tensors_never_launch_wsum():
    _card()
    before = dict(K.LAUNCHES)
    args = [x.cpu() for x in _wsum_window(50, 128, seed=4)]
    _wsum(*args, 50)
    assert K.LAUNCHES == before
