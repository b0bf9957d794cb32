"""The port's CUDA kernels on the card: each against its plain PyTorch
version on the same inputs (tolerance 0 for integer counts and weight
sums and for ``ell_stat``; the float kernels' tolerances are stated at
each test), the unified maintainer, unweighted and weighted, with
``kernel_backend="cuda"`` against ``kernel_backend="torch"`` and the
BZ / weighted peeling oracle, batch by batch, the host engine on the
card against the unified engine and against itself on the CPU, the
sharded engine (replicated and range vertex state) on a world of one
NCCL rank against the torch backend and the unified engine, and DeepFM serving with the FM kernel against its
plain branch.

Every test here carries the ``gpu`` marker and skips without a CUDA
device; the module imports neither jax nor the reference package, so it
runs on a machine with the card alone:
``python -m pytest -q -m gpu tests/test_torch_gpu.py``."""
import dataclasses
import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from repro_torch.core.api import CoreMaintainer
from repro_torch.core.oracle import bz_from_csr
from repro_torch.core.weighted import weighted_core_oracle
from repro_torch.graph.csr import build_csr
from repro_torch.graph.generators import erdos_renyi, rmat
from repro_torch.graph.stream import churn_stream, mixed_stream
from repro_torch.configs import deepfm as deepfm_cfg
from repro_torch.kernels import build as build_lib
from repro_torch.kernels import coremaint as K
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import fm_interaction as FM
from repro_torch.kernels import ops
from repro_torch.kernels import segment_ell as SE
from repro_torch.models import recsys

pytestmark = pytest.mark.gpu

UNIT_STATS = ("mcd_hi_dout", "hi_dout", "mcd", "din", "same_in")
# the dtype part of a launch counter's key (one counter per instance)
TAG = {torch.int32: "i32", torch.int64: "i64", torch.float32: "f32",
       torch.bfloat16: "bf16"}


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
    # din and same_in pack their mask first: two launches
    assert K.LAUNCHES[f"coo_stat[{stat}]"] == before + 1 + (
        stat in K._MASK_STATS)
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


@pytest.mark.parametrize("graph", ["er", "rmat"])
@pytest.mark.parametrize("stream", ["mixed", "churn"])
def test_host_engine_on_card_matches_unified_and_cpu(graph, stream):
    """``engine="host"`` on the card: cores and labels equal to the
    unified engine's with the kernels, the whole state (slot table, bump
    pointer, capacity, ``edge_slot``, 12 statistics) equal to the host
    engine on the CPU, the cores to BZ, and no kernel launched. The
    table starts with 40 free slots, so the host path compacts."""
    _card()
    g = (erdos_renyi(500, 2500, seed=3) if graph == "er"
         else rmat(9, 3000, seed=3))
    events = (mixed_stream(g, 5, 80, seed=4) if stream == "mixed"
              else churn_stream(g, 5, 80, seed=4))
    h = CoreMaintainer.from_graph(g, engine="host", capacity=g.m + 40)
    c = CoreMaintainer.from_graph(g, engine="host", capacity=g.m + 40,
                                  device="cpu")
    u = CoreMaintainer.from_graph(g)
    assert (h.device.type, h.kernel_backend) == ("cuda", "torch")
    with pytest.raises(ValueError, match="needs a device engine"):
        CoreMaintainer.from_graph(g, engine="host", kernel_backend="cuda")
    for ev in events:
        u.apply_batch(insert_edges=ev.edges, remove_edges=ev.removals)
        before = dict(K.LAUNCHES)
        sh = h.apply_batch(insert_edges=ev.edges, remove_edges=ev.removals)
        assert K.LAUNCHES == before
        sc = c.apply_batch(insert_edges=ev.edges, remove_edges=ev.removals)
        for f in sh._fields:
            assert int(getattr(sh, f)) == int(getattr(sc, f)), f
        np.testing.assert_array_equal(h.cores(), u.cores())
        np.testing.assert_array_equal(h.labels(), u.labels())
        for name in ("src", "dst", "valid", "core", "label", "n_edges"):
            assert torch.equal(getattr(h, name).cpu(), getattr(c, name))
        assert h.capacity == c.capacity and h.edge_slot == c.edge_slot
        cur = build_csr(g.n, np.asarray(sorted(h.edge_slot)))
        np.testing.assert_array_equal(h.cores(), bz_from_csr(cur))


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


@pytest.fixture(scope="module")
def nccl_mesh(tmp_path_factory):
    """A world of one NCCL rank on the card, rendezvous through a file
    store (the sharded engine's mesh on one card)."""
    import datetime
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_edge_mesh

    _card()
    store = dist.FileStore(str(tmp_path_factory.mktemp("nccl") / "store"),
                           1)
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=store, rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=60))
    try:
        yield make_edge_mesh()
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def nccl_mesh2(nccl_mesh):
    """The 2-axis ``(1, 1)`` edge x vertex mesh on the same world."""
    from repro_torch.launch.mesh import make_edge_vertex_mesh
    return make_edge_vertex_mesh(mesh_shape=(1, 1))


def _world_of_one(mesh, graph, stream, weighted, vertex_sharding,
                  **exchange):
    """The sharded engine on a world of one NCCL rank with
    ``kernel_backend="cuda"`` against the torch backend, batch by batch
    (stats, cores, labels, slot table, weights), and its cores and
    labels against the unified engine's. ``exchange``: the
    ``frontier_exchange`` / ``frontier_cap`` fields. Returns the
    launches."""
    g = {"er": lambda: erdos_renyi(500, 2500, seed=3),
         "rmat": lambda: rmat(9, 3000, seed=3),
         "sparse": lambda: erdos_renyi(4096, 300, seed=3)}[graph]()
    rng = np.random.default_rng(5)
    w0 = rng.integers(1, 6, g.m) if weighted else None
    events = (mixed_stream(g, 5, 80, seed=4) if stream == "mixed"
              else churn_stream(g, 5, 80, seed=4))
    kw = dict(weighted=weighted, weights=w0)
    sk = dict(engine="sharded", mesh=mesh, vertex_sharding=vertex_sharding,
              **exchange)
    a = CoreMaintainer.from_graph(g, **sk, **kw)
    b = CoreMaintainer.from_graph(g, **sk, kernel_backend="torch", **kw)
    u = CoreMaintainer.from_graph(g, kernel_backend="torch", **kw)
    assert (a.device.type, a.kernel_backend) == ("cuda", "cuda")
    launched = dict.fromkeys(K.LAUNCHES, 0)
    for ev in events:
        iw = rng.integers(1, 6, len(ev.edges)) if weighted else None
        before = dict(K.LAUNCHES)
        sa = a.apply_batch(insert_edges=ev.edges, remove_edges=ev.removals,
                           insert_weights=iw)
        for k in K.LAUNCHES:
            launched[k] += K.LAUNCHES[k] - before[k]
        sb = b.apply_batch(insert_edges=ev.edges, remove_edges=ev.removals,
                           insert_weights=iw)
        u.apply_batch(insert_edges=ev.edges, remove_edges=ev.removals,
                      insert_weights=iw)
        for f in sa._fields:
            assert int(getattr(sa, f)) == int(getattr(sb, f)), f
        names = ("core", "label", "src", "dst", "valid") + (
            ("w",) if weighted else ())
        for name in names:
            assert torch.equal(getattr(a, name), getattr(b, name)), name
            assert torch.equal(getattr(a, name), getattr(u, name)), name
    assert launched["fused_removal_round"] == 0
    assert launched["fused_promotion_stats"] == 0
    want = (("coo_stat[wsum]",) if weighted else
            ("coo_stat[mcd_hi_dout]", "coo_stat[hi_dout]", "coo_stat[din]",
             "coo_stat[same_in]"))
    for k in want:
        assert launched[k] > 0, k
    return launched


@pytest.mark.parametrize("weighted", [False, True],
                         ids=["unit", "weighted"])
@pytest.mark.parametrize("graph", ["er", "rmat"])
@pytest.mark.parametrize("stream", ["mixed", "churn"])
def test_sharded_world_of_one_cuda_matches_torch(nccl_mesh, graph, stream,
                                                 weighted):
    """``engine="sharded"`` on a world of one NCCL rank: the kernel
    backend equals the torch backend batch by batch (stats, cores,
    labels, slot table, weights), and the cores and labels equal the
    unified engine's; kernel a's unit statistics (d when weighted) run,
    the fused decisions b and c never do."""
    _world_of_one(nccl_mesh, graph, stream, weighted, "replicated")


@pytest.mark.parametrize("weighted", [False, True],
                         ids=["unit", "weighted"])
@pytest.mark.parametrize("graph", ["er", "rmat", "sparse"])
@pytest.mark.parametrize("stream", ["mixed", "churn"])
def test_range_world_of_one_cuda_matches_torch(nccl_mesh, graph, stream,
                                               weighted):
    """``vertex_sharding="range"`` on a world of one NCCL rank, as the
    replicated test above: kernels a (d weighted) run at halo width
    (``n = halo_cap``, below n on the sparse graph), b and c never, and
    everything equals the torch backend and the unified engine."""
    _world_of_one(nccl_mesh, graph, stream, weighted, "range")


@pytest.mark.parametrize("weighted", [False, True],
                         ids=["unit", "weighted"])
@pytest.mark.parametrize("graph", ["er", "sparse"])
@pytest.mark.parametrize("exchange", ["dense", "cap1", "planned"])
def test_halo_world_of_one_cuda_matches_torch(nccl_mesh2, graph, exchange,
                                              weighted):
    """``vertex_sharding="halo"`` on the ``(1, 1)`` mesh of one NCCL rank
    (the ``psum_edge`` all-reduce over a one-rank edge group, the table
    group), dense, sparse with a cap of 1 (overflowing) and with the
    planned cap: as the range test above."""
    fx = ({} if exchange == "dense" else
          dict(frontier_exchange="sparse",
               frontier_cap=1 if exchange == "cap1" else 0))
    _world_of_one(nccl_mesh2, graph, "mixed", weighted, "halo", **fx)


@pytest.mark.parametrize("cap", [1, 8])
@pytest.mark.parametrize("graph", ["er", "rmat"])
def test_sparse_range_world_of_one_cuda_matches_torch(nccl_mesh, graph, cap):
    """``frontier_exchange="sparse"`` on the range engine with pinned
    caps, unweighted: as the range test above."""
    _world_of_one(nccl_mesh, graph, "churn", False, "range",
                  frontier_exchange="sparse", frontier_cap=cap)


def test_cpu_tensors_never_launch_wsum():
    _card()
    before = dict(K.LAUNCHES)
    args = [x.cpu() for x in _wsum_window(50, 128, seed=4)]
    _wsum(*args, 50)
    assert K.LAUNCHES == before


# -- the run-folding edge passes: wsum, the removal round, the unit stats --
# wsum_kernel, removal_round_kernel and unit_stat_kernel take 4 consecutive
# slots a thread (128-bit loads when the columns are 16-byte aligned) and
# join runs of one src across the warp's 128 slots; a block holds 1,024
# slots and one sweep of the grid 8,448 x 1,024 (csrc/coremaint.cu
# kMaxBlocks).
SWEEP = 8448 * 1024


def _runs(rng, e, lengths):
    """Sorted src keys for ``e`` slots in runs whose lengths are drawn
    from ``lengths`` (then cut at ``e``)."""
    lens = rng.choice(lengths, size=2 * e // int(np.mean(lengths)) + 16)
    return np.repeat(np.arange(len(lens)), lens)[:e]


def _run_window(kind, seed, e=None):
    """``(n, src, dst, valid, w, core, thresh, label)`` on the card:

    * ``hub``: sorted by src, vertex 7 owning one run of 10,000 slots
      (longer than a block's 1,024), the rest short runs;
    * ``runs``: sorted, run lengths 1-5, 100-200 and 900-1,500, so runs
      cross lane, warp (128 slots) and block boundaries;
    * ``grid_stride``: sorted, 2.2 sweeps of the grid, with a 6,000-slot
      run across each sweep boundary;
    * ``dirty``: ``runs`` with dead slots, zero weights, and src and dst
      outside [0, n) (n, n + 5, -1, -n, -3n) inside and as whole runs;
    * ``shuffled``: ``hub``'s slots in a seeded random order (no runs);
    * ``ragged``: ``runs`` cut to ``e`` slots.
    """
    rng = np.random.default_rng(seed)
    n = 5000
    if kind in ("hub", "shuffled"):
        e = 60_000
        keys = np.sort(rng.integers(0, n, size=e))
        keys[20_000:30_000] = 7
        keys = np.sort(keys)
    elif kind == "grid_stride":
        e = int(2.2 * SWEEP)
        n = 1 << 20
        keys = _runs(rng, e, np.arange(1, 400)) % n
        keys = np.sort(keys)
        for b in (SWEEP, 2 * SWEEP):
            keys[b - 3000:b + 3000] = keys[b - 3000]
    else:
        e = e or 200_000
        lengths = np.concatenate([np.arange(1, 6), np.arange(100, 201),
                                  np.arange(900, 1501)])
        keys = _runs(rng, e, lengths) % n
    src = keys.astype(np.int32)
    dst = rng.integers(0, n, size=e).astype(np.int32)
    valid = rng.random(e) < 0.85
    w = rng.integers(1, 6, size=e).astype(np.int32)
    if kind == "dirty":
        w[rng.random(e) < 0.1] = 0
        bad = np.array([n, n + 5, -1, -n, -3 * n], dtype=np.int32)
        # single slots inside runs, and whole runs
        at = rng.choice(e, size=e // 50, replace=False)
        src[at] = rng.choice(bad, size=len(at))
        dst[rng.choice(e, size=e // 50, replace=False)] = rng.choice(
            bad, size=e // 50)
        for start in rng.choice(e - 600, size=20, replace=False):
            src[start:start + rng.integers(1, 600)] = rng.choice(bad)
    if kind == "shuffled":
        order = rng.permutation(e)
        src, dst, valid, w = src[order], dst[order], valid[order], w[order]
    core = rng.integers(0, 5, size=n).astype(np.int32)
    thresh = rng.integers(0, 8, size=n).astype(np.int32)
    label = (rng.permutation(n).astype(np.int64) - n // 2) << 20
    dev = _card()
    return (n, *(torch.from_numpy(x).to(dev)
                 for x in (src, dst, valid, w, core, thresh, label)))


def _masks(n, src):
    """The masks din and same_in are tested under: none set, the vertex
    with the most slots as src, about 1% and 50% of the vertices at
    random, all set."""
    ok = (src >= 0) & (src < n)
    hub = torch.zeros(n, dtype=torch.bool, device=src.device)
    hub[torch.bincount(src[ok].long(), minlength=n).argmax()] = True
    r = torch.rand(n, device=src.device,
                   generator=torch.Generator(src.device).manual_seed(13))
    return {"empty": torch.zeros_like(hub), "hub": hub, "1%": r < 0.01,
            "50%": r < 0.5, "all": torch.ones_like(hub)}


def _check_run_folding(n, src, dst, valid, w, core, thresh, label):
    """wsum, fused_removal_round, fused_promotion_stats and every unit
    stat of coo_stat (din and same_in under each of ``_masks``) against
    their plain versions on one window (tolerance 0), each launching its
    kernels."""
    before = dict(K.LAUNCHES)
    got = _wsum(src, dst, valid, w, core, thresh, n)
    args = (src, dst, valid, core, label, n)
    rounds = K.fused_removal_round(*args)
    promo = K.fused_promotion_stats(*args)
    torch.cuda.synchronize()
    assert K.LAUNCHES["coo_stat[wsum]"] == before["coo_stat[wsum]"] + 1
    for fn in ("fused_removal_round", "fused_promotion_stats"):
        assert K.LAUNCHES[fn] == before[fn] + 2
    assert torch.equal(got, K.wsum_plain(src, dst, valid, w, core, thresh,
                                         n))
    for out, plain in ((rounds, K.fused_removal_round_plain),
                       (promo, K.fused_promotion_stats_plain)):
        for g_, w_ in zip(out, plain(*args)):
            assert g_.dtype == w_.dtype and torch.equal(g_, w_)
    masks = _masks(n, src)
    for stat in UNIT_STATS:
        for name, aux in (masks.items() if stat in K._MASK_STATS
                          else [(None, None)]):
            key = f"coo_stat[{stat}]"
            count = K.LAUNCHES[key]
            got = K.coo_stat(*args, stat, aux)
            assert K.LAUNCHES[key] == count + 1 + (stat in K._MASK_STATS)
            assert torch.equal(got, K.coo_stat_plain(*args, stat, aux)), (
                stat, name)


@pytest.mark.parametrize("kind", ["hub", "runs", "grid_stride", "dirty",
                                  "shuffled"])
def test_wsum_and_fused_removal_kernels_match_plain(kind):
    """The run-folding edge passes on windows of runs; the test keeps its
    name from when wsum and the removal round were the only ones."""
    _check_run_folding(*_run_window(kind, seed=len(kind)))


@pytest.mark.parametrize("e", [1, 2, 3, 5, 6, 7, 4097, 200_001])
def test_wsum_and_fused_removal_kernels_ragged_windows(e):
    """E % 4 != 0 (the last group loads slot by slot) and E < 4."""
    _check_run_folding(*_run_window("ragged", seed=e, e=e))


def _at_offset(x, k):
    """``x`` as a contiguous view ``k`` elements into a fresh buffer: for
    k in 1-3 its ``data_ptr`` is not 16-byte (int32) or 4-byte (bytes)
    aligned."""
    buf = torch.zeros(x.shape[0] + k, dtype=x.dtype, device=x.device)
    buf[k:] = x
    return buf[k:]


@pytest.mark.parametrize("offset", [1, 2, 3])
@pytest.mark.parametrize("which", ["all", "src", "valid", "w"])
def test_wsum_and_fused_removal_kernels_unaligned_views(offset, which):
    """Views whose base is not aligned take the kernels' scalar loads:
    every column shifted, or only one of them."""
    n, src, dst, valid, w, core, thresh, label = _run_window(
        "dirty", seed=offset, e=50_003)
    cols = dict(src=src, dst=dst, valid=valid, w=w)
    for name in cols:
        if which in ("all", name):
            cols[name] = _at_offset(cols[name], offset)
    assert cols[which if which != "all" else "src"].data_ptr() % 16
    _check_run_folding(n, cols["src"], cols["dst"], cols["valid"],
                       cols["w"], core, thresh, label)


def test_wsum_and_fused_removal_kernels_run_the_designed_instructions():
    """Every edge pass (wsum_kernel, removal_round_kernel and the four
    unit_stat_kernel instances: hi_dout, mcd, din, same_in) loads slot
    columns 128 bits at a time (LDG.E.128) and joins runs across the warp
    by shuffles (SHFL), so a scalar one-slot-a-thread path cannot pass
    for them."""
    _card()
    sass = _sass_by_function(build_lib.build())
    wide = re.compile(r"LDG\.E\S*\.128")
    for kernel, count in (("wsum_kernel", 1), ("removal_round_kernel", 1),
                          ("unit_stat_kernel", 4)):
        fns = {n: t for n, t in sass.items() if kernel in n}
        assert len(fns) == count, (kernel, sorted(sass))
        for name, text in fns.items():
            assert wide.search(text) and "SHFL" in text, name
    assert not [n for n in sass if re.search(r"\d+stat_kernel", n)]
    # the masked stats' bit packing: one ballot a warp
    packs = [t for n, t in sass.items() if "pack_mask_kernel" in n]
    assert len(packs) == 1 and "VOTE" in packs[0]


# -- ELL, FM and attention kernels ---------------------------------------

def _ell(n, d, seed, neg=False):
    """A random ELL matrix on the card: ragged rows padded with n, some
    empty rows, and (``neg``) negative ids in [-(n + 3), 0)."""
    rng = np.random.default_rng(seed)
    deg = rng.integers(0, d + 1, size=n)
    deg[::7] = 0
    ids = rng.integers(0, n, size=(n, d))
    if neg:
        ids = np.where(rng.random((n, d)) < 0.2,
                       rng.integers(-(n + 3), 0, size=(n, d)), ids)
    nbrs = np.where(np.arange(d)[None, :] < deg[:, None], ids, n)
    return torch.from_numpy(nbrs.astype(np.int32)).to(_card())


def _real_vals(n, seed):
    """float32 values of mixed sign and of magnitudes 1e-3 to 1e3: their
    sums depend on the order of the adds."""
    rng = np.random.default_rng(seed)
    vals = rng.standard_normal(n) * 10.0 ** rng.integers(-3, 4, size=n)
    return torch.from_numpy(vals.astype(np.float32)).to(_card())


def _int_vals(n, dtype, seed):
    """Integer values in [-50, 50), every 11th below the max sentinel
    (-(2**30)), in ``dtype``."""
    rng = np.random.default_rng(seed)
    vals = rng.integers(-50, 50, size=n)
    vals[::11] = -(2**31) + 5
    return torch.from_numpy(vals).to(dtype).to(_card())


def _check_stat(nbrs, vals, op):
    """The kernel against its plain version, bit for bit, in one launch."""
    key = f"ell_stat[{op},{TAG[vals.dtype]}]"
    before = SE.LAUNCHES[key]
    got = ops.ell_stat_op(nbrs, vals, vals, op)
    torch.cuda.synchronize()
    assert SE.LAUNCHES[key] == before + 1
    want = SE.ell_stat_plain(nbrs, vals, vals, op)
    assert got.dtype == want.dtype == vals.dtype and torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64, torch.float32])
@pytest.mark.parametrize("op", ["count_ge", "count_gt", "sum", "max"])
@pytest.mark.parametrize("n,d,neg", [(300, 17, False), (4096, 40, True),
                                     (50, 32, True)])
def test_ell_stat_kernel_matches_plain(dtype, op, n, d, neg):
    """Bit for bit: values below -(2**30) exercise the max sentinel, the
    integer sums' wrap and float32 sums that round (the kernel adds in
    the plain version's column order)."""
    _check_stat(_ell(n, d, seed=n + d, neg=neg), _int_vals(n, dtype, 1), op)


@pytest.mark.parametrize("op", ["sum", "max"])
@pytest.mark.parametrize("n,d", [(300, 17), (4096, 40), (500, 100),
                                 (1000, 38), (513, 1), (70, 3000)])
def test_ell_stat_float_kernel_is_bit_exact_on_real_values(op, n, d):
    """float32 values whose sums depend on the order of the adds: still
    bit for bit (tolerance 0), since each row's thread adds its slots in
    column order, as the plain version does, across column chunks too
    (D = 3000)."""
    _check_stat(_ell(n, d, seed=n, neg=True), _real_vals(n, n + d), op)


def _tile_case(case):
    """The tile's edges: D = 1; D = 3000, several column chunks a row;
    n = 513, not a multiple of the 256-row tile; ``nbrs[1:]`` of a matrix
    with D = 37, a contiguous view whose base is not 16-byte aligned (the
    scalar head and tail); half the rows all pads and ids in [-(n + 3),
    0) in the rest."""
    if case == "d1":
        return _ell(1000, 1, seed=1, neg=True)
    if case == "d3000":
        return _ell(70, 3000, seed=2, neg=True)
    if case == "n513":
        return _ell(513, 38, seed=3, neg=True)
    if case == "unaligned":
        # the view's n is 600: ids 600 and 601 are pads of its rows
        nbrs = _ell(601, 37, seed=4, neg=True)[1:]
        assert nbrs.is_contiguous() and nbrs.data_ptr() % 16
        return nbrs
    nbrs = _ell(600, 38, seed=5, neg=True)
    nbrs[:300] = 600
    return nbrs


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64, torch.float32])
@pytest.mark.parametrize("op", ["count_ge", "count_gt", "sum", "max"])
@pytest.mark.parametrize("case", ["d1", "d3000", "n513", "unaligned",
                                  "all_pads"])
def test_ell_stat_kernel_tile_edges_match_plain(dtype, op, case):
    """Bit for bit at the edges of the tile design, every op and dtype:
    integer values with some below the max sentinel, float32 values whose
    sums depend on the order of the adds."""
    nbrs = _tile_case(case)
    n = nbrs.shape[0]
    vals = (_real_vals(n, n) if dtype == torch.float32
            else _int_vals(n, dtype, n))
    _check_stat(nbrs, vals, op)


def test_ell_stat_kernel_runs_the_designed_instructions():
    """Every ell_stat_kernel instance (4 ops x int32, int64, float32)
    reads its ids 128 bits at a time (LDG.E...128), stages them in shared
    memory (STS, LDS) between block barriers (BAR), and shuffles nothing:
    the float32 sum folds each row in column order from shared memory,
    with no serial SHFL walk."""
    _card()
    sass = _sass_by_function(build_lib.build())
    fns = {n: t for n, t in sass.items() if "ell_stat_kernel" in n}
    assert len(fns) == 12, sorted(sass)
    wide = re.compile(r"LDG\.E\S*\.128")
    for name, text in fns.items():
        assert wide.search(text), name
        assert all(op in text for op in ("STS", "LDS", "BAR")), name
        assert "SHFL" not in text, name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("op", ["sum", "max"])
@pytest.mark.parametrize("n,d,f", [(200, 12, 16), (3000, 40, 100),
                                   (64, 5, 300)])
def test_ell_aggregate_kernel_matches_plain(dtype, op, n, d, f):
    """Bit for bit (``torch.equal``), both ops and dtypes: the kernel folds
    every output element in column order and rounds a sum once, as the
    plain version does."""
    nbrs = _ell(n, d, seed=n + f, neg=True)
    gen = torch.Generator(device=_card()).manual_seed(f)
    feats = torch.randn((n, f), generator=gen, device="cuda").to(dtype)
    key = f"ell_aggregate[{op},{TAG[dtype]}]"
    before = SE.LAUNCHES[key]
    got = ops.ell_aggregate_op(nbrs, feats, op)
    torch.cuda.synchronize()
    assert SE.LAUNCHES[key] == before + 1
    want = SE.ell_aggregate_plain(nbrs, feats, op)
    assert got.dtype == want.dtype == dtype and got.shape == (n, f)
    assert torch.equal(got, want)


def _feats(n, f, dtype, seed, offset=0):
    """``[n, f]`` random features on the card; ``offset`` > 0 makes them a
    view that many elements into a flat buffer, so its ``data_ptr`` is
    not 16-byte aligned."""
    gen = torch.Generator(device=_card()).manual_seed(seed)
    x = torch.randn((n, f), generator=gen, device="cuda").to(dtype)
    if offset:
        buf = torch.zeros(n * f + offset, dtype=dtype, device="cuda")
        buf[offset:] = x.flatten()
        x = buf[offset:].view(n, f)
    return x


def _check_agg(nbrs, feats, op):
    """The kernel against its plain version, bit for bit; NaN where the
    plain version has NaN."""
    key = f"ell_aggregate[{op},{TAG[feats.dtype]}]"
    before = SE.LAUNCHES[key]
    got = ops.ell_aggregate_op(nbrs, feats, op)
    torch.cuda.synchronize()
    assert SE.LAUNCHES[key] == before + 1
    want = SE.ell_aggregate_plain(nbrs, feats, op)
    assert got.dtype == want.dtype and got.shape == want.shape
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("op", ["sum", "max"])
@pytest.mark.parametrize("d", [1, 31, 33, 70])
@pytest.mark.parametrize("f", [1, 3, 4, 100, 129, 300])
def test_ell_aggregate_kernel_folds_in_column_order(dtype, op, d, f):
    """Every F the lanes cover in one or several passes (vector loads for
    F % 4 == 0, scalar ones for odd F, bfloat16 included) and D across
    the 64-column id chunks, on rows that mix live, negative and pad ids:
    bit for bit."""
    nbrs = _ell(300, d, seed=7 * f + d, neg=True)
    _check_agg(nbrs, _feats(300, f, dtype, seed=f + d), op)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("op", ["sum", "max"])
@pytest.mark.parametrize("f,offset", [(4, 1), (100, 1), (100, 2), (129, 3)])
def test_ell_aggregate_kernel_unaligned_feats(dtype, op, f, offset):
    """``feats`` as a view whose base is not 16-byte aligned takes the
    scalar loads (bfloat16 at an even offset keeps its 8-byte loads)."""
    feats = _feats(500, f, dtype, seed=f, offset=offset)
    assert feats.data_ptr() % 16 != 0 and feats.is_contiguous()
    _check_agg(_ell(500, 40, seed=offset, neg=True), feats, op)
    # a row view of a wider table: rows 1.. of [n + 1, f]
    rows = _feats(501, f, dtype, seed=f + 1)[1:]
    _check_agg(_ell(500, 40, seed=offset + 3), rows, op)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("op", ["sum", "max"])
@pytest.mark.parametrize("case", ["all_pad", "all_live", "negative",
                                  "nan", "below_sentinel"])
def test_ell_aggregate_kernel_edge_rows(dtype, op, case):
    """All-pad rows (max gives 0), all-live rows (no sentinel), only
    negative ids (they wrap once; -1 and those below -(n + 1) read 0), NaN
    features (they propagate), and features below the -1e30 sentinel
    (max gives the sentinel where a row holds a pad entry)."""
    n, d, f = 400, 38, 100
    rng = np.random.default_rng(len(case))
    ids = rng.integers(0, n, size=(n, d))
    if case == "all_pad":
        ids[:] = n
    elif case == "negative":
        ids = rng.integers(-(n + 4), 0, size=(n, d))
        ids[::5, d // 2:] = n
    elif case != "all_live":
        ids[rng.random((n, d)) < 0.6] = n
    nbrs = torch.from_numpy(ids.astype(np.int32)).to(_card())
    feats = _feats(n, f, dtype, seed=3)
    if case == "nan":
        feats[::9, ::7] = float("nan")
    elif case == "below_sentinel":
        feats = feats.float().mul(1e36).to(dtype)
    _check_agg(nbrs, feats, op)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,f,d", [(64, 39, 10), (1000, 26, 16), (3, 5, 4),
                                   (9, 200, 100)])
def test_fm_interaction_kernel_matches_plain(dtype, b, f, d):
    """float32: rtol/atol 1e-4, as the reference's kernel test; both
    accumulate in float32, so bfloat16 differs by one rounding of the
    result (rtol 1e-2). [9, 200, 100] is too wide to stage in shared
    memory and reads device memory directly."""
    gen = torch.Generator(device=_card()).manual_seed(b)
    emb = torch.randn((b, f, d), generator=gen, device="cuda").to(dtype)
    key = f"fm_interaction[{TAG[dtype]}]"
    before = FM.LAUNCHES[key]
    got = ops.fm_interaction_op(emb)
    torch.cuda.synchronize()
    assert FM.LAUNCHES[key] == before + 1
    want = FM.fm_interaction_plain(emb)
    assert got.dtype == dtype and got.shape == (b,)
    tol = 1e-4 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def _check_fm(emb):
    key = f"fm_interaction[{TAG[emb.dtype]}]"
    before = FM.LAUNCHES[key]
    got = ops.fm_interaction_op(emb)
    torch.cuda.synchronize()
    assert FM.LAUNCHES[key] == before + 1
    want = FM.fm_interaction_plain(emb)
    assert got.dtype == emb.dtype and got.shape == (emb.shape[0],)
    tol = 1e-4 if emb.dtype == torch.float32 else 1e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("view", ["whole", "from_row_1"])
@pytest.mark.parametrize("b", [1, 3, 31, 512, 20_000])
def test_fm_interaction_kernel_batch_sizes(dtype, view, b):
    """DeepFM's [B, 39, 10] rows (1,560 B float32, 780 B bfloat16, so a
    span is an even or a multiple-of-4 count of rows): batches from one
    row (a ragged span read from device memory) to many spans a CTA, and
    ``emb[1:]``, whose base is 8-byte aligned (float32) and takes the
    plain loads. Tolerance as in test_fm_interaction_kernel_matches_plain."""
    gen = torch.Generator(device=_card()).manual_seed(b)
    emb = torch.randn((b + 1, 39, 10), generator=gen, device="cuda").to(dtype)
    emb = emb[:b] if view == "whole" else emb[1:]
    assert (emb.data_ptr() % 16 == 0) == (view == "whole")
    _check_fm(emb)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,f,d", [(1, 3, 5), (31, 3, 5), (20_000, 3, 5),
                                   (33, 7, 40), (2000, 7, 40), (700, 1, 1),
                                   (300, 26, 33)])
def test_fm_interaction_kernel_row_widths(dtype, b, f, d):
    """Rows of 30 and 60 bytes ([*, 3, 5]: spans of a multiple of 8 or 4
    rows), D > 32 (a group of 32 lanes a row, several columns a lane) and
    1-element rows; rows too wide for a stage are
    test_fm_interaction_kernel_matches_plain's [9, 200, 100]."""
    gen = torch.Generator(device=_card()).manual_seed(b + f + d)
    _check_fm(torch.randn((b, f, d), generator=gen, device="cuda").to(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,h,hkv,sq,sk,d", [
    (2, 4, 4, 256, 256, 64), (1, 8, 2, 512, 512, 64),
    (2, 4, 1, 128, 128, 128), (1, 4, 2, 200, 200, 64),
    (1, 4, 2, 128, 384, 128), (1, 2, 1, 384, 96, 64),
    (1, 28, 4, 1024, 1024, 128), (1, 4, 2, 1000, 1000, 128),
    (1, 14, 2, 384, 96, 128), (2, 8, 2, 512, 512, 64)])
def test_flash_attention_kernel_matches_plain(dtype, causal, b, h, hkv, sq,
                                              sk, d):
    """float32 2e-3 and bfloat16 3e-2, as the reference's kernel tests;
    Sq != Sk checks the top-left causal alignment (Sq > Sk at qwen2-7b's
    group of 7 too), Sq = 200 and Sq = Sk = 1,000 ragged tiles, 28/4
    heads qwen2-7b's. The blocks are the whole sequences, which the
    reference's rule (blocks divide the lengths) always accepts; the
    kernels pick their own tiles."""
    gen = torch.Generator(device=_card()).manual_seed(sq + sk)
    q = torch.randn((b, h, sq, d), generator=gen, device="cuda").to(dtype)
    k = torch.randn((b, hkv, sk, d), generator=gen, device="cuda").to(dtype)
    v = torch.randn((b, hkv, sk, d), generator=gen, device="cuda").to(dtype)
    key = FA.launch_key(causal, dtype, d)
    before = FA.LAUNCHES[key]
    got = ops.flash_attention_op(q, k, v, causal=causal, block_q=sq,
                                 block_k=sk)
    torch.cuda.synchronize()
    assert FA.LAUNCHES[key] == before + 1
    want = FA.flash_attention_plain(q, k, v, causal=causal)
    assert got.dtype == dtype and got.shape == q.shape
    tol = 2e-3 if dtype == torch.float32 else 3e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    assert _row_rel_err(got, want) < ROW_REL[dtype]


# max over query rows of |got - want| / |want| (each row's D values): the
# sound error is a few bf16 roundings (2**-9 each) in bfloat16 and ex2's
# approximation in float32, while a dropped or misplaced key tile moves a
# late row's output by several per cent
ROW_REL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}


def _row_rel_err(got, want) -> float:
    g, w = got.double(), want.double()
    return float(((g - w).norm(dim=-1) / w.norm(dim=-1)).max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("scale", [0.3, 0.0, -0.125, -1.0])
def test_flash_attention_kernel_takes_any_scale(dtype, causal, scale):
    """An explicit scale, zero and negative too, gives the plain version's
    answer (the kernels scale the scores before the mask and the max);
    Sq = Sk = 200 has ragged tiles, so masked keys are in play."""
    gen = torch.Generator(device=_card()).manual_seed(7)
    q = torch.randn((1, 4, 200, 128), generator=gen, device="cuda").to(dtype)
    k = torch.randn((1, 2, 200, 128), generator=gen, device="cuda").to(dtype)
    v = torch.randn((1, 2, 200, 128), generator=gen, device="cuda").to(dtype)
    key = FA.launch_key(causal, dtype, 128)
    before = FA.LAUNCHES[key]
    got = FA.flash_attention(q, k, v, causal=causal, scale=scale,
                             block_q=200, block_k=200)
    torch.cuda.synchronize()
    assert FA.LAUNCHES[key] == before + 1
    want = FA.flash_attention_plain(q, k, v, causal=causal, scale=scale)
    assert torch.isfinite(got.float()).all()
    tol = 2e-3 if dtype == torch.float32 else 3e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    assert _row_rel_err(got, want) < ROW_REL[dtype]


def _sass_by_function(lib) -> dict:
    """``cuobjdump -sass`` of the built library, split by function."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    text = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    parts = re.split(r"Function : (\S+)", text)
    return dict(zip(parts[1::2], parts[2::2]))


def test_attention_kernels_run_the_designed_instructions():
    """The bfloat16 instances run wgmma (HGMMA) on tiles that TMA loads
    (UTMALDG); the float32 instances stay on the CUDA cores (no HGMMA,
    no HMMA), so a scalar path cannot pass for the tensor-core one."""
    _card()
    sass = _sass_by_function(build_lib.build())
    wgmma = {n: t for n, t in sass.items() if "flash_wgmma_kernel" in n}
    ffma = {n: t for n, t in sass.items() if "flash_ffma_kernel" in n}
    assert len(wgmma) == 2 and len(ffma) == 2, sorted(sass)
    for name, text in wgmma.items():
        assert "HGMMA" in text and "UTMALDG" in text, name
    for name, text in ffma.items():
        assert "HGMMA" not in text and "HMMA" not in text, name
        assert "FFMA" in text, name


def test_ell_aggregate_and_fm_kernels_run_the_designed_instructions():
    """Every ell_aggregate_kernel instance compacts its row's live ids
    with ballots (VOTE) into a shared-memory list that its lanes read by
    broadcast (LDS); the vector instances gather 4 features a lane in one
    load (LDG.E.128 float32, LDG.E.64 bfloat16). The staged fm_kernel
    instances fill their ring with bulk copies (UBLKCP) and every
    instance adds a row's D terms with shuffles (SHFL), so a one-id-at-a-
    time walk, a one-thread-a-row reduction or a plain-load design cannot
    pass for them."""
    _card()
    sass = _sass_by_function(build_lib.build())
    agg = {n: t for n, t in sass.items() if "ell_aggregate_kernel" in n}
    assert len(agg) == 8, sorted(sass)  # dtype x op x vector or scalar
    for name, text in agg.items():
        assert "VOTE" in text and "LDS" in text, name
        if "Lb1E" in name:  # VEC = true
            width = "128" if "ell_aggregate_kernelIf" in name else "64"
            assert re.search(rf"LDG\.E\S*\.{width}", text), name
    fm = {n: t for n, t in sass.items() if "fm_kernel" in n}
    assert len(fm) == 4, sorted(sass)  # dtype x staged or not
    for name, text in fm.items():
        assert "SHFL" in text, name
        assert ("UBLKCP" in text) == ("Lb1E" in name), name


def test_new_kernels_are_forward_only():
    """A CUDA input that requires grad raises (no silent detach); under
    no_grad the same call launches."""
    dev = _card()
    nbrs = _ell(64, 8, seed=1)
    vals = torch.randn(64, device=dev, requires_grad=True)
    feats = torch.randn((64, 16), device=dev, requires_grad=True)
    emb = torch.randn((8, 5, 4), device=dev, requires_grad=True)
    q = torch.randn((1, 2, 64, 64), device=dev, requires_grad=True)
    calls = [lambda: ops.ell_stat_op(nbrs, vals, vals.detach(), "sum"),
             lambda: ops.ell_aggregate_op(nbrs, feats),
             lambda: ops.fm_interaction_op(emb),
             lambda: ops.flash_attention_op(q, q.detach(), q.detach())]
    for call in calls:
        with pytest.raises(RuntimeError, match="training slice"):
            call()
        with torch.no_grad():
            call()


def test_new_kernels_refuse_what_they_do_not_take():
    dev = _card()
    nbrs = _ell(64, 8, seed=2)
    with pytest.raises(TypeError, match="int32, int64|one of"):
        ops.ell_stat_op(nbrs, torch.ones(64, dtype=torch.int16, device=dev),
                        torch.ones(64, dtype=torch.int16, device=dev))
    with pytest.raises(TypeError, match="int32 nbrs"):
        ops.ell_stat_op(nbrs.long(), torch.ones(64, device=dev),
                        torch.ones(64, device=dev))
    with pytest.raises(TypeError):
        ops.ell_aggregate_op(nbrs, torch.ones((64, 4), dtype=torch.float64,
                                              device=dev))
    q = torch.ones((1, 2, 64, 32), device=dev)
    with pytest.raises(ValueError, match="D in"):
        ops.flash_attention_op(q, q, q)
    with pytest.raises(TypeError):
        ops.fm_interaction_op(torch.ones((4, 3, 2), dtype=torch.float64,
                                         device=dev))


def test_deepfm_serving_on_the_card_matches_plain_branch_and_cpu():
    """DeepFM at smoke() width on the card: the FM-kernel branch against
    the plain branch (rtol/atol 1e-4, TF32 off) and against the CPU."""
    dev = _card()
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = deepfm_cfg.smoke()
    assert not cfg.use_pallas_fm
    model = recsys.deepfm_init(cfg, torch.Generator(device=dev)
                               .manual_seed(0))
    rng = np.random.default_rng(0)
    sparse = torch.from_numpy(rng.integers(
        0, cfg.rows_per_field, (256, cfg.n_sparse)).astype(np.int32))
    fm_cfg = dataclasses.replace(cfg, use_pallas_fm=True)
    before = FM.LAUNCHES["fm_interaction[f32]"]
    got = recsys.deepfm_forward(fm_cfg, model, sparse.to(dev))
    assert FM.LAUNCHES["fm_interaction[f32]"] == before + 1
    plain = recsys.deepfm_forward(cfg, model, sparse.to(dev))
    cpu = recsys.deepfm_forward(fm_cfg, model.cpu(), sparse)
    assert got.dtype == torch.float32 and got.shape == (256,)
    torch.testing.assert_close(got, plain, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(got.cpu(), cpu, rtol=1e-4, atol=1e-4)


def test_cpu_tensors_never_launch_new_kernels():
    _card()
    before = (dict(SE.LAUNCHES), dict(FM.LAUNCHES), dict(FA.LAUNCHES))
    nbrs = torch.full((4, 2), 4, dtype=torch.int32)
    ops.ell_stat_op(nbrs, torch.ones(4), torch.ones(4))
    ops.ell_aggregate_op(nbrs, torch.ones((4, 3)))
    ops.fm_interaction_op(torch.ones((2, 3, 4)))
    ops.flash_attention_op(*[torch.ones((1, 1, 8, 64))] * 3)
    assert (SE.LAUNCHES, FM.LAUNCHES, FA.LAUNCHES) == before
