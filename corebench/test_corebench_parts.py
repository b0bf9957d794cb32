"""CPU tests of the benchmark's parts: the device generators, the burst
traffic, the plain reference against brute force, the roofline's byte
counts and the import guard."""
import ast
import hashlib
import itertools
from pathlib import Path

import numpy as np
import pytest
import torch

from corebench import graphs, mixes, roofline, tiny
from corebench.references import kcore as reference
from corebench.guard import forbidden_modules

HERE = Path(__file__).resolve().parent


def _generate(cfg, seed):
    g = graphs.generate(cfg, seed, "cpu")
    return g.n, g.keys, g.perm


def _check_keys(n, keys):
    lo, hi = keys // n, keys % n
    assert bool((lo < hi).all()) and bool((hi < n).all())
    assert bool((keys[1:] > keys[:-1]).all())  # sorted and unique


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 5, 12345678901234])
def test_gnm_has_exactly_m_distinct_edges(seed):
    n, keys, _ = _generate({"generator": "gnm", "n": 500,
                            "m": 4000, "graph_seed": seed}, 1)
    assert n == 500 and keys.numel() == 4000
    _check_keys(n, keys)


def test_gnm_dense_corner_and_refusal():
    n, keys, _ = _generate({"generator": "gnm", "n": 12, "m": 66,
                            "graph_seed": 3}, 3)
    assert keys.numel() == 66  # every pair
    with pytest.raises(ValueError):
        graphs.generate({"generator": "gnm", "n": 12, "m": 67,
                         "graph_seed": 3}, 3, "cpu")


def test_kronecker_counts_and_seeds():
    cfg = {"generator": "kronecker", "scale": 9, "edgefactor": 16,
           "initiator": [0.57, 0.19, 0.19]}
    n, a, perm = _generate(dict(cfg, graph_seed=11), 1)
    _, b, _ = _generate(dict(cfg, graph_seed=11), 2)
    _, c, _ = _generate(dict(cfg, graph_seed=12), 1)
    assert torch.equal(torch.sort(perm).values, torch.arange(n))
    assert n == 512
    _check_keys(n, a)
    assert 0 < a.numel() <= 16 * 512
    assert torch.equal(a, b) and not torch.equal(a, c)
    # skewed: the top tenth of vertices holds far more than a tenth of the
    # endpoints
    deg = torch.bincount(torch.cat([a // n, a % n]), minlength=n)
    top = torch.sort(deg, descending=True).values[: n // 10].sum()
    assert int(top) > 0.3 * int(deg.sum())


def test_csr_arrays_round_trip():
    n, keys, _ = _generate({"generator": "gnm", "n": 60, "m": 200,
                            "graph_seed": 1}, 1)
    indptr, indices = graphs.csr_arrays(keys, n)
    src = np.repeat(np.arange(n), np.diff(indptr))
    assert indices.dtype == np.int32 and indptr[-1] == 400
    back = sorted(int(s) * n + int(d) for s, d in zip(src, indices) if s < d)
    assert back == keys.tolist()
    for v in range(n):  # rows sorted by neighbour id
        row = indices[indptr[v]:indptr[v + 1]]
        assert (np.diff(row) > 0).all()


def test_burst_pairs_restore_the_edge_set():
    g = graphs.generate({"generator": "gnm", "n": 200, "m": 1000,
                         "graph_seed": 5}, 5, "cpu")
    n = g.n
    t = mixes.make({"kind": "burst", "batch_edges": 50, "distinct_pairs": 3,
                    "trace_pairs": 1}, g, 5, 5)
    live = set(g.relabelled[0].tolist())
    start = set(live)
    used = []
    for i in range(2 * 5):  # past distinct_pairs: the chunks cycle
        b = t.batch(i)
        moved = set(reference.edge_keys(b.insert if b.kind == "insert"
                                        else b.remove, n, "cpu").tolist())
        assert len(moved) == 50
        if b.kind == "remove":
            assert moved <= live and not len(b.insert)
            live -= moved
            used.append(b.chunk)
            assert t.removed_after(i) == b.chunk
        else:
            assert not moved & live and not len(b.remove)
            live |= moved
            assert live == start and t.removed_after(i) is None
    assert used == [0, 1, 2, 0, 1]
    # the set-up's warm-up is one whole cycle, the window's first
    warm = t.warmup()
    assert [(b.kind, b.chunk) for b in warm] == \
        [(t.batch(i).kind, t.batch(i).chunk) for i in range(6)]
    assert sorted(b.chunk for b in warm[::2]) == [0, 1, 2]
    # the chunks of one seed's permutation are disjoint
    chunks = [set(reference.edge_keys(c, n, "cpu").tolist())
              for c in t.chunks]
    assert all(not a & b for a, b in itertools.combinations(chunks, 2))


@pytest.mark.parametrize("generator", [
    {"generator": "kronecker", "scale": 8, "edgefactor": 8,
     "initiator": [0.57, 0.19, 0.19]},
    {"generator": "gnm", "n": 300, "m": 900}], ids=["kronecker", "gnm"])
def test_a_graph_seed_fixes_the_graph_and_its_bursts(generator):
    """With a ``graph_seed`` every run seed gets the same graph and the same
    bursts, in another vertex order and another burst order."""
    cfg = dict(generator, graph_seed=4)
    mix = {"kind": "burst", "batch_edges": 20, "distinct_pairs": 5,
           "trace_pairs": 1}
    runs = []
    for seed in (1, 2):
        g = graphs.generate(cfg, seed, "cpu")
        n, keys, perm = g.n, g.keys, g.perm
        t = mixes.make(mix, g, cfg["graph_seed"], seed)
        inv = torch.argsort(perm)  # back to the structure's own ids
        back = [sorted(reference.edge_keys(inv[torch.as_tensor(c)], n,
                                           "cpu").tolist()) for c in t.chunks]
        runs.append((keys, g.relabelled[0], back))
    (k1, g1, c1), (k2, g2, c2) = runs
    assert torch.equal(k1, k2) and not torch.equal(g1, g2)
    assert sorted(c1) == sorted(c2) and c1 != c2
    # the relabelled bursts are live edges of the relabelled graph
    t = mixes.make(mix, graphs.generate(cfg, 1, "cpu"), cfg["graph_seed"], 1)
    for c in t.chunks:
        assert set(reference.edge_keys(c, n, "cpu").tolist()) <= \
            set(g1.tolist())


def _sha(arrays):
    d = hashlib.sha256()
    for a in arrays:
        a = a.cpu().numpy() if torch.is_tensor(a) else np.asarray(a)
        d.update(np.ascontiguousarray(a.astype(np.int64)).tobytes())
    return d.hexdigest()


# the parent's generators and burst mix at tiny.py's sizes, before they
# moved into generators/ and kinds/ (seed 2**31 + 17): keys, vertex ids,
# and every batch of one cycle (insert, remove)
DIGESTS = {
    "tiny-rmat": (
        "6815bd3a41708dff18c36e865065ab78c569f992d78a7a3d3166dbfc1a0e5d0d",
        "fab99e3c62a16dcf25f4b106c264a6ae928b1f01f094c1ce31e43f836b484c38",
        "dc49f10e8c1d69834202c20fbec36d5af3452a895dc591c02d6366ecb4e25ebc"),
    "tiny-er": (
        "4d73aaa3ea71eee5c4157c4647ee2227c918b1cc7c216f70c54a66bc9daf00a2",
        "13711138c81803971ce272f620186bf5fd5f223b25b8376e2bd5153e483d8091",
        "0298fd2255e8569f5d2693476931f383b78e7931a3c019c0f966cc2aa1619d9b"),
}


@pytest.mark.parametrize("name", sorted(DIGESTS))
def test_moved_generators_and_burst_send_the_parents_bits(name):
    cfg = tiny.CONFIGS[name]
    g = graphs.generate(cfg, 2**31 + 17, "cpu")
    t = mixes.make(tiny.MIX, g, cfg["graph_seed"], 2**31 + 17)
    batches = [t.batch(i) for i in range(2 * t.distinct)]
    assert (_sha([g.keys]), _sha([g.perm]), _sha(
        [x for b in batches for x in (b.insert, b.remove)])) == DIGESTS[name]


SLIDE = {"kind": "sliding", "step_edges": 30, "new_edges": 120,
         "warmup_batches": 3, "trace_batches": 4}


@pytest.mark.parametrize("cfg", [
    {"generator": "kronecker", "scale": 7, "edgefactor": 8,
     "initiator": [0.57, 0.19, 0.19], "graph_seed": 3},
    {"generator": "gnm", "n": 200, "m": 900, "graph_seed": 5}],
    ids=["kronecker", "gnm"])
def test_sliding_replays_a_window_over_a_distinct_ring(cfg):
    """The ring is distinct: the graph's edges, then new edges of the
    generator's law absent from it; every removal is live and every
    insertion absent; ``live(i)`` is the replay's edge set, through more
    than one turn of the ring (the wrap); each seed sends the same batches
    in its own vertex ids."""
    g = graphs.generate(cfg, 9, "cpu")
    n, m = g.n, g.keys.numel()
    t = mixes.make(SLIDE, g, cfg["graph_seed"], 9)
    ring = reference.edge_keys(t.edges, n, "cpu")
    assert ring.numel() == m + 120 == torch.unique(ring).numel()
    start = set(g.relabelled[0].tolist())
    first = set(reference.edge_keys(t.edges[:m], n, "cpu").tolist())
    assert first == start and not set(ring.tolist()) - first & start
    live = set(start)
    assert set(t.live(-1, "cpu")[0].tolist()) == live
    turn = (m + 120) // 30 + 1
    for i in range(2 * turn + 3):
        b = t.batch(i)
        gone = reference.edge_keys(b.remove, n, "cpu").tolist()
        new = reference.edge_keys(b.insert, n, "cpu").tolist()
        assert b.kind == "mixed" and len(set(gone)) == len(set(new)) == 30
        assert set(gone) <= live and not set(new) & live
        live = (live - set(gone)) | set(new)
        keys, weights = t.live(i, "cpu")
        assert weights is None and keys.tolist() == sorted(live)
    # an edge re-enters new_edges / step_edges steps after it left
    gone0 = set(reference.edge_keys(t.batch(0).remove, n, "cpu").tolist())
    back = set(reference.edge_keys(t.batch(4).insert, n, "cpu").tolist())
    assert gone0 == back
    assert [(b.kind, b.insert.tolist()) for b in t.warmup()] == \
        [(t.batch(i).kind, t.batch(i).insert.tolist()) for i in range(3)]
    # another seed: the same ring in other vertex ids
    h = graphs.generate(cfg, 10, "cpu")
    u = mixes.make(SLIDE, h, cfg["graph_seed"], 10)
    inv_g, inv_h = torch.argsort(g.perm), torch.argsort(h.perm)
    assert torch.equal(inv_g[torch.as_tensor(t.edges)],
                       inv_h[torch.as_tensor(u.edges)])


def _brute_cores(n, edges):
    adj = [set() for _ in range(n)]
    for u, v in edges:
        adj[u].add(v)
        adj[v].add(u)
    core = [0] * n
    alive = set(range(n))
    k = 0
    while alive:
        k += 1
        changed = True
        while changed:
            changed = False
            for v in list(alive):
                if len(adj[v] & alive) < k:
                    alive.discard(v)
                    core[v] = k - 1
                    changed = True
    return core


@pytest.mark.parametrize("seed", range(6))
def test_reference_cores_and_certificate_against_brute_force(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(5, 40))
    m = int(rng.integers(0, n * (n - 1) // 2 + 1))
    pairs = np.array([(u, v) for u in range(n) for v in range(u + 1, n)])
    edges = pairs[rng.choice(len(pairs), size=m, replace=False)] if m else \
        np.zeros((0, 2), dtype=np.int64)
    keys = reference.edge_keys(edges, n, "cpu")
    core, label = reference.core_numbers(keys, n, with_order=True)
    assert core.tolist() == _brute_cores(n, edges.tolist())
    assert reference.order_violations(keys, n, core, label) == 0
    same = torch.nonzero(core == core.max()).flatten()
    if same.numel() > 1:
        dup = label.clone()
        dup[same[1]] = dup[same[0]]
        assert reference.order_violations(keys, n, core, dup) > 0


def test_certificate_catches_a_wrong_order():
    # a star: every core is 1, and the centre must come after all but one
    # of its leaves
    n = 6
    keys = reference.edge_keys(np.array([[0, v] for v in range(1, n)]), n,
                               "cpu")
    core, label = reference.core_numbers(keys, n, with_order=True)
    assert core.tolist() == [1] * n
    assert reference.order_violations(keys, n, core, label) == 0
    first = label.clone()
    first[0] = -1
    assert reference.order_violations(keys, n, core, first) == 1


def test_edge_diff_counts_each_difference():
    want = torch.tensor([1, 5, 9, 12])
    assert reference.edge_diff(torch.tensor([12, 9, 5, 1]), want) == 0
    assert reference.edge_diff(torch.tensor([12, 9, 5, 5, 1]), want) == 1
    assert reference.edge_diff(torch.tensor([12, 9, 1]), want) == 1
    assert reference.edge_diff(torch.tensor([12, 9, 7, 1]), want) == 2
    assert reference.remove_keys(want, torch.tensor([5, 12])).tolist() == \
        [1, 9]


def test_roofline_bytes_per_call():
    e, ev, n = 1 << 20, 900_000, 100_000
    assert roofline.stat_bytes(e, ev, n, "mcd") == e + 8 * ev + 8 * n
    assert roofline.call_bytes("fused_removal_round", "x", e, ev, n) == \
        roofline.stat_bytes(e, ev, n, "mcd_hi_dout") + 5 * n
    assert roofline.call_bytes("fused_promotion_stats", "x", e, ev, n) == \
        roofline.stat_bytes(e, ev, n, "hi_dout") + n
    assert roofline.call_bytes("coo_stat", "din", e, ev, n) == \
        e + 8 * ev + 4 * n + 8 * n + n + 4 * n
    # 3.35e12 bytes in one second is the whole roofline
    assert roofline.share(int(3.35e12), 1.0) == pytest.approx(100.0)


@pytest.mark.parametrize("names, found", [
    (["repro_torch", "repro_torch.core.api", "numpy", "torch"], []),
    (["repro"], ["repro"]),
    (["repro.core.api", "repro_torch"], ["repro"]),
    (["jax", "jaxlib.xla_client", "flax.linen"], ["flax", "jax", "jaxlib"]),
    (["jax_like", "reprox", "repro_torchx"], []),
])
def test_import_guard_compares_whole_top_level_names(names, found):
    assert forbidden_modules(names) == found


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


# the default reference keeps the test id of its name before it moved
MOVED = {"references/kcore.py": "reference.py"}


@pytest.mark.parametrize("path", sorted(HERE.rglob("*.py")),
                         ids=lambda p: MOVED.get(f"{p.parent.name}/{p.name}",
                                                 p.name))
def test_no_file_imports_jax_or_the_jax_package(path):
    assert not forbidden_modules(_imports(path))


# the yardstick's files: the default reference under its old name, and
# every generator, traffic kind and reference found by name
YARDSTICK = {"reference": "references/kcore.py", "graphs": "graphs.py",
             "mixes": "mixes.py", "roofline": "roofline.py",
             "control": "control.py", "parts": "parts.py"}
YARDSTICK.update({f"{p.parent.name}/{p.stem}": f"{p.parent.name}/{p.name}"
                  for part in ("generators", "kinds", "references")
                  for p in sorted((HERE / part).glob("*.py"))})


@pytest.mark.parametrize("name", sorted(YARDSTICK))
def test_the_yardstick_imports_nothing_of_the_port(name):
    tops = {m.split(".")[0] for m in _imports(HERE / YARDSTICK[name])}
    assert "repro_torch" not in tops and "repro" not in tops


def _event(name, t0, t1, on_device):
    from types import SimpleNamespace

    from torch.autograd import DeviceType
    return SimpleNamespace(
        name=name, time_range=SimpleNamespace(start=t0, end=t1),
        device_type=DeviceType.CUDA if on_device else DeviceType.CPU)


def test_trace_summary_unions_busy_time_and_labels_idle_gaps():
    from corebench import tracing
    events = [
        _event("burst_remove", 0, 100, False),   # the benchmark's spans
        _event("burst_insert", 100, 200, False),
        _event("burst_remove", 0, 100, True),    # their device annotations
        _event("aten::nonzero", 10, 50, False),
        _event("cudaStreamSynchronize", 150, 190, False),
        _event("void unit_stat_kernel<1>(int const*)", 5, 20, True),
        _event("void removal_round_kernel(int const*)", 15, 30, True),
        _event("void at::native::copy(float)", 60, 70, True),
        _event("void (anonymous namespace)::k()", 120, 150, True),
    ]
    out = tracing.summarize(events, ("burst_remove", "burst_insert"),
                            ["unit_stat_kernel", "removal_round_kernel"])
    assert out["window_s"] == pytest.approx(200e-6)
    # busy: [5, 30] + [60, 70] + [120, 150]
    assert out["busy_s"] == pytest.approx(65e-6)
    assert out["kernel_s"] == pytest.approx(30e-6)
    gaps = dict(out["breakdown"]["idle_gaps"])
    assert gaps["burst_insert/cudaStreamSynchronize"] == pytest.approx(50e-6)
    assert gaps["burst_remove/aten::nonzero"] == pytest.approx(30e-6)
    assert sum(gaps.values()) == pytest.approx(135e-6)
    ops = dict(out["breakdown"]["device_ops"])
    assert ops["k"] == pytest.approx(30e-6)
    assert tracing.kernel_names(HERE.parent / "src" / "repro_torch" / "csrc"
                                / "coremaint.cu")


def test_roofline_reader_counts_each_call_once():
    from corebench.harness import reader
    read = reader("coremaint_kernel_roofline")
    n, m, b = 1000, 50_000, 1_000
    calls = [("fused_removal_round", "mcd_hi_dout", 65536),
             ("coo_stat", "din", 65536)]
    want = (roofline.call_bytes(*calls[0], m - b, n)
            + roofline.call_bytes(*calls[1], m - b, n))
    run = {"n": n, "m": m, "batch_edges": b,
           "trace": {"kernel_s": 1e-3, "calls": calls}}
    assert read(run) == pytest.approx(roofline.share(want, 1e-3))
    assert read({**run, "trace": {"kernel_s": 0.0, "calls": calls}}) is None
    assert read({**run, "trace": None}) is None
