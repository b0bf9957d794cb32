"""The port's sharded engine on 4 gloo ranks (``engine="sharded"``,
``vertex_sharding="replicated"``) against the reference's sharded engine
on 4 forced host devices, batch by batch, bit for bit: the gathered slot
table and weight column, ``n_edges``, cores, labels and all 12
BatchStats fields, for both streams, both free-list rankings,
unweighted and weighted, at an odd capacity (the divisibility pad) and a
tight one (which crosses ``_defrag_to``). Cores and labels are also held
to the port's unified engine. Plus checkpoints across shard counts and
packages (sharded over 4 -> unified on 1 -> sharded over 4), the
k-core applications over the gathered table, and the core-only building
blocks ``make_sharded_remove`` /
``make_sharded_insert_round`` against BZ.

One module fixture runs everything once: the reference in one
subprocess (``XLA_FLAGS=--xla_force_host_platform_device_count=4``) and
the port in 4 rank subprocesses that meet through a ``file://`` store in
``tmp_path`` (no TCP port to collide between test workers), every
process group and every wait with a timeout of its own.
"""
import itertools
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("jax", reason="the reference package runs on jax")
from repro.core.api import CoreMaintainer as JaxMaintainer  # noqa: E402
from repro.core.oracle import bz_from_csr  # noqa: E402
from repro.graph.csr import add_edges_csr, remove_edges_csr  # noqa: E402
from repro.graph.generators import erdos_renyi  # noqa: E402
from repro_torch.core.api import CoreMaintainer  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
N, M, BATCHES, BATCH = 120, 480, 6, 24
CKPT_AT = 2  # the checkpoint is taken after this batch of CONFIGS[0]
KCORE_KS = (3, 5)  # k of the k-core subgraphs taken after the last batch
TIMEOUT = 240  # seconds, for each process and for the whole run

CONFIGS = [dict(stream=s, freelist=f, weighted=w, cap=c)
           for s, f, w, c in itertools.product(
               ("mixed", "churn"), ("interleaved", "hierarchical"),
               (False, True), ("odd", "tight"))]


def _cid(c):
    return (f"{c['stream']}-{c['freelist']}-"
            f"{'weighted' if c['weighted'] else 'unit'}-{c['cap']}")


# The stream replay both packages run: the same graph, streams and
# weights (the port's generators are numpy copies of the reference's),
# one npz per configuration with the GLOBAL state after every batch.
_REPLAY = textwrap.dedent('''
    import json, sys
    import numpy as np
    N, M, BATCHES, BATCH, CKPT_AT, KCORE_KS = {consts}
    CONFIGS = json.loads({configs!r})
    STAT_NAMES = ("n_inserted", "n_removed", "insert_rounds", "n_promoted",
                  "v_plus", "remove_rounds", "n_dropped", "renumbered",
                  "n_recycled", "high_water", "max_frontier", "n_overflow")

    def cid(c):
        return (f"{{c['stream']}}-{{c['freelist']}}-"
                f"{{'weighted' if c['weighted'] else 'unit'}}-{{c['cap']}}")

    def events(g, c):
        if c["stream"] == "mixed":
            st = mixed_stream(g, BATCHES, BATCH, seed=3)
        else:
            st = churn_stream(g, BATCHES, BATCH, same_batch_roundtrip=True,
                              dirty=True, seed=6)
        for ev in st:
            iw = (np.random.default_rng(1000 + ev.t).integers(
                1, 6, len(ev.edges)) if c["weighted"] else None)
            yield ev, iw

    def run(out, build, table, is_writer, checkpoint=None):
        g = erdos_renyi(N, M, seed=1)
        for k, c in enumerate(CONFIGS):
            w0 = (np.random.default_rng(7).integers(1, 6, g.m)
                  if c["weighted"] else None)
            cap = 2 * g.m + 1 if c["cap"] == "odd" else g.m + 10
            m = build(g, cap, c, w0)
            rec = {{"capacity0": np.asarray(m.capacity)}}
            for ev, iw in events(g, c):
                st = m.apply_batch(insert_edges=ev.edges,
                                   remove_edges=ev.removals,
                                   insert_weights=iw)
                for key, val in table(m).items():
                    rec[f"{{ev.t}}/{{key}}"] = val
                rec[f"{{ev.t}}/stats"] = np.asarray(
                    [int(getattr(st, f)) for f in STAT_NAMES], np.int64)
                if k == 0 and ev.t == CKPT_AT and checkpoint is not None:
                    checkpoint(m, c)
            # the applications read the whole table: the k-core's
            # nodes, edges and the global edge mask
            kc = {{}}
            for kk in KCORE_KS:
                nodes, edges = kcore_subgraph(m, kk)
                kc[f"{{kk}}/nodes"], kc[f"{{kk}}/edges"] = nodes, edges
                kc[f"{{kk}}/mask"] = np.asarray(kcore_edge_mask(m, kk))
            if is_writer:
                np.savez(f"{{out}}/{{cid(c)}}.npz", **rec)
                np.savez(f"{{out}}/kcore-{{cid(c)}}.npz", **kc)
''')

_REFERENCE = textwrap.dedent('''
    import os, sys, warnings
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    warnings.filterwarnings("ignore")
    import numpy as np
    import jax
    import repro  # enables x64
    import types
    import jax.numpy as jnp
    from repro.core import applications
    from repro.core.api import CoreMaintainer
    from repro.graph.generators import erdos_renyi
    from repro.graph.stream import churn_stream, mixed_stream
    assert len(jax.devices()) == 4, jax.devices()
    out = sys.argv[1]

    # The reference's applications index the replicated vertex state
    # with the slot columns; on its 4-device engine those columns are
    # sharded and jax refuses the gather (ShardingTypeError), so its
    # functions run on the gathered table: the same function, the same
    # global slot table.
    def _gathered(m):
        return types.SimpleNamespace(**{
            k: jnp.asarray(np.asarray(getattr(m, k)))
            for k in ("src", "dst", "valid", "core")})

    def kcore_subgraph(m, k):
        return applications.kcore_subgraph(_gathered(m), k)

    def kcore_edge_mask(m, k):
        return applications.kcore_edge_mask(_gathered(m), k)
''') + "{replay}" + textwrap.dedent('''
    def build(g, cap, c, w0):
        m = CoreMaintainer.from_graph(
            g, capacity=cap, engine="sharded", freelist=c["freelist"],
            weighted=c["weighted"], weights=w0)
        assert m.capacity % 4 == 0
        return m

    def table(m):
        t = dict(src=np.asarray(m.src), dst=np.asarray(m.dst),
                 valid=np.asarray(m.valid), n_edges=np.asarray(m.n_edges),
                 core=m.cores(), label=m.labels(),
                 capacity=np.asarray(m.capacity))
        if m.weighted:
            t["w"] = np.asarray(m.w)
        return t

    def checkpoint(m, c):
        # sharded over 4 -> unified on 1 -> sharded over 4, one batch on
        # each, in the reference package
        m.save(f"{out}/ref_sharded4.npz")
        mu = CoreMaintainer.load(f"{out}/ref_sharded4.npz", engine="unified")
        mu.save(f"{out}/ref_unified1.npz")
        mb = CoreMaintainer.load(f"{out}/ref_unified1.npz",
                                 engine="sharded", freelist=c["freelist"])
        ins = np.asarray([[0, 7], [3, 11], [5, 100]])
        rec = {}
        for name, mm in (("unified1", mu), ("back4", mb)):
            mm.apply_batch(insert_edges=ins, remove_edges=ins[:1])
            for key, val in table(mm).items():
                rec[f"{name}/{key}"] = val
        np.savez(f"{out}/ref_ckpt_chain.npz", **rec)

    run(out, build, table, True, checkpoint)
    print("reference OK")
''')

_RANK = textwrap.dedent('''
    import datetime, os, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    out, rank, world, store = sys.argv[1], int(sys.argv[2]), int(
        sys.argv[3]), sys.argv[4]
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    from repro_torch.core.api import CoreMaintainer
    from repro_torch.core.applications import kcore_edge_mask, kcore_subgraph
    from repro_torch.core.sharded import (make_sharded_insert_round,
                                          make_sharded_remove, shard_edges)
    from repro_torch.graph.generators import erdos_renyi
    from repro_torch.graph.stream import churn_stream, mixed_stream
    from repro_torch.launch.mesh import make_edge_mesh
    mesh = make_edge_mesh()
''') + "{replay}" + textwrap.dedent('''
    def build(g, cap, c, w0):
        m = CoreMaintainer.from_graph(
            g, capacity=cap, engine="sharded", freelist=c["freelist"],
            weighted=c["weighted"], weights=w0, device="cpu", mesh=mesh)
        assert m.capacity % world == 0 and m.src.shape[0] * world == (
            m.capacity)
        return m

    def table(m):
        s = m.state()  # a collective: every rank gathers the table
        t = {k: s[k] for k in ("src", "dst", "valid", "n_edges", "core",
                                "label", "capacity")}
        if m.weighted:
            t["w"] = s["w"]
        return t

    def checkpoint(m, c):
        # sharded over 4 -> unified on 1 -> sharded over 4, one batch on
        # each, in the port
        m.save(f"{out}/port_sharded4.npz")  # rank 0 writes, then a barrier
        mu = CoreMaintainer.load(f"{out}/port_sharded4.npz", device="cpu",
                                 engine="unified")
        if rank == 0:
            mu.save(f"{out}/port_unified1.npz")
        dist.barrier()
        mb = CoreMaintainer.load(f"{out}/port_unified1.npz", device="cpu",
                                 engine="sharded", freelist=c["freelist"],
                                 mesh=mesh)
        ins = np.asarray([[0, 7], [3, 11], [5, 100]])
        rec = {}
        for name, mm in (("unified1", mu), ("back4", mb)):
            mm.apply_batch(insert_edges=ins, remove_edges=ins[:1])
            for key, val in table(mm).items():
                rec[f"{name}/{key}"] = val
        if rank == 0:
            np.savez(f"{out}/port_ckpt_chain.npz", **rec)

    run(out, build, table, rank == 0, checkpoint)

    # the core-only building blocks, as tests/test_sharded_core.py drives
    # the reference's: a removal fixpoint and host-looped insert rounds
    g = erdos_renyi(64, 256, seed=0)
    m = CoreMaintainer.from_graph(g, capacity=512, device="cpu")
    rm = g.edge_array()[np.random.default_rng(0).choice(g.m, 12,
                                                          replace=False)]
    valid = m.valid.clone()
    valid[[m.edge_slot[(int(a), int(b))] for a, b in rm]] = False
    src, dst, val = shard_edges(mesh, "data", m.src, m.dst, valid)
    core_rm = make_sharded_remove(mesh, m.n)(src, dst, val, m.core)

    g2 = erdos_renyi(64, 200, seed=1)
    m2 = CoreMaintainer.from_graph(g2, capacity=1024, device="cpu")
    rng = np.random.default_rng(1)
    batch = []
    while len(batch) < 10:
        u, v = rng.integers(0, 64, size=2)
        key = (int(min(u, v)), int(max(u, v)))
        if u == v or g2.has_edge(*key) or key in batch:
            continue
        batch.append(key)
    arr = np.asarray(batch, dtype=np.int64)
    ne = int(m2.n_edges)
    src, dst, val = m2.src.clone(), m2.dst.clone(), m2.valid.clone()
    src[ne:ne + len(arr)] = torch.from_numpy(arr[:, 0]).int()
    dst[ne:ne + len(arr)] = torch.from_numpy(arr[:, 1]).int()
    val[ne:ne + len(arr)] = True
    ssrc, sdst, sval = shard_edges(mesh, "data", src, dst, val)
    round_fn = make_sharded_insert_round(mesh, m2.n)
    core, label = m2.core, m2.label
    for _ in range(8):  # host round loop
        ec, el = core.numpy(), label.numpy()
        root = np.where((ec[arr[:, 0]] < ec[arr[:, 1]])
                        | ((ec[arr[:, 0]] == ec[arr[:, 1]])
                           & (el[arr[:, 0]] < el[arr[:, 1]])),
                        arr[:, 0], arr[:, 1])
        seed = torch.zeros(m2.n, dtype=torch.bool)
        seed[torch.from_numpy(root)] = True
        new_core, promoted = round_fn(ssrc, sdst, sval, core, label, seed)
        if int(promoted.sum()) == 0:
            break
        core = new_core
        # promoted -> head of the new level (host side, small batch)
        lab, prom, nc = el.copy(), promoted.numpy(), new_core.numpy()
        for lvl in np.unique(nc[prom]):
            movers = np.nonzero(prom & (nc == lvl))[0]
            others = np.nonzero((~prom) & (nc == lvl))[0]
            base = lab[others].min() if others.size else 0
            order = movers[np.argsort(lab[movers])]
            for i, v in enumerate(order):
                lab[v] = base - (len(order) - i) * (1 << 20)
        label = torch.from_numpy(lab)
    if rank == 0:
        np.savez(f"{out}/core_only.npz", remove=core_rm.numpy(),
                 insert=core.numpy(), rm_edges=rm, ins_edges=arr)
    dist.barrier()
    dist.destroy_process_group()
    print(f"rank {rank} OK")
''')


def _script(body: str) -> str:
    replay = _REPLAY.format(
        consts=repr((N, M, BATCHES, BATCH, CKPT_AT, KCORE_KS)),
        configs=json.dumps(CONFIGS))
    return body.replace("{replay}", replay)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Run the reference (into ``ref/``) and the 4 ranks (into
    ``port/``) at once; return the directory."""
    out = tmp_path_factory.mktemp("sharded4")
    (out / "ref").mkdir()
    (out / "port").mkdir()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu")
    ref_py, rank_py = out / "reference.py", out / "rank.py"
    ref_py.write_text(_script(_REFERENCE))
    rank_py.write_text(_script(_RANK))
    cmds = [[sys.executable, str(ref_py), str(out / "ref")]]
    cmds += [[sys.executable, str(rank_py), str(out / "port"), str(r),
              str(WORLD), str(out / "store")] for r in range(WORLD)]
    procs = [subprocess.Popen(c, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for c in cmds]
    logs = []
    try:
        for p in procs:
            o, e = p.communicate(timeout=TIMEOUT)
            logs.append((p.returncode, o, e))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for i, (rc, o, e) in enumerate(logs):
        who = "reference" if i == 0 else f"rank {i - 1}"
        assert rc == 0, f"{who} failed:\n{o}\n{e[-4000:]}"
    return out


def _load(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _assert_same(got, want, where):
    assert got.keys() == want.keys(), where
    for k in sorted(want):
        np.testing.assert_array_equal(got[k], want[k],
                                      err_msg=f"{where} {k}")


@pytest.mark.parametrize("config", CONFIGS, ids=_cid)
def test_ranks_match_reference_4dev(runs, config):
    """The gathered slot table (and weight column), n_edges, capacity,
    cores, labels and the 12 stats equal the reference's 4-device run
    after every batch; the tight capacity grew through _defrag_to."""
    got = _load(runs / "port" / f"{_cid(config)}.npz")
    want = _load(runs / "ref" / f"{_cid(config)}.npz")
    _assert_same(got, want, _cid(config))
    assert len([k for k in got if k.endswith("/core")]) == BATCHES
    # 2m + 1 and m + 10 slots do not split over 4 shards: both padded
    assert int(got["capacity0"]) % WORLD == 0
    if config["cap"] == "tight":
        assert int(got[f"{BATCHES - 1}/capacity"]) > int(got["capacity0"])


@pytest.mark.parametrize("config", CONFIGS, ids=_cid)
def test_ranks_match_port_unified(runs, config):
    """Cores and labels equal the port's unified engine on one device
    (the slot table differs: the slots depend on the shard count)."""
    from repro_torch.graph.generators import erdos_renyi as port_er
    from repro_torch.graph.stream import churn_stream, mixed_stream
    got = _load(runs / "port" / f"{_cid(config)}.npz")
    g = port_er(N, M, seed=1)
    w0 = (np.random.default_rng(7).integers(1, 6, g.m)
          if config["weighted"] else None)
    cap = 2 * g.m + 1 if config["cap"] == "odd" else g.m + 10
    mu = CoreMaintainer.from_graph(g, capacity=cap, device="cpu",
                                   weighted=config["weighted"], weights=w0)
    if config["stream"] == "mixed":
        st = mixed_stream(g, BATCHES, BATCH, seed=3)
    else:
        st = churn_stream(g, BATCHES, BATCH, same_batch_roundtrip=True,
                          dirty=True, seed=6)
    for ev in st:
        iw = (np.random.default_rng(1000 + ev.t).integers(
            1, 6, len(ev.edges)) if config["weighted"] else None)
        mu.apply_batch(insert_edges=ev.edges, remove_edges=ev.removals,
                       insert_weights=iw)
        np.testing.assert_array_equal(got[f"{ev.t}/core"], mu.cores())
        np.testing.assert_array_equal(got[f"{ev.t}/label"], mu.labels())
        assert int(got[f"{ev.t}/n_edges"]) == int(mu.n_edges)


@pytest.mark.parametrize("config", CONFIGS, ids=_cid)
def test_kcore_subgraph_matches_reference_4dev(runs, config):
    """``kcore_subgraph`` and ``kcore_edge_mask`` on 4 ranks return the
    WHOLE k-core (every rank gathers the table): the same nodes, edges
    and global mask as the reference's functions over the reference's
    4-device table."""
    got = _load(runs / "port" / f"kcore-{_cid(config)}.npz")
    want = _load(runs / "ref" / f"kcore-{_cid(config)}.npz")
    _assert_same(got, want, _cid(config))
    table = _load(runs / "port" / f"{_cid(config)}.npz")
    last = BATCHES - 1
    for k in KCORE_KS:
        mask = got[f"{k}/mask"]
        assert mask.shape == table[f"{last}/valid"].shape
        keep = table[f"{last}/core"] >= k
        edges = got[f"{k}/edges"]
        assert len(edges) == int(mask.sum()) > 0
        assert keep[edges].all()


def test_checkpoint_chain_matches_reference(runs):
    """Sharded over 4 -> unified on 1 -> sharded over 4, a batch on each:
    the port's chain equals the reference's, file and state."""
    _assert_same(_load(runs / "port" / "port_sharded4.npz"),
                 _load(runs / "ref" / "ref_sharded4.npz"), "sharded4 ckpt")
    _assert_same(_load(runs / "port" / "port_unified1.npz"),
                 _load(runs / "ref" / "ref_unified1.npz"), "unified1 ckpt")
    _assert_same(_load(runs / "port" / "port_ckpt_chain.npz"),
                 _load(runs / "ref" / "ref_ckpt_chain.npz"), "chain")


@pytest.mark.parametrize("direction", ["port-to-ref", "ref-to-port"])
def test_sharded4_checkpoint_loads_in_the_other_package(runs, direction):
    """A 4-shard checkpoint of one package loads on one device in the
    other, and the two continue identically."""
    src_pkg = "port" if direction == "port-to-ref" else "ref"
    path = str(runs / src_pkg / f"{src_pkg}_sharded4.npz")
    jm = JaxMaintainer.load(path, engine="unified")
    tm = CoreMaintainer.load(path, device="cpu", engine="unified")
    ins = np.asarray([[1, 9], [2, 50], [4, 4]])
    jm.apply_batch(insert_edges=ins)
    tm.apply_batch(insert_edges=ins)
    np.testing.assert_array_equal(tm.cores(), jm.cores())
    np.testing.assert_array_equal(tm.labels(), jm.labels())
    np.testing.assert_array_equal(tm.src.numpy(), np.asarray(jm.src))
    np.testing.assert_array_equal(tm.valid.numpy(), np.asarray(jm.valid))
    assert tm.edge_slot == jm.edge_slot


@pytest.mark.parametrize("which", ["remove", "insert"])
def test_core_only_blocks_match_bz(runs, which):
    """``make_sharded_remove`` and the host-looped
    ``make_sharded_insert_round`` over 4 ranks give the BZ cores."""
    z = _load(runs / "port" / "core_only.npz")
    if which == "remove":
        want = bz_from_csr(remove_edges_csr(erdos_renyi(64, 256, seed=0),
                                            z["rm_edges"]))
    else:
        want = bz_from_csr(add_edges_csr(erdos_renyi(64, 200, seed=1),
                                         z["ins_edges"]))
    np.testing.assert_array_equal(z[which], want)
