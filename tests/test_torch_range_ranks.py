"""The port's range-sharded engine on 4 gloo ranks (``engine="sharded"``,
``vertex_sharding="range"``: each rank owns 30 of the 120 vertices and a
per-batch halo) against the reference's range engine on 4 forced host
devices, batch by batch, bit for bit: the gathered slot table and weight
column, ``n_edges``, cores, labels and all 12 BatchStats fields, for
both streams, unweighted and weighted, interleaved at an odd capacity
(the divisibility pad) and hierarchical at a tight one (which crosses
``_defrag_to``), and on n = 122 (two phantom vertices pad the state to
4 x 31). Cores and labels are also held to the port's
replicated engine at 4 ranks, run beside it in the same ranks. Plus
checkpoints between the packages and the engines (range over 4 ->
unified on 1 -> range over 4, and across the packages), the k-core
applications over the gathered state, and the memory claim: on a sparse
graph (n = 4,096, 300 edges) whose halo is smaller than ``n_pad``, every
rank holds ``core``/``label`` of ``n_owned`` rows after every batch and
no vertex-domain tensor of the layout outgrows ``max(n_owned,
halo_cap)``.

One module fixture runs everything once: the reference in one
subprocess (``XLA_FLAGS=--xla_force_host_platform_device_count=4``) and
the port in 4 rank subprocesses that meet through a ``file://`` store in
``tmp_path``, every process group and every wait with a timeout of its
own. The replicated engine's 4-rank runs are in
``tests/test_torch_sharded_ranks.py``.
"""
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
from repro_torch.core.api import CoreMaintainer  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
N, M, BATCHES, BATCH = 120, 480, 6, 24
CKPT_AT = 2  # the checkpoint is taken after this batch of CONFIGS[0]
KCORE_KS = (3, 5)  # k of the k-core subgraphs taken after the last batch
SPARSE = (4096, 300, 4, 32)  # the memory case: n, m, batches, batch
TIMEOUT = 300  # seconds, for each process and for the whole run

CONFIGS = [dict(stream=s, weighted=w, freelist=f, cap=c, n=N)
           for s in ("mixed", "churn") for w in (False, True)
           for f, c in (("interleaved", "odd"), ("hierarchical", "tight"))]
# n = 122 does not split over 4 owners: 2 phantom vertices pad the state
CONFIGS += [dict(stream="mixed", weighted=w, freelist="interleaved",
                 cap="odd", n=N + 2) for w in (False, True)]


def _cid(c):
    return (f"{c['stream']}-{c['freelist']}-"
            f"{'weighted' if c['weighted'] else 'unit'}-{c['cap']}"
            + ("" if c["n"] == N else f"-n{c['n']}"))


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
                f"{{'weighted' if c['weighted'] else 'unit'}}-{{c['cap']}}"
                + ("" if c["n"] == N else f"-n{{c['n']}}"))

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

    def run(out, build, table, is_writer, checkpoint=None, beside=None):
        for k, c in enumerate(CONFIGS):
            g = erdos_renyi(c["n"], M, seed=1)
            w0 = (np.random.default_rng(7).integers(1, 6, g.m)
                  if c["weighted"] else None)
            cap = 2 * g.m + 1 if c["cap"] == "odd" else g.m + 10
            m = build(g, cap, c, w0, "range")
            other = None if beside is None else build(g, cap, c, w0,
                                                      "replicated")
            rec = {{"capacity0": np.asarray(m.capacity)}}
            rep = {{}}
            for ev, iw in events(g, c):
                st = m.apply_batch(insert_edges=ev.edges,
                                   remove_edges=ev.removals,
                                   insert_weights=iw)
                for key, val in table(m).items():
                    rec[f"{{ev.t}}/{{key}}"] = val
                rec[f"{{ev.t}}/stats"] = np.asarray(
                    [int(getattr(st, f)) for f in STAT_NAMES], np.int64)
                if other is not None:
                    other.apply_batch(insert_edges=ev.edges,
                                      remove_edges=ev.removals,
                                      insert_weights=iw)
                    rep[f"{{ev.t}}/core"] = other.cores()
                    rep[f"{{ev.t}}/label"] = other.labels()
                if k == 0 and ev.t == CKPT_AT and checkpoint is not None:
                    checkpoint(m, c)
            kc = {{}}
            for kk in KCORE_KS:
                nodes, edges = kcore_subgraph(m, kk)
                kc[f"{{kk}}/nodes"], kc[f"{{kk}}/edges"] = nodes, edges
                kc[f"{{kk}}/mask"] = np.asarray(kcore_edge_mask(m, kk))
            if is_writer:
                np.savez(f"{{out}}/{{cid(c)}}.npz", **rec)
                np.savez(f"{{out}}/kcore-{{cid(c)}}.npz", **kc)
                if other is not None:
                    np.savez(f"{{out}}/replicated-{{cid(c)}}.npz", **rep)
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

    # The reference's applications index the vertex state with the
    # slot columns; on its 4-device engine both are sharded and jax
    # refuses the gather, so its functions run on the gathered state:
    # the same function, the same global table and cores (the phantom
    # tail of a padded state cut off).
    def _gathered(m):
        cols = {k: jnp.asarray(np.asarray(getattr(m, k)))
                for k in ("src", "dst", "valid")}
        return types.SimpleNamespace(core=jnp.asarray(m.cores()), **cols)

    def kcore_subgraph(m, k):
        return applications.kcore_subgraph(_gathered(m), k)

    def kcore_edge_mask(m, k):
        return applications.kcore_edge_mask(_gathered(m), k)
''') + "{replay}" + textwrap.dedent('''
    def build(g, cap, c, w0, vs):
        m = CoreMaintainer.from_graph(
            g, capacity=cap, engine="sharded", vertex_sharding=vs,
            freelist=c["freelist"], weighted=c["weighted"], weights=w0)
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
        # range over 4 -> unified on 1 -> range over 4, one batch on
        # each, in the reference package
        m.save(f"{out}/ref_range4.npz")
        mu = CoreMaintainer.load(f"{out}/ref_range4.npz", engine="unified")
        mu.save(f"{out}/ref_unified1.npz")
        mb = CoreMaintainer.load(f"{out}/ref_unified1.npz",
                                 engine="sharded", vertex_sharding="range",
                                 freelist=c["freelist"])
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
    from repro_torch.core.engine import halo_cap_for
    from repro_torch.core.vertex_layout import record_shapes
    from repro_torch.graph.generators import erdos_renyi
    from repro_torch.graph.stream import churn_stream, mixed_stream
    from repro_torch.launch.mesh import make_edge_mesh
    mesh = make_edge_mesh()
''') + "{replay}" + textwrap.dedent('''
    def build(g, cap, c, w0, vs):
        m = CoreMaintainer.from_graph(
            g, capacity=cap, engine="sharded", vertex_sharding=vs,
            freelist=c["freelist"], weighted=c["weighted"], weights=w0,
            device="cpu", mesh=mesh)
        assert m.capacity % world == 0 and m.src.shape[0] * world == (
            m.capacity)
        if vs == "range":
            assert m.core.shape == m.label.shape == (-(-g.n // world),)
        return m

    def table(m):
        s = m.state()  # a collective: every rank gathers
        t = {k: s[k] for k in ("src", "dst", "valid", "n_edges", "core",
                                "label", "capacity")}
        if m.weighted:
            t["w"] = s["w"]
        return t

    def checkpoint(m, c):
        # range over 4 -> unified on 1 -> range over 4, one batch on
        # each, in the port
        m.save(f"{out}/port_range4.npz")  # rank 0 writes, then a barrier
        mu = CoreMaintainer.load(f"{out}/port_range4.npz", device="cpu",
                                 engine="unified")
        if rank == 0:
            mu.save(f"{out}/port_unified1.npz")
        dist.barrier()
        mb = CoreMaintainer.load(f"{out}/port_unified1.npz", device="cpu",
                                 engine="sharded", vertex_sharding="range",
                                 freelist=c["freelist"], mesh=mesh)
        ins = np.asarray([[0, 7], [3, 11], [5, 100]])
        rec = {}
        for name, mm in (("unified1", mu), ("back4", mb)):
            mm.apply_batch(insert_edges=ins, remove_edges=ins[:1])
            for key, val in table(mm).items():
                rec[f"{name}/{key}"] = val
        if rank == 0:
            np.savez(f"{out}/port_ckpt_chain.npz", **rec)

    run(out, build, table, rank == 0, checkpoint, beside=True)

    # the memory claim, on a sparse graph whose halo is below n_pad
    n, m_edges, batches, batch = {sparse}
    g = erdos_renyi(n, m_edges, seed=4)
    mm = CoreMaintainer.from_graph(g, engine="sharded", device="cpu",
                                   mesh=mesh, vertex_sharding="range")
    mem = {"n_owned": np.asarray(-(-n // world)),
           "n_pad": np.asarray(-(-n // world) * world)}
    for ev in mixed_stream(g, batches, batch, seed=8):
        with record_shapes() as shapes:
            mm.apply_batch(insert_edges=ev.edges, remove_edges=ev.removals)
        mem[f"{ev.t}/core_rows"] = np.asarray(mm.core.shape[0])
        mem[f"{ev.t}/label_rows"] = np.asarray(mm.label.shape[0])
        mem[f"{ev.t}/halo_cap"] = np.asarray(
            [r for op, r in shapes if op == "halo_ids"][0])
        mem[f"{ev.t}/max_rows"] = np.asarray(max(r for _, r in shapes))
        mem[f"{ev.t}/n_tensors"] = np.asarray(len(shapes))
    mem["cores"] = mm.cores()
    mem["edges"] = mm.state()["valid"].sum()
    np.savez(f"{out}/memory-rank{rank}.npz", **mem)
    dist.barrier()
    dist.destroy_process_group()
    print(f"rank {rank} OK")
''')


def _script(body: str) -> str:
    replay = _REPLAY.format(
        consts=repr((N, M, BATCHES, BATCH, CKPT_AT, KCORE_KS)),
        configs=json.dumps(CONFIGS))
    return body.replace("{replay}", replay).replace("{sparse}",
                                                    repr(SPARSE))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Run the reference (into ``ref/``) and the 4 ranks (into
    ``port/``) at once; return the directory."""
    out = tmp_path_factory.mktemp("range4")
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
def test_range_ranks_match_reference_4dev(runs, config):
    """The gathered slot table (and weight column), n_edges, capacity,
    cores, labels and the 12 stats equal the reference's 4-device range
    engine after every batch; the tight capacity grew through
    _defrag_to."""
    got = _load(runs / "port" / f"{_cid(config)}.npz")
    want = _load(runs / "ref" / f"{_cid(config)}.npz")
    _assert_same(got, want, _cid(config))
    assert len([k for k in got if k.endswith("/core")]) == BATCHES
    assert int(got["capacity0"]) % WORLD == 0
    if config["cap"] == "tight":
        assert int(got[f"{BATCHES - 1}/capacity"]) > int(got["capacity0"])


@pytest.mark.parametrize("config", CONFIGS, ids=_cid)
def test_range_ranks_match_port_replicated_4ranks(runs, config):
    """Cores and labels equal the port's replicated engine on the same 4
    ranks after every batch (same shard count, so the same slots).
    With a phantom tail (n = 122) the ring renumber ranks the two
    phantom vertices (core 0, label 0) too, as the reference's range
    engine does (``test_range_ranks_match_reference_4dev`` holds that
    bit for bit): a renumbered label is then offset by the phantoms
    ranked below it, so there the cores are equal and the labels give
    the same k-order."""
    got = _load(runs / "port" / f"{_cid(config)}.npz")
    rep = _load(runs / "port" / f"replicated-{_cid(config)}.npz")
    for t in range(BATCHES):
        core, label = got[f"{t}/core"], got[f"{t}/label"]
        np.testing.assert_array_equal(core, rep[f"{t}/core"])
        if config["n"] % WORLD == 0:
            np.testing.assert_array_equal(label, rep[f"{t}/label"])
        else:
            np.testing.assert_array_equal(
                np.lexsort((label, core)),
                np.lexsort((rep[f"{t}/label"], rep[f"{t}/core"])))


@pytest.mark.parametrize("config", CONFIGS, ids=_cid)
def test_range_kcore_matches_reference_4dev(runs, config):
    """``kcore_subgraph`` and ``kcore_edge_mask`` on 4 range ranks
    gather the cores with the table: the whole k-core, the reference's
    nodes, edges and mask."""
    got = _load(runs / "port" / f"kcore-{_cid(config)}.npz")
    want = _load(runs / "ref" / f"kcore-{_cid(config)}.npz")
    _assert_same(got, want, _cid(config))
    assert all(len(got[f"{k}/edges"]) > 0 for k in KCORE_KS)


def test_range_checkpoint_chain_matches_reference(runs):
    """Range over 4 -> unified on 1 -> range over 4, a batch on each:
    the port's chain equals the reference's, file and state."""
    _assert_same(_load(runs / "port" / "port_range4.npz"),
                 _load(runs / "ref" / "ref_range4.npz"), "range4 ckpt")
    _assert_same(_load(runs / "port" / "port_unified1.npz"),
                 _load(runs / "ref" / "ref_unified1.npz"), "unified1 ckpt")
    _assert_same(_load(runs / "port" / "port_ckpt_chain.npz"),
                 _load(runs / "ref" / "ref_ckpt_chain.npz"), "chain")


@pytest.mark.parametrize("direction", ["port-to-ref", "ref-to-port"])
def test_range4_checkpoint_loads_in_the_other_package(runs, direction):
    """A 4-owner range checkpoint of one package is unpadded and loads
    on one device in the other; the two continue identically."""
    src_pkg = "port" if direction == "port-to-ref" else "ref"
    path = str(runs / src_pkg / f"{src_pkg}_range4.npz")
    jm = JaxMaintainer.load(path, engine="unified")
    tm = CoreMaintainer.load(path, device="cpu", engine="unified")
    assert tm.core.shape == (N,)
    ins = np.asarray([[1, 9], [2, 50], [4, 4]])
    jm.apply_batch(insert_edges=ins)
    tm.apply_batch(insert_edges=ins)
    np.testing.assert_array_equal(tm.cores(), jm.cores())
    np.testing.assert_array_equal(tm.labels(), jm.labels())
    np.testing.assert_array_equal(tm.src.numpy(), np.asarray(jm.src))
    assert tm.edge_slot == jm.edge_slot


@pytest.mark.parametrize("rank", range(WORLD))
def test_range_rank_memory_stays_owned_plus_halo(runs, rank):
    """The memory claim on a sparse graph: the halo cap stays below
    ``n_pad``, ``core`` and ``label`` keep ``n_owned`` rows after every
    batch, and no vertex-domain tensor the layout or its session
    allocates has more than ``max(n_owned, halo_cap)`` rows. The cores
    are BZ's."""
    from repro.core.oracle import bz_from_csr
    from repro.graph.csr import build_csr
    from repro.graph.generators import erdos_renyi
    from repro.graph.stream import mixed_stream
    z = _load(runs / "port" / f"memory-rank{rank}.npz")
    n, m, batches, batch = SPARSE
    n_owned, n_pad = int(z["n_owned"]), int(z["n_pad"])
    for t in range(batches):
        hcap = int(z[f"{t}/halo_cap"])
        assert hcap < n_pad
        assert int(z[f"{t}/core_rows"]) == int(z[f"{t}/label_rows"]) == n_owned
        assert 0 < int(z[f"{t}/max_rows"]) <= max(n_owned, hcap)
        assert int(z[f"{t}/n_tensors"]) > 0
    g = erdos_renyi(n, m, seed=4)
    live = {tuple(e) for e in g.edge_array().tolist()}
    for ev in mixed_stream(g, batches, batch, seed=8):
        for a, b in ev.removals.tolist():
            live.discard((min(a, b), max(a, b)))
        for a, b in ev.edges.tolist():
            if a != b:
                live.add((min(a, b), max(a, b)))
    want = bz_from_csr(build_csr(n, np.asarray(sorted(live))))
    np.testing.assert_array_equal(z["cores"], want)
    assert int(z["edges"]) == len(live)
