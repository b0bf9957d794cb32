"""The port's 2-axis halo engine (``engine="sharded"``,
``vertex_sharding="halo"``, ``mesh_shape=(d_e, d_v)``) and the sparse
frontier exchange (``frontier_exchange="sparse"``) on 4 gloo ranks
against the reference on 4 forced host devices, batch by batch, bit for
bit: the gathered slot table and weight column, ``n_edges``, capacity,
cores, labels and all 12 BatchStats fields.

* halo on ``(2, 2)``, ``(4, 1)`` and ``(1, 4)``, unweighted and weighted,
  both free-list rankings (interleaved at an odd capacity, hierarchical
  at a tight one, which crosses ``_defrag_to``);
* sparse with pinned caps 1 (every refresh that moves more than one
  owned vertex overflows), 8 and 4,096, on range and on halo ``(2, 2)``,
  ``n_overflow`` and ``max_frontier`` included; with the planned cap
  everything but ``n_overflow`` (the reference plans from the values
  that happen to be computed already, the port from every earlier
  batch's);
* halo ``(1, 4)`` equal to the port's range engine and ``(4, 1)`` to its
  replicated engine, run beside it in the same ranks;
* a checkpoint chain halo ``(2, 2)`` -> unified on 1 -> halo ``(2, 2)``
  in each package, equal across them, and the 4-shard checkpoint
  loading on one device in the other package;
* the memory claim under ``(2, 2)`` with the planned sparse cap, on a
  sparse graph (n = 4,096, 300 edges): every rank holds ``n_owned`` rows
  of ``core``/``label`` and no vertex-domain tensor the layout or its
  session allocates has more than ``max(n_owned, halo_cap)`` rows
  (``record_shapes()``).

One module fixture runs everything once, as
``tests/test_torch_range_ranks.py`` does: the reference in one
subprocess (``XLA_FLAGS=--xla_force_host_platform_device_count=4``) and
the port in 4 rank subprocesses meeting through a ``file://`` store in
``tmp_path``, every process group and every wait with a timeout.
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
SPARSE = (4096, 300, 4, 32)  # the memory case: n, m, batches, batch
TIMEOUT = 300  # seconds, for each process and for the whole run


def _cfg(vs, shape, weighted=False, freelist="interleaved", fx="bitmask",
         fcap=0, beside=None):
    return dict(vs=vs, shape=shape, weighted=weighted, freelist=freelist,
                cap="odd" if freelist == "interleaved" else "tight",
                stream="mixed" if freelist == "interleaved" else "churn",
                fx=fx, fcap=fcap, beside=beside)


BESIDE = {(1, 4): "range", (4, 1): "replicated"}
CONFIGS = [_cfg("halo", s, w, f, beside=BESIDE.get(s))
           for s in ((2, 2), (4, 1), (1, 4)) for w in (False, True)
           for f in ("interleaved", "hierarchical")]
CONFIGS += [_cfg(vs, s, fx="sparse", fcap=c)
            for vs, s in (("range", None), ("halo", (2, 2)))
            for c in (1, 8, 4096, 0)]


def _cid(c):
    mesh = "x".join(map(str, c["shape"])) if c["shape"] else "1d"
    ex = "" if c["fx"] == "bitmask" else f"-sparse{c['fcap'] or 'planned'}"
    return (f"{c['vs']}{mesh}-{c['freelist']}-"
            f"{'weighted' if c['weighted'] else 'unit'}{ex}")


# The stream replay both packages run (the port's generators are numpy
# copies of the reference's): one npz per configuration with the GLOBAL
# state after every batch, and the port's beside engine's beside it.
_REPLAY = textwrap.dedent('''
    import json, sys
    import numpy as np
    N, M, BATCHES, BATCH, CKPT_AT = {consts}
    CONFIGS = json.loads({configs!r})
    STAT_NAMES = ("n_inserted", "n_removed", "insert_rounds", "n_promoted",
                  "v_plus", "remove_rounds", "n_dropped", "renumbered",
                  "n_recycled", "high_water", "max_frontier", "n_overflow")

    def cid(c):
        mesh = "x".join(map(str, c["shape"])) if c["shape"] else "1d"
        ex = ("" if c["fx"] == "bitmask"
              else f"-sparse{{c['fcap'] or 'planned'}}")
        return (f"{{c['vs']}}{{mesh}}-{{c['freelist']}}-"
                f"{{'weighted' if c['weighted'] else 'unit'}}{{ex}}")

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

    def record(rec, t, m, st):
        for key, val in table(m).items():
            rec[f"{{t}}/{{key}}"] = val
        rec[f"{{t}}/stats"] = np.asarray(
            [int(getattr(st, f)) for f in STAT_NAMES], np.int64)

    def run(out, build, is_writer, checkpoint=None, beside=False):
        for k, c in enumerate(CONFIGS):
            g = erdos_renyi(N, M, seed=1)
            w0 = (np.random.default_rng(7).integers(1, 6, g.m)
                  if c["weighted"] else None)
            cap = 2 * g.m + 1 if c["cap"] == "odd" else g.m + 10
            m = build(g, cap, c, w0, c["vs"], c["shape"])
            other = (build(g, cap, c, w0, c["beside"], None)
                     if beside and c["beside"] else None)
            rec = {{"capacity0": np.asarray(m.capacity)}}
            rep = {{}}
            for ev, iw in events(g, c):
                kw = dict(insert_edges=ev.edges, remove_edges=ev.removals,
                          insert_weights=iw)
                record(rec, ev.t, m, m.apply_batch(**kw))
                if other is not None:
                    record(rep, ev.t, other, other.apply_batch(**kw))
                if k == 0 and ev.t == CKPT_AT and checkpoint is not None:
                    checkpoint(m, c)
            if is_writer:
                np.savez(f"{{out}}/{{cid(c)}}.npz", **rec)
                if other is not None:
                    np.savez(f"{{out}}/beside-{{cid(c)}}.npz", **rep)

    def chain(out, pkg, m, load, save_unified):
        # halo (2, 2) -> unified on 1 -> halo (2, 2), one batch on each
        m.save(f"{{out}}/{{pkg}}_halo4.npz")
        mu = load(f"{{out}}/{{pkg}}_halo4.npz", engine="unified")
        save_unified(mu, f"{{out}}/{{pkg}}_unified1.npz")
        mb = load(f"{{out}}/{{pkg}}_unified1.npz", engine="sharded",
                  vertex_sharding="halo")
        ins = np.asarray([[0, 7], [3, 11], [5, 100]])
        rec = {{}}
        for name, mm in (("unified1", mu), ("back4", mb)):
            mm.apply_batch(insert_edges=ins, remove_edges=ins[:1])
            for key, val in table(mm).items():
                rec[f"{{name}}/{{key}}"] = val
        return rec
''')

_REFERENCE = textwrap.dedent('''
    import os, sys, warnings
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    warnings.filterwarnings("ignore")
    import numpy as np
    import jax
    import repro  # enables x64
    from repro.core.api import CoreMaintainer
    from repro.graph.generators import erdos_renyi
    from repro.graph.stream import churn_stream, mixed_stream
    assert len(jax.devices()) == 4, jax.devices()
    out = sys.argv[1]
''') + "{replay}" + textwrap.dedent('''
    def build(g, cap, c, w0, vs, shape):
        m = CoreMaintainer.from_graph(
            g, capacity=cap, engine="sharded", vertex_sharding=vs,
            mesh_shape=None if shape is None else tuple(shape),
            freelist=c["freelist"], weighted=c["weighted"], weights=w0,
            frontier_exchange=c["fx"], frontier_cap=c["fcap"])
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
        def load(path, **kw):
            if kw.get("vertex_sharding") == "halo":
                kw["mesh_shape"] = (2, 2)
            return CoreMaintainer.load(path, freelist=c["freelist"]
                                       if kw["engine"] == "sharded"
                                       else "interleaved", **kw)
        rec = chain(out, "ref", m, load, lambda mu, p: mu.save(p))
        np.savez(f"{out}/ref_ckpt_chain.npz", **rec)

    run(out, build, True, checkpoint)
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
    from repro_torch.core.vertex_layout import record_shapes
    from repro_torch.graph.generators import erdos_renyi
    from repro_torch.graph.stream import churn_stream, mixed_stream
    from repro_torch.launch.mesh import make_edge_mesh, make_edge_vertex_mesh
    # every mesh built once, in the same order on every rank (a mesh's
    # groups are collective to build)
    MESHES = {None: make_edge_mesh()}
    for shape in ((2, 2), (4, 1), (1, 4)):
        MESHES[shape] = make_edge_vertex_mesh(mesh_shape=shape)
''') + "{replay}" + textwrap.dedent('''
    def build(g, cap, c, w0, vs, shape):
        shape = None if shape is None else tuple(shape)
        m = CoreMaintainer.from_graph(
            g, capacity=cap, engine="sharded", vertex_sharding=vs,
            freelist=c["freelist"], weighted=c["weighted"], weights=w0,
            device="cpu", mesh=MESHES[shape],
            frontier_exchange=c["fx"] if vs != "replicated" else "bitmask",
            frontier_cap=c["fcap"] if vs != "replicated" else 0)
        assert m.capacity % world == 0 and m.src.shape[0] * world == (
            m.capacity)
        if vs != "replicated":
            d_v = shape[1] if shape else world
            assert m.core.shape == m.label.shape == (-(-g.n // d_v),)
        return m

    def table(m):
        s = m.state()  # a collective: every rank gathers
        t = {k: s[k] for k in ("src", "dst", "valid", "n_edges", "core",
                                "label", "capacity")}
        if m.weighted:
            t["w"] = s["w"]
        return t

    def checkpoint(m, c):
        def load(path, **kw):
            if kw.get("vertex_sharding") == "halo":
                kw.update(mesh=MESHES[(2, 2)], freelist=c["freelist"])
            return CoreMaintainer.load(path, device="cpu", **kw)

        def save_unified(mu, path):
            if rank == 0:
                mu.save(path)
            dist.barrier()

        rec = chain(out, "port", m, load, save_unified)
        if rank == 0:
            np.savez(f"{out}/port_ckpt_chain.npz", **rec)

    run(out, build, rank == 0, checkpoint, beside=True)

    # the memory claim under (2, 2), on a sparse graph whose halo is
    # below n_pad, with the planned sparse cap
    n, m_edges, batches, batch = {sparse}
    g = erdos_renyi(n, m_edges, seed=4)
    mm = CoreMaintainer.from_graph(g, engine="sharded", device="cpu",
                                   mesh=MESHES[(2, 2)],
                                   vertex_sharding="halo",
                                   frontier_exchange="sparse")
    mem = {"n_owned": np.asarray(-(-n // 2)),
           "n_pad": np.asarray(-(-n // 2) * 2)}
    for ev in mixed_stream(g, batches, batch, seed=8):
        with record_shapes() as shapes:
            mm.apply_batch(insert_edges=ev.edges, remove_edges=ev.removals)
        mem[f"{ev.t}/core_rows"] = np.asarray(mm.core.shape[0])
        mem[f"{ev.t}/label_rows"] = np.asarray(mm.label.shape[0])
        mem[f"{ev.t}/halo_cap"] = np.asarray(
            [r for op, r in shapes if op == "halo_ids"][0])
        mem[f"{ev.t}/max_rows"] = np.asarray(max(r for _, r in shapes))
        mem[f"{ev.t}/n_tensors"] = np.asarray(len(shapes))
        mem[f"{ev.t}/refreshes"] = np.asarray(
            sum(op == "refresh" for op, _ in shapes))
    mem["cores"] = mm.cores()
    mem["edges"] = mm.state()["valid"].sum()
    np.savez(f"{out}/memory-rank{rank}.npz", **mem)
    dist.barrier()
    dist.destroy_process_group()
    print(f"rank {rank} OK")
''')


def _script(body: str) -> str:
    replay = _REPLAY.format(consts=repr((N, M, BATCHES, BATCH, CKPT_AT)),
                            configs=json.dumps(CONFIGS))
    return body.replace("{replay}", replay).replace("{sparse}",
                                                    repr(SPARSE))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Run the reference (into ``ref/``) and the 4 ranks (into
    ``port/``) at once; return the directory."""
    out = tmp_path_factory.mktemp("halo4")
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


def _assert_same(got, want, where, skip_stats=()):
    assert got.keys() == want.keys(), where
    for k in sorted(want):
        g, w = got[k], want[k]
        if k.endswith("/stats") and skip_stats:
            keep = [i for i in range(len(w)) if i not in skip_stats]
            g, w = g[keep], w[keep]
        np.testing.assert_array_equal(g, w, err_msg=f"{where} {k}")


N_OVERFLOW = 11  # its index in the stats rows


@pytest.mark.parametrize("config", CONFIGS, ids=_cid)
def test_halo_ranks_match_reference_4dev(runs, config):
    """The gathered slot table (and weight column), n_edges, capacity,
    cores, labels and the 12 stats equal the reference's 4-device engine
    after every batch (the planned cap: all but ``n_overflow``); the
    tight capacity grew through ``_defrag_to``; a cap of 1 overflowed."""
    got = _load(runs / "port" / f"{_cid(config)}.npz")
    want = _load(runs / "ref" / f"{_cid(config)}.npz")
    planned = config["fx"] == "sparse" and config["fcap"] == 0
    _assert_same(got, want, _cid(config),
                 skip_stats=(N_OVERFLOW,) if planned else ())
    assert len([k for k in got if k.endswith("/core")]) == BATCHES
    assert int(got["capacity0"]) % WORLD == 0
    if config["cap"] == "tight":
        assert int(got[f"{BATCHES - 1}/capacity"]) > int(got["capacity0"])
    overflows = sum(int(got[f"{t}/stats"][N_OVERFLOW])
                    for t in range(BATCHES))
    if config["fx"] == "bitmask" or config["fcap"] == 4096:
        assert overflows == 0
    if config["fcap"] == 1:
        assert overflows > 0


@pytest.mark.parametrize("config", [c for c in CONFIGS if c["beside"]],
                         ids=_cid)
def test_degenerate_halo_meshes_match_the_one_axis_engines(runs, config):
    """``(1, 4)`` gives the range engine's, and ``(4, 1)`` the replicated
    engine's, slot table, weights, ``n_edges``, cores, labels and stats
    after every batch, on the same 4 ranks."""
    got = _load(runs / "port" / f"{_cid(config)}.npz")
    beside = _load(runs / "port" / f"beside-{_cid(config)}.npz")
    got.pop("capacity0")
    _assert_same(got, beside, f"{_cid(config)} vs {config['beside']}")


def test_halo_checkpoint_chain_matches_reference(runs):
    """Halo ``(2, 2)`` -> unified on 1 -> halo ``(2, 2)``, a batch on
    each: the port's chain equals the reference's, file and state."""
    _assert_same(_load(runs / "port" / "port_halo4.npz"),
                 _load(runs / "ref" / "ref_halo4.npz"), "halo4 ckpt")
    _assert_same(_load(runs / "port" / "port_unified1.npz"),
                 _load(runs / "ref" / "ref_unified1.npz"), "unified1 ckpt")
    _assert_same(_load(runs / "port" / "port_ckpt_chain.npz"),
                 _load(runs / "ref" / "ref_ckpt_chain.npz"), "chain")


@pytest.mark.parametrize("direction", ["port-to-ref", "ref-to-port"])
def test_halo4_checkpoint_loads_in_the_other_package(runs, direction):
    """A ``(2, 2)`` halo checkpoint of one package is unpadded and loads
    on one device in the other; the two continue identically."""
    src_pkg = "port" if direction == "port-to-ref" else "ref"
    path = str(runs / src_pkg / f"{src_pkg}_halo4.npz")
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
def test_halo_rank_memory_stays_owned_plus_halo(runs, rank):
    """The memory claim under ``(2, 2)`` with the planned sparse cap: the
    halo cap stays below ``n_pad``, ``core`` and ``label`` keep
    ``n_owned`` = n / d_v rows after every batch, no vertex-domain
    tensor the layout or its session allocates has more than
    ``max(n_owned, halo_cap)`` rows, the sparse refresh ran, and the
    cores are BZ's."""
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
    assert sum(int(z[f"{t}/refreshes"]) for t in range(batches)) > 0
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
