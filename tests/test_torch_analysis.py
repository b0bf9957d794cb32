"""The port's auditor (``src/repro_torch/analysis/``) on a world of ONE
gloo rank, in process.

Two layers, as the reference's ``tests/test_analysis.py``:

* seeded violations — for each rule, a program (or a record of one)
  built to break exactly that invariant, so the rule is shown to fire
  and to name what broke: histogram drift, a vertex-sized psum inside a
  round, a round op mismatch, a lying traffic note, an extra sync, a
  large device-to-host copy, a state tensor neither written in place
  nor freed, ``1 << 62`` narrowed to int32, a lattice over budget and a
  bucket outside it;
* the real engines — every rule passes on every config against the
  committed manifests; each sharded config's round schedules (``setup``
  / ``main`` / ``overflow``, ``vertex_halo`` and the sparse config's
  dense fallback included) equal the reference's LIVE
  ``trace_*_round`` traces op for op and byte for byte through
  ``TRAFFIC_TO_PRIM`` (never its committed manifests, whose own tests
  fail on every run); the formula helpers equal the reference's; the
  host-sync lint gives the reference's findings on its seeded snippets
  and passes on the port's targets under ``SYNC_SITES``; the report and
  manifest schemas round-trip.

The 4-rank audits are in ``tests/test_torch_analysis_ranks.py``, the
memory formulas in ``tests/test_torch_memory_audit.py``. The checks
only the card can make (the kernel rounds against their torch twin)
carry the ``gpu`` marker and skip here.
"""
import dataclasses
import datetime
import json
import textwrap

import pytest
import torch
import torch.distributed as dist

pytest.importorskip("jax", reason="the reference package runs on jax")
import jax  # noqa: E402
from repro.analysis import hostlint as ref_hostlint  # noqa: E402
from repro.analysis import memory as ref_memory  # noqa: E402
from repro.analysis import programs as ref_programs  # noqa: E402
from repro.analysis import rules as ref_rules  # noqa: E402
from repro_torch.analysis import audit, hostlint, memory, programs  # noqa: E402
from repro_torch.analysis import rules, walker  # noqa: E402
from repro_torch.analysis.programs import (AuditParams,  # noqa: E402
                                           ENGINE_CONFIGS, record_program,
                                           run_engine)
from repro_torch.analysis.walker import RoundRecorder, Site  # noqa: E402
from repro_torch.core import vertex_layout  # noqa: E402
from repro_torch.core.sharded import make_sharded_remove  # noqa: E402
from repro_torch.launch import mesh as port_mesh  # noqa: E402

SHARDED = sorted(n for n, c in ENGINE_CONFIGS.items()
                 if c.is_sharded and n != "cuda")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """A world of one gloo rank, rendezvous through a file store."""
    store = dist.FileStore(str(tmp_path_factory.mktemp("pg") / "store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=60))
    try:
        yield
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(world):
    """Every config's recorded run at ``AuditParams`` (one each)."""
    return {name: run_engine(name, device="cpu") for name in ENGINE_CONFIGS}


def _run(run, budget, name):
    return rules.run_rules(run, budget, names=[name])[name]


def _budget(name, **over):
    b = audit.load_budget(name)
    b.update(over)
    return b


# -- the real engines ---------------------------------------------------------
def test_every_rule_passes_on_the_committed_manifests(runs):
    """All rules, all configs, at one rank (the ``"1x1"`` sections)."""
    for name, run in runs.items():
        for rname, finds in rules.run_rules(
                run, audit.load_budget(name)).items():
            assert finds == [], (name, rname, [f.message for f in finds])


def test_audit_engines_report(world):
    rep = audit.audit_engines(["unified", "vertex_halo"], device="cpu")
    assert rep["ok"] and rep["schema"] == audit.SCHEMA
    assert not rep["not_run"]
    # the twin check applies to the kernel config only
    assert {c["rule"] for c in rep["checks"]} == set(rules.RULES) - {
        "launch_budget_twin"}
    assert rep["n_devices"] == 1 and rep["device"] == "cpu"


def _ref_sides(closed):
    setup, main, over, stray = ref_rules.split_round_collectives(closed)
    assert not stray
    return {k: [(c.op, c.out_bytes) for c in v]
            for k, v in (("setup", setup), ("main", main),
                         ("overflow", over))}


@pytest.mark.parametrize("name", SHARDED)
def test_round_schedules_equal_the_reference_traces(world, runs, name):
    """Each round's setup / main / overflow schedule equals the
    reference's live trace at one device, op for op and byte for byte
    (the overflow arm from the port's overflow-seeded run)."""
    run = runs[name]
    cfg = ENGINE_CONFIGS[name]
    p = AuditParams()
    jmesh = ref_programs.resolve_mesh(ref_programs.ENGINE_CONFIGS[name], 1)
    assert run.rounds
    for rname, (log, sites) in run.rounds.items():
        got = rules.round_schedule(log, sites)
        if rname in run.overflow:
            got["overflow"] = rules.round_schedule(
                *run.overflow[rname])["overflow"]
        if rname == "weighted_round":
            _, jx = ref_programs.trace_weighted_round(p.n, p.capacity, jmesh)
        else:
            halo = cfg.vertex_sharding in ("range", "halo")
            fcap = run.frontier_cap if cfg.frontier_exchange == "sparse" \
                else None
            fn = (ref_programs.trace_removal_round if rname ==
                  "removal_round" else ref_programs.trace_promotion_round)
            _, jx = fn(cfg.vertex_sharding, p.n, p.capacity, jmesh,
                       frontier_cap=fcap, lanes=p.lanes,
                       window=run.window if halo else None)
        assert got == _ref_sides(jx), (name, rname)


def test_traffic_prims_cover_the_reference_mapping():
    for op, prim in ref_rules.TRAFFIC_TO_PRIM.items():
        assert rules.TRAFFIC_TO_PRIM[op] == prim


# -- seeded violations --------------------------------------------------------
def test_seeded_collective_histogram_drift(runs):
    run = runs["sharded"]
    budget = _budget("sharded", program_collectives={
        "apply_batch": {"psum": 2}})
    finds = _run(run, budget, "collective_budget")
    assert any(f.program == "apply_batch" and "drifted" in f.message
               and "psum" in f.message for f in finds)


def test_seeded_vertex_psum_in_a_round(world, runs, monkeypatch):
    """An n-sized all-reduce slipped into the range layout's round (here
    into ``any_owned``) fires as a vertex-sized psum inside a round."""
    run = runs["vertex_range"]
    real = vertex_layout.HaloSession.any_owned

    def leaky(self, owned_mask):
        vertex_layout.psum(torch.zeros(run.sizes["n"], dtype=torch.int32),
                           self.axis, "psum")
        return real(self, owned_mask)

    monkeypatch.setattr(vertex_layout.HaloSession, "any_owned", leaky)
    mesh = programs.resolve_mesh(run.config)
    seeded = programs.run_removal_round("range", 192, 384, mesh,
                                        window=run.window, device="cpu")
    bad = dataclasses.replace(run, rounds={"removal_round": seeded},
                              overflow={})
    finds = _run(bad, audit.load_budget("vertex_range"),
                 "collective_budget")
    assert any("vertex-sized psum" in f.message and "192 elems"
               in f.message for f in finds)


def test_seeded_round_op_mismatch(runs):
    run = runs["vertex_range"]
    budget = audit.load_budget("vertex_range")
    budget["rounds"]["removal_round"]["setup"][1]["op"] = "psum"
    finds = _run(run, budget, "collective_budget")
    assert any("removal_round/setup[1]" in f.message and "psum" in f.message
               and "reduce_scatter" in f.message for f in finds)


def test_seeded_lying_traffic_note(runs):
    """A tampered byte note (the set-up regather) no longer matches the
    c10d op the recorder saw: the cross-check names it."""
    run = runs["vertex_range"]
    log, sites = run.rounds["removal_round"]
    assert log[1].op == "regather"
    lied = [log[0], dataclasses.replace(log[1],
                                        recv_bytes=log[1].recv_bytes + 4)]
    lied += log[2:]
    bad = dataclasses.replace(run, rounds={"removal_round": (lied, sites)},
                              overflow={})
    finds = _run(bad, audit.load_budget("vertex_range"), "collective_budget")
    assert any("cross-check" in f.message and "reduce_scatter" in f.message
               and "regather" in f.message for f in finds)


def test_seeded_extra_sync(world, runs):
    """A program that syncs where no ``SYNC_SITES`` entry names it (the
    core-only sharded removal's own loop) fires, naming the site."""
    n = 16
    mesh = port_mesh.make_edge_mesh()
    fn = make_sharded_remove(mesh, n)
    src = torch.tensor([0, 1, 2], dtype=torch.int32)
    dst = torch.tensor([1, 2, 0], dtype=torch.int32)
    valid = torch.ones(3, dtype=torch.bool)
    core = torch.full((n,), 3, dtype=torch.int32)
    pr = record_program(fn, [src, dst, valid, core], {"core": 3}, {})
    bad = dataclasses.replace(runs["sharded"],
                              programs={"apply_batch": pr}, rounds={})
    finds = _run(bad, audit.load_budget("sharded"), "host_sync")
    assert any("extra round sync" in f.message
               and "core/sharded.py::fn" in f.message for f in finds)


def _site(**kw):
    base = dict(op="_to_copy", kind="op", round=0, in_round=False,
                round_func="", where="core/engine.py::batch_program",
                line=1)
    base.update(kw)
    return Site(**base)


def test_seeded_large_device_to_host_copy(runs):
    run = runs["unified"]
    pr = run.programs["apply_batch"]
    pr2 = dataclasses.replace(pr, sites=pr.sites + [_site(
        sync="round", d2h_bytes=4096)])
    bad = dataclasses.replace(run, programs={"apply_batch": pr2})
    finds = _run(bad, audit.load_budget("unified"), "host_sync")
    assert any("copies 4096B" in f.message and "(>= 1024B)" in f.message
               for f in finds)


_KEPT = []


def _keeps_core(src, dst, valid, core, label, n_edges):
    """A seeded program that stashes its input ``core`` and returns a
    new one: neither in place nor freed."""
    _KEPT.append(core)
    return src, dst, valid, core + 1, label, n_edges


def test_seeded_state_neither_in_place_nor_freed(runs):
    z = torch.zeros(8, dtype=torch.int32)
    args = [z, z.clone(), torch.zeros(8, dtype=torch.bool), z.clone(),
            torch.zeros(8, dtype=torch.int64),
            torch.zeros((), dtype=torch.int32)]
    state = {k: i for i, k in enumerate(programs.DONATED_STATE_ARGS)}
    pr = record_program(_keeps_core, args, state, dict(state))
    _KEPT.clear()
    assert "core" not in pr.in_place and "core" not in pr.freed
    bad = dataclasses.replace(runs["unified"], programs={"apply_batch": pr})
    finds = _run(bad, audit.load_budget("unified"), "donation")
    assert [f for f in finds if "'core'" in f.message]
    assert not [f for f in finds if "'label'" in f.message]


def test_seeded_sentinel_narrowing():
    """``1 << 62`` pushed through an int32 cast is caught, with the
    sentinel named; comparing against it or narrowing an argsort's
    indices is not; the sorted keys themselves are."""
    x = torch.zeros(4, dtype=torch.int64)
    big = 1 << 62
    finds = walker.tainted_truncations(lambda a: (a + big).to(torch.int32),
                                       x)
    assert any("int64->torch.int32" in f or "torch.int64->torch.int32" in f
               for f in finds)
    assert any("1 << 62" in f for f in finds)

    def clean(a):
        flag = a == big
        perm = torch.argsort(a + big)
        return torch.where(flag, 1, 0).to(torch.int32), perm.to(torch.int32)

    assert walker.tainted_truncations(clean, x) == []
    assert walker.tainted_truncations(
        lambda a: torch.sort(a + big).values.to(torch.int32), x) != []


def test_seeded_dtype_policy_fires_through_the_rule(runs):
    run = runs["unified"]
    pr = dataclasses.replace(run.programs["apply_batch"],
                             narrowings=["torch.int64->torch.int32 ..."])
    bad = dataclasses.replace(run, programs={"apply_batch": pr})
    assert _run(bad, audit.load_budget("unified"), "dtype_policy")


def test_seeded_recompile_surface(runs):
    run = runs["sharded"]
    finds = _run(run, {"max_jit_variants": 1}, "recompile_surface")
    assert any("max_jit_variants=1" in f.message for f in finds)
    off = dataclasses.replace(run, window=7)
    finds = _run(off, {"max_jit_variants": 99}, "recompile_surface")
    assert any("unplanned variant" in f.message for f in finds)


def test_seeded_launch_histogram_drift(runs):
    run = runs["sharded"]
    budget = audit.load_budget("sharded")
    budget["round_launches"]["1x1"]["removal_round"] = {"index": 1}
    finds = _run(run, budget, "launch_budget")
    assert any("launch histogram drifted" in f.message for f in finds)


def test_seeded_missing_mesh_section(runs):
    budget = audit.load_budget("sharded")
    del budget["host_sync"]["1x1"], budget["memory"]["1x1"]
    assert any("no host_sync budget for mesh 1x1" in f.message
               for f in _run(runs["sharded"], budget, "host_sync"))
    assert any("no memory section for mesh 1x1" in f.message
               for f in _run(runs["sharded"], budget, "memory_budget"))


# -- the recorder -----------------------------------------------------------
def test_recorder_sees_collectives_syncs_and_rounds(world):
    mesh = port_mesh.make_edge_mesh()
    g = mesh.get_group("data")
    x = torch.arange(8)
    with RoundRecorder() as rec:
        vertex_layout.psum(x.clone(), g)
        vertex_layout.pmax(x.clone(), g)
        vertex_layout.pmin(x.clone(), g)
        vertex_layout.all_gather(x, g, "gather_halo")
        vertex_layout._gather_into(x, g)
        vertex_layout._reduce_scatter(x.reshape(1, -1), g)
        bool(x.any())
        x[x > 3]
    cols = walker.collectives(rec.sites)
    assert [c.op for c in cols] == ["psum", "pmax", "pmin", "all_gather",
                                    "all_gather", "reduce_scatter"]
    assert [c.out_bytes for c in cols] == [64] * 6
    # the c10d names gloo dispatches, each mapped (COLLECTIVE_OPS)
    names = [s.op for s in rec.sites if s.kind == "collective"]
    assert names[:4] == ["allreduce_"] * 3 + ["allgather_"]
    assert set(names) <= set(walker.COLLECTIVE_OPS)
    assert [s.sync for s in rec.sites if s.sync] == ["round", "hidden"]
    assert rec.round == 1
    assert walker.count_collectives(rec.sites) == {
        "psum": 1, "pmax": 1, "pmin": 1, "all_gather": 2,
        "reduce_scatter": 1}


def test_rounds_and_round_launches_come_from_the_fixpoints(runs):
    log, sites = runs["sharded"].rounds["removal_round"]
    inside = [s for s in sites if s.in_round]
    assert inside and {s.round_func for s in inside} == {"removal_fixpoint"}
    hist = walker.count_round_launches(sites)
    assert hist.get("index_add_", 0) >= 2  # the torch stat's scatter pair


def test_each_loop_condition_syncs_once_an_iteration(runs):
    """The interpreter's loop count (``walker.LoopCounter``) against the
    recorded loop-condition syncs, on every config's batch program."""
    for name, run in runs.items():
        for prog, pr in run.programs.items():
            assert rules.loop_sync_mismatches(pr.sites, pr.iterations) \
                == [], (name, prog)
    it = runs["unified"].programs["apply_batch"].iterations
    assert it["core/remove.py::removal_fixpoint"] >= 1
    assert it["core/insert.py::_forward_reach"] >= 1


def test_loop_counter_on_a_stream_batch():
    """Rounds, waves and eviction rounds of a real mixed batch: the
    fixpoints' iterations equal the batch stats' rounds, and each loop
    condition synced once an iteration."""
    from repro_torch.core.api import CoreMaintainer
    from repro_torch.graph.generators import rmat
    from repro_torch.graph.stream import mixed_stream
    g = rmat(8, 1200, seed=0)
    m = CoreMaintainer.from_graph(g, device="cpu")
    ev = next(iter(mixed_stream(g, 1, 96, seed=0)))
    with RoundRecorder() as rec:
        st = m.apply_batch(insert_edges=ev.edges, remove_edges=ev.removals)
    it = rec.iterations
    assert it["core/remove.py::removal_fixpoint"] == int(st.remove_rounds)
    assert it["core/insert.py::promotion_fixpoint"] == int(st.insert_rounds)
    assert it["core/insert.py::_forward_reach"] >= int(st.insert_rounds)
    assert rules.loop_sync_mismatches(rec.sites, it) == []


def test_seeded_loop_condition_syncing_twice(runs):
    """A loop condition that syncs twice an iteration fires, in the
    helper and in the ``host_sync`` rule."""
    run = runs["unified"]
    pr = run.programs["apply_batch"]
    where = "core/insert.py::_forward_reach"
    [s] = [s for s in pr.sites if s.where == where and s.sync == "round"][:1]
    twice = list(pr.sites) + [s]
    assert any(where in m and "1 an iteration" in m
               for m in rules.loop_sync_mismatches(twice, pr.iterations))
    bad = dataclasses.replace(run, programs={
        "apply_batch": dataclasses.replace(pr, sites=twice)})
    finds = _run(bad, audit.load_budget("unified"), "host_sync")
    assert any("iterations of its loop" in f.message for f in finds)


def test_twin_check_is_not_run_on_the_host(runs, capsys):
    """On the host the kernels' twin claim reports itself not run: never
    ok, and named in the report and on the verdict line."""
    twin = rules.run_rules(runs["cuda"], audit.load_budget("cuda"))[
        "launch_budget_twin"]
    assert isinstance(twin, rules.NotRun) and "card" in twin.reason
    assert "launch_budget_twin" not in rules.run_rules(
        runs["sharded"], audit.load_budget("sharded"))
    chk = audit.make_check("launch_budget_twin", "cuda", twin)
    assert chk["status"] == "not run" and not chk["ok"]
    rep = audit.make_report([chk, audit.make_check("host_sync", "cuda", [])])
    assert rep["ok"] and rep["not_run"] == ["cuda/launch_budget_twin"]
    audit._print_summary(rep)
    out = capsys.readouterr().out
    assert "[skip]" in out and "[ok  ]" in out
    assert "1 check(s) not run: cuda/launch_budget_twin" in out


def test_seeded_twin_violations_fire(runs, monkeypatch):
    """The twin check on card-shaped sites: a kernel round launching as
    many CUDA kernels as its twin, or a collective the twin lacks,
    fires."""
    base = dict(op="x", kind="op", round=0, in_round=True,
                round_func="removal_fixpoint",
                where="core/remove.py::removal_fixpoint", line=1)
    sync = Site(**dict(base, op="_local_scalar_dense", sync="round"))

    def sites(n, extra=()):
        return [sync, *extra, Site(**dict(
            base, op="cuda_kernels", kind="cuda", launches=n,
            where="audit:removal_fixpoint:0"))]

    psum = Site(**dict(base, op="allreduce_", kind="collective",
                       prim="psum", out_bytes=8, out_elems=2))
    monkeypatch.setattr(rules, "twin_rounds", lambda run: [
        ("removal_round", sites(48, [psum]), sites(48))])
    card = dataclasses.replace(runs["cuda"], device="cuda")
    finds = _run(card, audit.load_budget("cuda"), "launch_budget_twin")
    msgs = [f.message for f in finds]
    assert any("STRICTLY" in m and "48" in m for m in msgs), msgs
    assert any("collective schedule diverged" in m for m in msgs), msgs
    monkeypatch.setattr(rules, "twin_rounds", lambda run: [
        ("removal_round", sites(13), sites(48))])
    assert _run(card, audit.load_budget("cuda"), "launch_budget_twin") == []


def test_round_kernels_split_at_the_loop_syncs():
    """The card's per-round CUDA kernel count: one ``kind="cuda"`` site a
    profiled range, the ranges past the last loop-condition sync left
    out (no round)."""
    base = dict(op="x", kind="op", round=0, in_round=True,
                round_func="removal_fixpoint",
                where="core/remove.py::removal_fixpoint", line=1)
    sites = [
        Site(**dict(base, op="_local_scalar_dense", sync="round")),
        Site(**dict(base, op="cuda_kernels", kind="cuda", launches=7,
                    where="audit:removal_fixpoint:0")),
        Site(**dict(base, op="cuda_kernels", kind="cuda", launches=0,
                    where="audit:removal_fixpoint:1")),
    ]
    assert walker.cuda_round_kernels(sites) == {
        "audit:removal_fixpoint:0": 7, "audit:removal_fixpoint:1": 0}
    assert rules.round_kernels(sites) == {"audit:removal_fixpoint:0": 7}
    assert rules.round_launches(sites, "cuda") == {"cuda_kernels": 7}
    assert rules.round_launches(sites, "cpu") == {}
    assert walker.kernel_name(
        "void at::native::(anonymous namespace)::reduce_kernel<512, 1>"
        "(int)") == "reduce_kernel"


# -- formula helpers (copied from the reference) ------------------------------
def test_eval_and_guess_formula_equal_the_reference():
    env = dict(n=64, d=8, n_owned=8, n_pad=64, cap=16, lanes=8, window=16,
               local_cap=32, d_v=8, hcap=32)
    for expr in ("n_owned * 3 * 4", "d * (cap + 1) * 4",
                 "d * ceil_div(n_owned, 8)", 42, "max(d_v - 1, 1)",
                 "min(n, cap) - 3"):
        assert rules.eval_formula(expr, env) == ref_rules.eval_formula(
            expr, env)
    for bad in ("bogus + 1", "__import__('os')"):
        with pytest.raises(ValueError):
            rules.eval_formula(bad, env)
    for nbytes in (8 * 3 * 4, 8 * 17 * 4, 1234567, 4, 64 * 4, 32 * 8):
        assert rules.guess_formula(nbytes, env) == ref_rules.guess_formula(
            nbytes, env)
    env_b = dict(env, d=1, n_owned=64, d_v=1)
    assert rules.guess_formula(256, env, 256, env_b) == \
        ref_rules.guess_formula(256, env, 256, env_b)
    assert rules.FORMULA_CANDIDATES == ref_rules.FORMULA_CANDIDATES


def test_dim_formula_equals_the_reference():
    envs = [dict(n=192, n_owned=24, d=8, d_e=4, d_v=2, cap=16, hcap=64,
                 window=16, local_cap=48, lanes=8),
            dict(n=192, n_owned=192, d=1, d_e=1, d_v=1, cap=16, hcap=64,
                 window=16, local_cap=384, lanes=8)]
    for values in ([194, 194], [17, 17], [48, 384], [24, 192], [8, 8],
                   [1, 1], [128, 64], [3, 3], [192, 192]):
        assert memory._dim_formula(values, envs) == \
            ref_memory._dim_formula(values, envs), values
    assert memory.DIM_CANDIDATES[:len(ref_memory.DIM_CANDIDATES)] == \
        ref_memory.DIM_CANDIDATES


# -- the host-sync lint ---------------------------------------------------------
_LINT_FIXTURE = textwrap.dedent(
    """
    import numpy as np

    class M:
        def apply_batch(self):
            a = int(self.n_edges)
            b = self.core.block_until_ready()
            c = float(self.label[0])
            d = np.asarray(self.valid)
            e = self.n_edges.item()
            f = int(self.n_edges)  # sync: ok
            g = int(self.capacity)
            return a

        def _refresh_bounds(self):
            return int(self.n_edges)
    """
)
_REMOVE_FIXTURE = textwrap.dedent(
    """
    import numpy as np

    def weighted_core_fixpoint_pass(src, dst, valid, w, core, n):
        maxw = int(w)                 # device column: sync
        cap = int(w.shape[0])         # static aval metadata: fine
        tw = np.asarray(total_w)      # sync: ok  (reviewed)
        return core
    """
)
_ENGINE_FIXTURE = textwrap.dedent(
    """
    def batch_program(src, dst, valid, core, label, n_edges, n):
        rounds = int(n)           # static python int: fine
        width = bool(n_edges)     # device scalar: sync
        return core

    def helper_outside_set(core):
        return int(core)
    """
)


@pytest.mark.parametrize("text,funcs", [
    (_LINT_FIXTURE, None),
    (_REMOVE_FIXTURE, frozenset({"weighted_core_fixpoint_pass"})),
    (_ENGINE_FIXTURE, frozenset({"batch_program"})),
], ids=["api", "remove", "engine"])
def test_hostlint_gives_the_reference_findings(tmp_path, text, funcs):
    p = tmp_path / "fixture.py"
    p.write_text(text)
    want = [(f.func, f.lineno) for f in ref_hostlint.lint_file(str(p),
                                                                funcs)]
    got = [(f.func, f.lineno) for f in hostlint.lint_file(str(p), funcs)]
    assert got == want and want


def test_hostlint_targets_are_clean_under_sync_sites():
    assert hostlint.lint_targets() == []
    assert hostlint.main([]) == 0


def test_hostlint_fires_on_an_unnamed_sync():
    """Without its ``SYNC_SITES`` entry the removal loop's condition
    fires; renaming the function drops the entry the same way."""
    sites = [s for s in hostlint.SYNC_SITES
             if s.where != "core/remove.py::removal_fixpoint"]
    finds = hostlint.lint_file(hostlint.REMOVE_PATH, sites=sites)
    assert [(f.func, "bool(" in f.message) for f in finds] == [
        ("removal_fixpoint", True)]


def test_sync_sites_name_the_roadmap_lines():
    """The loop conditions the ROADMAP's parked list names each have an
    entry, with a reason and a per-iteration count."""
    wheres = {s.where for s in hostlint.SYNC_SITES if s.kind == "round"}
    for w in ("core/remove.py::removal_fixpoint",
              "core/remove.py::weighted_core_fixpoint_pass",
              "core/remove.py::removal_fixpoint_halo",
              "core/remove.py::_weighted_h_index_halo",
              "core/remove.py::weighted_core_fixpoint_pass_halo",
              "core/insert.py::promotion_fixpoint",
              "core/insert.py::_forward_reach",
              "core/insert.py::_evict_fixpoint",
              "core/insert.py::promotion_fixpoint_halo",
              "core/insert.py::_forward_reach_halo",
              "core/insert.py::_evict_fixpoint_halo",
              "core/graph_ops.py::weighted_h_index",
              "core/order.py::maybe_renumber",
              "core/order.py::maybe_renumber_ring"):
        assert w in wheres, w
    assert all(s.why and s.per and s.count >= 1
               for s in hostlint.SYNC_SITES)


# -- schemas -------------------------------------------------------------------
def test_report_and_budget_schemas_round_trip(world, tmp_path):
    f = rules.Finding("host_sync", "unified", "msg", "apply_batch")
    chk = audit.make_check("host_sync", "unified", [f])
    rep = audit.make_report([chk], n_devices=1)
    assert json.loads(json.dumps(rep)) == rep
    assert rep["schema"] == audit.SCHEMA and not rep["ok"]
    for name in ENGINE_CONFIGS:
        b = audit.load_budget(name)
        assert b["schema"] == audit.BUDGET_SCHEMA and b["engine"] == name
    part = audit.budget_part("unified", device="cpu")
    gen = audit.generate_budget("unified", [json.loads(json.dumps(part))])
    path = audit.write_budget(gen, str(tmp_path))
    again = audit.load_budget("unified", str(tmp_path))
    assert again == json.loads(open(path).read())
    assert rules.run_rules(run_engine("unified", device="cpu"), again) == {
        r: [] for r in rules.RULES if r != "launch_budget_twin"}
    bad = dict(again, schema="repro.analysis/budget/v4")
    audit.write_budget(bad, str(tmp_path))
    with pytest.raises(ValueError, match="schema"):
        audit.load_budget("unified", str(tmp_path))


def test_cli_runs_a_world_of_one(tmp_path, capsys):
    """``python -m repro_torch.analysis.audit`` (in this process's
    code path; a world of its own is spawned only for --world > 1)."""
    out = tmp_path / "rep.json"
    code = audit.main(["--engine", "host", "--device", "cpu", "--out",
                       str(out)])
    assert code == 0 and json.loads(out.read_text())["ok"]
    assert "audit PASS" in capsys.readouterr().out


def test_device_cuda_without_a_card_refuses(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert audit.main(["--engine", "unified", "--device", "cuda"]) == 2
    assert "does not drop to the host" in capsys.readouterr().err
    # the card is the default, as for the port's other entry points
    assert audit.main(["--engine", "unified"]) == 2
    assert "--device cpu" in capsys.readouterr().err
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_engine("unified")


# -- on the card ---------------------------------------------------------------
@pytest.mark.gpu
def test_cuda_config_beats_its_torch_twin_on_the_card():
    """The card audit of the ``cuda`` config: the kernel rounds launch
    strictly fewer CUDA kernels than their torch twin over the same
    collectives, and every rule passes (and runs) against the
    ``"1x1@cuda"`` sections."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run on the card only")
    rep = audit._in_world(1, ["--engine", "cuda,unified"], "cuda")
    assert rep["ok"], [c for c in rep["checks"] if not c["ok"]]
    assert not rep["not_run"]
    [twin] = [c for c in rep["checks"] if c["rule"] == "launch_budget_twin"]
    assert twin["engine"] == "cuda" and twin["status"] == "ok"


@pytest.mark.gpu
def test_large_device_to_host_copy_is_recorded_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: a device-to-host copy")
    x = torch.zeros(1024, dtype=torch.int32, device="cuda")
    with RoundRecorder() as rec:
        x.cpu()
    [s] = [s for s in rec.sites if s.d2h_bytes]
    assert s.d2h_bytes == 4096 and s.sync == "round"


def test_jax_stays_on_the_host():
    assert jax.devices()[0].platform == "cpu"
