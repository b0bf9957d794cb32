"""The port's memory audit (``repro_torch/analysis/memory.py``): live
storage bytes over recorded runs, and the committed formulas.

* in process, on a world of one gloo rank: the liveness the recorder
  measures (an input that dies is freed at once, a kept one stays, a
  view keeps its storage), the at-rest formulas against the real state
  tensors exactly, the peak formulas at the held-out size point
  (``memory.HELD_OUT``, never a fit point), and the seeded violations
  (a wrong peak formula, a missing section, an in-place drift);
* on 4 gloo ranks (one spawned world): the same formulas for every
  sharded config and mesh (``vertex_halo`` under ``(2, 2)`` and
  ``(4, 1)``) at the held-out point, the at-rest state exact, no
  vertex-domain buffer of ``n`` rows under the range layouts, and a
  seeded ``[n]`` buffer in the range session firing.
"""
import dataclasses
import datetime
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch
import torch.distributed as dist

from repro_torch.analysis import audit, memory, rules
from repro_torch.analysis.programs import (AuditParams, ENGINE_CONFIGS,
                                           record_program, run_engine)
from repro_torch.analysis.walker import RoundRecorder

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
TIMEOUT = 240
SHARDED = [(e, None) for e in sorted(ENGINE_CONFIGS)
           if ENGINE_CONFIGS[e].is_sharded] + [("vertex_halo", "4,1")]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    store = dist.FileStore(str(tmp_path_factory.mktemp("pg") / "store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=60))
    try:
        yield
    finally:
        dist.destroy_process_group()


# -- the recorder's liveness ------------------------------------------------
def test_freed_input_leaves_the_live_set():
    """Every op's output is live from the op on, the input from the
    start; an input the result does not hold is unreachable after the
    call (the donation rule's ``freed``)."""
    x = torch.zeros(256, dtype=torch.int32)   # 1024 B

    def prog(a):
        b = a + 1
        return b * 2

    args = [x]
    del x
    pr = record_program(prog, args, {"a": 0}, {})
    assert pr.point_bytes == [2048, 3072]     # a + b, then the result
    assert pr.freed == ("a",) and pr.in_place == ()


def test_kept_input_and_views_share_one_storage():
    x = torch.zeros(256, dtype=torch.int32)
    with RoundRecorder(track_memory=True) as rec:
        rec.track(x)
        v = x[10:]                             # a view: no new storage
        w = v + 0
    assert rec.point_bytes == [1024, 1024 + 246 * 4]
    del v, w


# -- the committed formulas, one rank -----------------------------------------
@pytest.fixture(scope="module")
def held(world):
    p = AuditParams(*memory.HELD_OUT)
    return {name: run_engine(name, p, device="cpu", rounds=False)
            for name in ENGINE_CONFIGS}


@pytest.mark.parametrize("name", sorted(ENGINE_CONFIGS))
def test_peak_formulas_hold_at_the_held_out_point(held, name):
    assert memory.HELD_OUT not in memory.FIT_POINTS
    section = audit.load_budget(name)["memory"]["1x1"]
    assert memory.held_out_check(section, held[name]) == []


@pytest.mark.parametrize("name", sorted(ENGINE_CONFIGS))
def test_at_rest_formulas_equal_the_state_bytes(held, name):
    run = held[name]
    section = audit.load_budget(name)["memory"]["1x1"]
    for prog, pr in run.programs.items():
        rest = dict(section["programs"][prog]["at_rest"])
        assert set(rest) == set(pr.state)
        for arg, (shape, isz) in pr.state.items():
            nbytes = isz
            for d in shape:
                nbytes *= d
            assert rules.eval_formula(rest[arg], run.sizes) == nbytes, arg


def test_seeded_wrong_peak_formula_fires(held):
    budget = audit.load_budget("unified")
    budget["memory"]["1x1"]["programs"]["apply_batch"]["peak"] = "4 * n"
    finds = rules.run_rules(held["unified"], budget, ["memory_budget"])[
        "memory_budget"]
    assert any("peak live bytes drifted" in f.message and "'4 * n'"
               in f.message for f in finds)


def test_seeded_in_place_drift_fires(held):
    run = held["unified"]
    pr = dataclasses.replace(run.programs["apply_batch"], in_place=("src",))
    bad = dataclasses.replace(run, programs={"apply_batch": pr})
    finds = rules.run_rules(bad, audit.load_budget("unified"),
                            ["memory_budget"])["memory_budget"]
    assert any("in-place state drifted" in f.message for f in finds)


def test_the_slot_table_is_written_in_place(held):
    for name in ("unified", "sharded", "vertex_halo", "weighted"):
        assert {"src", "dst", "valid"} <= set(
            held[name].programs["apply_batch"].in_place), name


# -- 4 ranks ---------------------------------------------------------------------
_WORKER = textwrap.dedent('''
    import json, sys
    import torch
    from repro_torch.analysis import audit, memory, programs
    from repro_torch.analysis.memory import replicated_vertex_sites
    from repro_torch.analysis.rules import eval_formula, run_rules
    from repro_torch.core import vertex_layout
    rank, store, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    audit.init_world(rank, {world}, store, "cpu")
    res = {{}}
    for name, shape in {sharded!r}:
        ms = tuple(int(x) for x in shape.split(",")) if shape else None
        run = programs.run_engine(name, programs.AuditParams(
            *memory.HELD_OUT), ms, "cpu", rounds=False)
        budget = audit.load_budget(name)
        section = budget["memory"][run.mesh_key]
        pr = run.programs["apply_batch"]
        rest = dict(section["programs"]["apply_batch"]["at_rest"])
        res[f"{{name}}-{{shape}}"] = dict(
            mesh=run.mesh_key,
            held_out=memory.held_out_check(section, run),
            at_rest={{k: [eval_formula(rest[k], run.sizes),
                         s[1] * int(torch.Size(s[0]).numel())]
                     for k, s in pr.state.items()}},
            rows=replicated_vertex_sites(pr.vertex_shapes,
                                         run.sizes["n"],
                                         run.sizes["n_owned"],
                                         run.sizes["hcap"]),
            n_shapes=len(pr.vertex_shapes))
    # a seeded [n] buffer in the range session's completion
    real = vertex_layout.HaloSession.complete
    def leaky(self, stats):
        vertex_layout._rows("complete", self.layout.n)
        return real(self, stats)
    vertex_layout.HaloSession.complete = leaky
    run = programs.run_engine("vertex_range", device="cpu", rounds=False)
    vertex_layout.HaloSession.complete = real
    res["seeded"] = [f.message for f in run_rules(
        run, audit.load_budget("vertex_range"),
        ["memory_budget"])["memory_budget"]]
    with open(out, "w") as fh:
        json.dump(res, fh)
''')


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mem4")
    script = tmp / "worker.py"
    script.write_text(_WORKER.format(world=WORLD, sharded=SHARDED))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    store = str(tmp / "store")
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(r), store,
         str(tmp / f"rank{r}.json")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(WORLD)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), "\n".join(
        f"--- rank {r} ---\n{log[-3000:]}" for r, log in enumerate(logs))
    return [json.loads((tmp / f"rank{r}.json").read_text())
            for r in range(WORLD)]


@pytest.mark.parametrize("name,shape", SHARDED,
                         ids=[f"{e}-{s or 'canonical'}" for e, s in SHARDED])
def test_sharded_formulas_hold_on_four_ranks(ranks, name, shape):
    for rank, res in enumerate(ranks):
        r = res[f"{name}-{shape}"]
        assert r["held_out"] == [], (rank, r["mesh"])
        for arg, (want, got) in r["at_rest"].items():
            assert want == got, (rank, arg)
        assert r["rows"] == [], (rank, r["rows"])
        if ENGINE_CONFIGS[name].vertex_sharding in ("range", "halo"):
            assert r["n_shapes"] > 0


def test_seeded_vertex_buffer_fires_on_four_ranks(ranks):
    for res in ranks:
        assert any("O(n)-replicated vertex buffer" in m and "complete" in m
                   for m in res["seeded"]), res["seeded"]
