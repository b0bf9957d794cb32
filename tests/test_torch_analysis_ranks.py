"""The port's auditor on 4 gloo ranks: ``audit_engines`` over every
engine config but ``cuda`` (whose launch claim only the card can
check) against the committed manifests, ``vertex_halo`` under both
``(2, 2)`` and ``(4, 1)``, each rule of each config a test of its own,
on every rank. At 4 ranks the collectives cross ranks for real: the
cross-check holds each call-time traffic note to the c10d op the
recorder saw (a ring step a ``ppermute`` per array, three steps at four
owners), the vertex ranges are owned slices, and the sections keyed by
the mesh (``"1x4"``, ``"2x2"``, ``"4x1"``) are the ones read.

One module fixture spawns ONE world for the file: 4 rank subprocesses
that meet through a file store in ``tmp_path`` (every wait with a
timeout), each writing its reports to a JSON file.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from repro_torch.analysis.programs import ENGINE_CONFIGS
from repro_torch.analysis.rules import RULES

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
TIMEOUT = 240
ENGINES = sorted(e for e in ENGINE_CONFIGS if e != "cuda")
RUNS = [(e, None) for e in ENGINES] + [("vertex_halo", "4x1")]

_WORKER = textwrap.dedent('''
    import json, sys
    from repro_torch.analysis import audit, programs, rules
    from repro_torch.analysis.walker import collectives
    rank, store, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    audit.init_world(rank, {world}, store, "cpu")
    engines = {engines!r}
    res = {{"all": audit.audit_engines(engines, device="cpu"),
            "4x1": audit.audit_engines(["vertex_halo"], mesh_shape=(4, 1),
                                       device="cpu")}}
    # the ring at four owners: three steps a placement, a recv_ an array
    run = programs.run_engine("vertex_range", device="cpu")
    log, sites = run.rounds["removal_round"]
    res["ring"] = dict(
        notes=sum(t.op == "ppermute" for t in log),
        c10d=sum(c.op == "ppermute" for c in collectives(sites)),
        steps=rules.ring_steps(run), mesh=run.mesh_key,
        sizes=run.sizes)
    with open(out, "w") as fh:
        json.dump(res, fh)
''')


@pytest.fixture(scope="module")
def reports(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("audit4")
    script = tmp / "worker.py"
    script.write_text(_WORKER.format(world=WORLD, engines=ENGINES))
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


# the torch configs: ``launch_budget_twin`` applies to the kernel config
@pytest.mark.parametrize("rule", sorted(r for r in RULES
                                        if r != "launch_budget_twin"))
@pytest.mark.parametrize("engine,mesh", RUNS,
                         ids=[f"{e}-{m or 'canonical'}" for e, m in RUNS])
def test_rule_passes_on_every_rank(reports, engine, mesh, rule):
    for rank, rep in enumerate(reports):
        checks = rep["4x1" if mesh else "all"]["checks"]
        [c] = [c for c in checks if c["engine"] == engine
               and c["rule"] == rule]
        assert c["ok"], (rank, [f["message"] for f in c["findings"]])


def test_reports_cover_the_world(reports):
    for rep in reports:
        assert rep["all"]["ok"] and rep["4x1"]["ok"]
        assert rep["all"]["n_devices"] == WORLD
        assert rep["all"]["engines"] == ENGINES
        assert rep["4x1"]["mesh_shape"] == [4, 1]


def test_ring_steps_at_four_owners(reports):
    """A removal round places its droppers once: 3 ring steps of 5
    arrays at 4 owners, each a noted ``ppermute`` and a c10d ``recv_``;
    the schedule keeps one step (the reference's scan body)."""
    for rep in reports:
        ring = rep["ring"]
        assert ring["mesh"] == "1x4" and ring["steps"] == 3
        assert ring["notes"] == ring["c10d"] == 15
        assert ring["sizes"]["n_owned"] == ring["sizes"]["n"] // 4
