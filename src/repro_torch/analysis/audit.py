"""Audit CLI + report schema — ``python -m repro_torch.analysis.audit``.

The counterpart of the reference's ``analysis/audit.py``: runs every
registered rule (``rules.RULES``) over the recorded runs of each engine
configuration and diffs against the committed manifests
(``budgets/<engine>.json``), emitting one machine-readable report
(schema ``repro_torch.analysis/report/v1``).

Usage:
    python -m repro_torch.analysis.audit --engine unified,cuda,sharded
    python -m repro_torch.analysis.audit --engine all --device cpu
    python -m repro_torch.analysis.audit --engine all --device cpu --world 4
    python -m repro_torch.analysis.audit --engine vertex_halo --device cpu \\
        --world 4 --mesh-shape 4,1
    python -m repro_torch.analysis.audit --engine all --device cpu --memory
    python -m repro_torch.analysis.audit --write-budgets --device cpu
    python -m repro_torch.analysis.audit --write-budgets --engine \\
        unified,cuda,sharded

Like the port's other entry points, the audit runs on the card unless
the caller asks for the CPU: without ``--device`` it runs a world of one
NCCL rank on the card, and without a card it refuses (it never drops to
the host). ``--device cpu`` runs on the host, where the reference
re-execs under a forced XLA device count: ``--world N`` starts N rank
processes that meet through a file store in a temporary directory
(gloo); rank 0 writes the report.

A check passes ("ok"), fails, or is "not run" where the run cannot show
what it claims: the ``cuda`` config's twin check
(``launch_budget_twin``) runs its kernels on the card only. The report's
``ok`` means no check failed, ``not_run`` lists the checks that did not
run, and the verdict line names them.

``--write-budgets --device cpu`` regenerates the manifests: each config
runs in a world of 1 and of 4 (``vertex_halo`` under ``(2, 2)`` and
``(4, 1)``), at the fit points of ``memory.FIT_POINTS`` and the
held-out point; the
``recv_bytes`` formulas pair the 4-rank and the 1-rank payloads
(``rules.guess_formula``), the sections that depend on the mesh
(launches, syncs, memory) are kept per mesh, and a manifest's card
sections are carried over as they are. On the card it adds (or
replaces) the card's sections (``"1x1@cuda"``) of the named manifests
(``sharded``'s holds the ``cuda`` config's torch twin): the launches
there are the CUDA kernels a round, the ``cuda`` config's
memory is the kernels', which only the card runs, and on the card every
host-to-device copy syncs.
"""
from __future__ import annotations

import argparse
import datetime
import json
import os
import subprocess
import sys
import tempfile
from typing import Dict, List, Optional, Sequence

SCHEMA = "repro_torch.analysis/report/v1"
BUDGET_SCHEMA = "repro_torch.analysis/budget/v1"
BUDGET_DIR = os.path.join(os.path.dirname(__file__), "budgets")
_SRC = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
HALO_SHAPES = ((2, 2), (4, 1))  # vertex_halo's meshes on 4 ranks
WORLD = 4
TIMEOUT = 600  # seconds, for a spawned world


def make_check(rule: str, engine: str, findings: Sequence) -> dict:
    """One report entry: a rule applied to one engine config; its
    ``status`` is "ok", "fail", or "not run" (a ``rules.NotRun``, with
    its reason)."""
    reason = getattr(findings, "reason", None)
    status = ("fail" if findings else
              "not run" if reason is not None else "ok")
    out = {
        "rule": rule,
        "engine": engine,
        "status": status,
        "ok": status == "ok",
        "findings": [
            f.as_dict() if hasattr(f, "as_dict") else dict(f)
            for f in findings
        ],
    }
    if reason is not None:
        out["reason"] = reason
    return out


def make_report(checks: List[dict], **meta) -> dict:
    """The report: ``ok`` when no check failed; the checks that did not
    run are listed in ``not_run``."""
    return {
        "schema": SCHEMA,
        "ok": not any(c["status"] == "fail" for c in checks),
        "not_run": [f"{c['engine']}/{c['rule']}" for c in checks
                    if c["status"] == "not run"],
        "checks": checks,
        **meta,
    }


def budget_path(engine: str, budget_dir: Optional[str] = None) -> str:
    return os.path.join(budget_dir or BUDGET_DIR, f"{engine}.json")


def load_budget(engine: str, budget_dir: Optional[str] = None) -> dict:
    path = budget_path(engine, budget_dir)
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"no budget manifest for engine {engine!r} at {path} — "
            "generate one with `python -m repro_torch.analysis.audit "
            "--write-budgets` and commit it")
    with open(path) as fh:
        budget = json.load(fh)
    got = budget.get("schema")
    if got != BUDGET_SCHEMA:
        raise ValueError(
            f"budget manifest {path} has schema {got!r} but this auditor "
            f"expects {BUDGET_SCHEMA!r} — regenerate with `python -m "
            "repro_torch.analysis.audit --write-budgets`")
    return budget


# -- generation ---------------------------------------------------------------
def _fit_runs(name: str, mesh_shape, device):
    """The config's runs at every fit point (the first at AuditParams),
    the recapture function and the held-out run."""
    from .memory import FIT_POINTS, HELD_OUT
    from .programs import AuditParams, run_engine

    points = [AuditParams(*p) for p in FIT_POINTS]
    runs = [run_engine(name, p, mesh_shape, device, rounds=(i == 0))
            for i, p in enumerate(points)]

    def recapture(capture):
        return [run_engine(name, p, mesh_shape, device, capture=capture,
                           rounds=False) for p in points]

    held = run_engine(name, AuditParams(*HELD_OUT), mesh_shape, device,
                      rounds=False)
    return runs, recapture, held


def budget_part(name: str, mesh_shape=None, device=None) -> dict:
    """One mesh's contribution to a manifest, from runs on the current
    world: the raw collective schedules (bytes, formulas come at the
    merge), and this mesh's launches, syncs and memory section."""
    from .memory import generate_memory_section, held_out_check
    from .rules import (program_histogram, ring_steps, round_launches,
                        round_schedule)
    from .walker import count_syncs

    runs, recapture, held = _fit_runs(name, mesh_shape, device)
    run = runs[0]
    memory = generate_memory_section(runs, recapture)
    bad = held_out_check(memory, held)
    if bad:
        raise RuntimeError(f"{name} on {run.mesh_key}: the memory formulas "
                           f"fail at the held-out point: {bad}")
    steps = ring_steps(run)
    rounds: Dict[str, dict] = {}
    for rname, (log, sites) in run.rounds.items():
        sched = round_schedule(log, sites, steps)
        if rname in run.overflow:
            sched["overflow"] = round_schedule(*run.overflow[rname],
                                               steps)["overflow"]
        rounds[rname] = sched
    return {
        "mesh": run.mesh_key,
        "sizes": run.sizes,
        "program_collectives": {p: program_histogram(pr.log, steps)
                                for p, pr in run.programs.items()},
        "rounds": rounds,
        "round_launches": {r: round_launches(s, run.device)
                           for r, (_, s) in run.rounds.items()},
        "host_sync": {
            "programs": {p: count_syncs(pr.sites)
                         for p, pr in run.programs.items()},
            "per_round": {r: count_syncs(s)
                          for r, (_, s) in run.rounds.items()},
        },
        "memory": memory,
        "donated": {p: list(v) for p, v in run.donated.items()},
    }


def generate_budget(name: str, parts: Sequence[dict],
                    params=None) -> dict:
    """A manifest from the parts of several meshes: histograms and
    round op lists must agree across meshes; each ``recv_bytes`` is the
    first formula reproducing every mesh's payload (paired as the
    reference pairs its 8- and 1-device traces)."""
    from ..core.api import bucket_lattice
    from .programs import ENGINE_CONFIGS, AuditParams
    from .rules import FORMULA_CANDIDATES, eval_formula

    cfg = ENGINE_CONFIGS[name]
    params = params or AuditParams()
    parts = sorted(parts, key=lambda p: -p["sizes"]["d"])
    base = parts[0]
    for p in parts[1:]:
        if p["program_collectives"] != base["program_collectives"]:
            raise RuntimeError(
                f"{name}: the collective histogram differs between meshes "
                f"{base['mesh']} {base['program_collectives']} and "
                f"{p['mesh']} {p['program_collectives']}")

    def formula(values: List[int], envs: List[dict]):
        for cand in FORMULA_CANDIDATES:
            try:
                if all(eval_formula(cand, e) == v
                       for v, e in zip(values, envs)):
                    return cand
            except ValueError:
                continue
        if len(set(values)) == 1:
            return int(values[0])
        raise RuntimeError(f"{name}: no recv_bytes formula fits {values} "
                           f"at {[e['mesh'] for e in envs]}")

    rounds: Dict[str, dict] = {}
    for rname, sched in base["rounds"].items():
        out = {}
        for side, items in sched.items():
            others = [p["rounds"][rname][side] for p in parts]
            if any([o for o, _ in x] != [o for o, _ in items]
                   for x in others):
                raise RuntimeError(
                    f"{name}/{rname}/{side}: the op list differs between "
                    "meshes")
            envs = [dict(p["sizes"], mesh=p["mesh"]) for p in parts]
            out[side] = [
                {"op": op, "recv_bytes": formula(
                    [x[i][1] for x in others], envs)}
                for i, (op, _) in enumerate(items)]
        rounds[rname] = out
    if cfg.engine == "host":
        max_variants = max(1, params.lanes).bit_length()
    else:
        max_variants = len(bucket_lattice(
            params.capacity, params.lanes, cfg.frontier_exchange,
            cfg.frontier_cap, params.n))
    halo = cfg.vertex_sharding in ("range", "halo")
    return {
        "schema": BUDGET_SCHEMA,
        "engine": name,
        "generated_with": {
            "n": params.n, "capacity": params.capacity,
            "lanes": params.lanes,
            "meshes": [p["mesh"] for p in parts],
            "devices": {p["mesh"]: p.get("device", "cpu") for p in parts},
        },
        "program_collectives": base["program_collectives"],
        "rounds": rounds,
        "round_launches": {p["mesh"]: p["round_launches"] for p in parts},
        "host_sync": {p["mesh"]: p["host_sync"] for p in parts},
        "memory": {p["mesh"]: p["memory"] for p in parts},
        "forbid_round_vertex_psum": halo,
        # the 2-axis layouts' statistic completion over the pure-edge
        # group is budgeted traffic, not the forbidden vertex reduction
        "round_psum_notes_exempt": (["psum_edge"]
                                    if cfg.vertex_sharding == "halo"
                                    else []),
        "forbid_replicated_vertex_buffers": halo,
        "donated_args": base["donated"],
        "max_tainted_truncations": 0,
        "max_jit_variants": max_variants,
        "large_output_bytes": 1024,
    }


def replace_mesh_parts(budget: dict, parts: Sequence[dict]) -> dict:
    """``budget`` with the mesh sections of ``parts`` (the card's) added
    or replacing its own; the histograms must agree with the
    manifest's."""
    out = json.loads(json.dumps(budget))
    for p in parts:
        if p["program_collectives"] != budget["program_collectives"]:
            raise RuntimeError(
                f"{budget['engine']}: the card's collective histogram "
                f"{p['program_collectives']} differs from the manifest's")
        for key in ("round_launches", "host_sync", "memory"):
            out[key][p["mesh"]] = p[key]
        out["generated_with"]["devices"][p["mesh"]] = p.get("device", "cpu")
        if p["mesh"] not in out["generated_with"]["meshes"]:
            out["generated_with"]["meshes"].append(p["mesh"])
    return out


def write_budget(budget: dict, budget_dir: Optional[str] = None) -> str:
    path = budget_path(budget["engine"], budget_dir)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as fh:
        json.dump(budget, fh, indent=2, sort_keys=True)
        fh.write("\n")
    return path


# -- auditing -------------------------------------------------------------------
def audit_engines(engines: Sequence[str],
                  budget_dir: Optional[str] = None,
                  params=None,
                  rules: Optional[Sequence[str]] = None,
                  mesh_shape=None, device=None) -> dict:
    """Run and audit the given configs against their committed manifests
    on the current world (SPMD: every rank calls it; every rank gets the
    report of its own runs). ``rules`` restricts the registry (the CLI's
    ``--memory`` passes ``["memory_budget"]``); ``mesh_shape`` applies
    to halo configs only; ``device`` None is the card."""
    from ..device import resolve_device
    from .programs import ENGINE_CONFIGS, AuditParams, run_engine, \
        world_size
    from .rules import run_rules

    device = str(resolve_device(device))
    params = params or AuditParams()
    checks: List[dict] = []
    for name in engines:
        shape = (mesh_shape
                 if ENGINE_CONFIGS[name].vertex_sharding == "halo"
                 else None)
        run = run_engine(name, params, shape, device)
        budget = load_budget(name, budget_dir)
        for rname, findings in run_rules(run, budget, rules).items():
            checks.append(make_check(rname, name, findings))
    return make_report(
        checks, n_devices=world_size(), engines=list(engines),
        mesh_shape=list(mesh_shape) if mesh_shape else None,
        device=device,
        params={"n": params.n, "capacity": params.capacity,
                "lanes": params.lanes})


# -- worlds ---------------------------------------------------------------------
def init_world(rank: int, world: int, store_path: str,
               device: str = "cuda") -> None:
    """Join a world through a file store (gloo on the host, NCCL on the
    card); a world of one when ``world == 1``."""
    import torch
    import torch.distributed as dist
    if device.startswith("cuda"):
        if not torch.cuda.is_available():
            raise RuntimeError("--device cuda needs a CUDA device; the "
                               "audit does not drop to the host")
        torch.cuda.set_device(0)
    store = dist.FileStore(store_path, world)
    dist.init_process_group(
        "nccl" if device.startswith("cuda") else "gloo", store=store,
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=TIMEOUT))


def spawn_world(world: int, argv: Sequence[str],
                timeout: int = TIMEOUT) -> dict:
    """Run ``python -m repro_torch.analysis.audit <argv>`` as ``world``
    rank processes meeting through a file store; returns rank 0's JSON
    result. A rank that fails or outlives ``timeout`` fails the call
    (every rank is killed)."""
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        out = os.path.join(tmp, "result.json")
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [_SRC] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
        env.setdefault("OMP_NUM_THREADS", "1")
        procs = [subprocess.Popen(
            [sys.executable, "-m", "repro_torch.analysis.audit", *argv,
             "--world", str(world), "--rank", str(r), "--store", store,
             "--result", out],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True) for r in range(world)]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=timeout)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        if any(p.returncode != 0 for p in procs):
            raise RuntimeError(
                f"an audit rank failed: exit codes "
                f"{[p.returncode for p in procs]}\n" + "\n".join(
                    f"--- rank {r} ---\n{log[-4000:]}"
                    for r, log in enumerate(logs)))
        with open(out) as fh:
            return json.load(fh)


def _print_summary(report: dict) -> None:
    marks = {"ok": "ok  ", "fail": "FAIL", "not run": "skip"}
    for c in report["checks"]:
        print(f"[{marks[c['status']]}] {c['engine']:16s} {c['rule']}"
              + (f" (not run: {c['reason']})" if "reason" in c else ""))
        for f in c["findings"]:
            print(f"       - {f['message']}")
    verdict = "PASS" if report["ok"] else "FAIL"
    if report.get("not_run"):
        verdict += (f" ({len(report['not_run'])} check(s) not run: "
                    f"{', '.join(report['not_run'])})")
    print(f"audit {verdict} on {report.get('n_devices', '?')} rank(s) "
          f"({report.get('device')})")


def _engines(arg: str) -> List[str]:
    from .programs import ENGINE_CONFIGS
    if arg == "all":
        return sorted(ENGINE_CONFIGS)
    out = arg.split(",")
    for e in out:
        if e not in ENGINE_CONFIGS:
            raise SystemExit(f"unknown engine {e!r} "
                             f"(expected one of {sorted(ENGINE_CONFIGS)})")
    return out


def _rank_main(args) -> int:
    """One rank of a spawned (or in-process) world; an in-process world
    of one already initialized (a caller's) is used as it is."""
    import torch.distributed as dist
    own = not dist.is_initialized()
    if own:
        init_world(args.rank, args.world, args.store, args.device)
    elif dist.get_world_size() != args.world:
        raise RuntimeError(
            f"a world of {dist.get_world_size()} ranks is initialized; the "
            f"audit asks for {args.world}")
    try:
        engines = _engines(args.engine)
        if args.parts:
            result = {"parts": {
                e: budget_part(e, args.mesh_shape_t, args.device)
                for e in engines}}
            for e in engines:
                result["parts"][e]["device"] = args.device
        else:
            result = audit_engines(
                engines, args.budget_dir,
                rules=["memory_budget"] if args.memory else None,
                mesh_shape=args.mesh_shape_t, device=args.device)
        if args.rank == 0:
            with open(args.result, "w") as fh:
                json.dump(result, fh)
    finally:
        if own:
            dist.destroy_process_group()
    return 0


def _in_world(world: int, argv: List[str], device: str) -> dict:
    """Rank 0's result of ``argv`` on a fresh world of ``world`` ranks
    (spawned; a world of one runs in this process)."""
    if world == 1:
        with tempfile.TemporaryDirectory() as tmp:
            args = _parser().parse_args(
                argv + ["--world", "1", "--rank", "0", "--store",
                        os.path.join(tmp, "store"), "--result",
                        os.path.join(tmp, "result.json"),
                        "--device", device])
            _finish_args(args)
            _rank_main(args)
            with open(args.result) as fh:
                return json.load(fh)
    return spawn_world(world, argv + ["--device", device])


def write_budgets(engines: Sequence[str], budget_dir: Optional[str] = None,
                  device: str = "cuda") -> List[str]:
    """Regenerate the manifests (see the module docstring)."""
    from .programs import ENGINE_CONFIGS
    written = []
    if device.startswith("cuda"):
        part = _in_world(1, ["--engine", ",".join(engines), "--parts"],
                         device)["parts"]
        for e in engines:
            budget = replace_mesh_parts(load_budget(e, budget_dir),
                                        [part[e]])
            written.append(write_budget(budget, budget_dir))
        return written
    parts: Dict[str, list] = {e: [] for e in engines}
    for e, p in _in_world(1, ["--engine", ",".join(engines), "--parts"],
                          device)["parts"].items():
        parts[e].append(p)
    sharded = [e for e in engines if ENGINE_CONFIGS[e].is_sharded]
    plain = [e for e in sharded
             if ENGINE_CONFIGS[e].vertex_sharding != "halo"]
    halo = [e for e in sharded if e not in plain]
    if plain:
        for e, p in _in_world(WORLD, ["--engine", ",".join(plain),
                                      "--parts"], device)["parts"].items():
            parts[e].append(p)
    for shape in HALO_SHAPES if halo else ():
        for e, p in _in_world(WORLD, ["--engine", ",".join(halo), "--parts",
                                      "--mesh-shape",
                                      f"{shape[0]},{shape[1]}"],
                              device)["parts"].items():
            parts[e].append(p)
    for e in engines:
        budget = generate_budget(e, parts[e])
        if os.path.exists(budget_path(e, budget_dir)):
            budget = keep_card_sections(budget, load_budget(e, budget_dir))
        written.append(write_budget(budget, budget_dir))
    return written


def keep_card_sections(budget: dict, old: dict) -> dict:
    """``budget`` (written on the host) with ``old``'s card sections
    (``"...@cuda"``) carried over: only the card writes them."""
    card = [m for m in old.get("generated_with", {}).get("meshes", [])
            if m.endswith("@cuda")]
    for m in card:
        for key in ("round_launches", "host_sync", "memory"):
            budget[key][m] = old[key][m]
        budget["generated_with"]["meshes"].append(m)
        budget["generated_with"]["devices"][m] = "cuda"
    return budget


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.audit",
        description="Audit of the engine matrix's recorded runs")
    p.add_argument("--engine", default="all",
                   help="comma-separated engine configs, or 'all'")
    p.add_argument("--world", type=int, default=1,
                   help="run on this many ranks (spawned gloo ranks; 1: "
                        "this process)")
    p.add_argument("--mesh-shape", default=None, metavar="DE,DV",
                   help="the (d_e, d_v) mesh of halo configs, e.g. 2,2")
    p.add_argument("--memory", action="store_true",
                   help="run only the memory_budget rule")
    p.add_argument("--write-budgets", action="store_true",
                   help="regenerate the manifests instead of checking")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="cuda (default: one NCCL rank on the card) or cpu "
                        "(gloo ranks on the host)")
    p.add_argument("--out", default=None, help="write the JSON report here")
    p.add_argument("--budget-dir", default=None,
                   help="manifest directory (default: the committed "
                        "package budgets/)")
    # a rank of a spawned world
    p.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--store", default=None, help=argparse.SUPPRESS)
    p.add_argument("--result", default=None, help=argparse.SUPPRESS)
    p.add_argument("--parts", action="store_true", help=argparse.SUPPRESS)
    return p


def _finish_args(args) -> None:
    args.mesh_shape_t = None
    if args.mesh_shape:
        de, dv = (int(x) for x in args.mesh_shape.replace("x", ",")
                  .split(","))
        args.mesh_shape_t = (de, dv)


def main(argv: Optional[Sequence[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    p = _parser()
    args = p.parse_args(argv)
    _finish_args(args)
    if args.rank is not None:
        return _rank_main(args)
    if args.device == "cuda":
        import torch
        if not torch.cuda.is_available():
            print("audit: the audit runs on a CUDA device by default and "
                  "none is available; it does not drop to the host: pass "
                  "--device cpu to run on the CPU", file=sys.stderr)
            return 2
        if args.world != 1:
            p.error("--device cuda runs a world of one NCCL rank")
    engines = _engines(args.engine)
    if args.write_budgets:
        for path in write_budgets(engines, args.budget_dir, args.device):
            print(f"wrote {path}")
        return 0
    sub = ["--engine", ",".join(engines)]
    if args.mesh_shape:
        sub += ["--mesh-shape", args.mesh_shape]
    if args.memory:
        sub.append("--memory")
    if args.budget_dir:
        sub += ["--budget-dir", args.budget_dir]
    report = _in_world(args.world, sub, args.device)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(report, fh, indent=2)
    _print_summary(report)
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
