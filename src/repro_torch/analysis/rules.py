"""The audit rules — each pins a structural invariant the engine
matrix's performance claims stand on, against a committed per-engine
budget manifest (``analysis/budgets/<engine>.json``).

The counterpart of the reference's ``analysis/rules.py``, re-expressed
over recorded runs (``programs.run_engine``) instead of traced jaxprs.
Registry (``RULES``, decorated with ``@rule``):

* ``collective_budget`` — each program's collective histogram and each
  round's ordered ``setup`` / ``main`` / ``overflow`` schedule (op and
  ``recv_bytes`` formula in ``n``, ``n_owned``, ``hcap``, ``d_v``, ...)
  against the manifest; the schedule is the call-time traffic model
  (``record_traffic``), which ``cross_check_round`` holds to the c10d
  ops the recorder saw, note for note (a lying note fires). Under
  ``"range"`` / ``"halo"`` no vertex-sized all-reduce may run inside a
  round (the pure-edge ``psum_edge`` completion excepted).
* ``host_sync`` — the counterpart of "no callback primitive in a batch
  program": every sync a run issues comes from a function and kind
  ``hostlint.SYNC_SITES`` names, each loop condition syncs exactly once
  an iteration of its loop (``loop_sync_mismatches``), the syncs per
  program and per round equal the manifest's, and no device-to-host
  copy of at least ``large_output_bytes`` runs inside a batch program.
* ``donation`` — every state argument the reference donates
  (``DONATED_STATE_ARGS``) is written in place (its storage is the
  output's, as ``core/engine.py`` updates the slot table) or is
  unreachable once the program returns (a weakref to it is dead).
* ``dtype_policy`` — the reference's static sentinel taint becomes a
  check at run time: an integer narrowing of a value outside the
  narrower type (the ``1 << 62`` sentinel in particular) is a finding.
* ``launch_budget`` — the per-round launch histogram against
  ``round_launches``: on the host the launch-class ops (the aten gather
  / scatter / sort family; a port kernel call counts as ONE), on the
  card the CUDA kernels ``torch.profiler`` counts inside the round
  (``walker.cuda_round_kernels``: every kernel, elementwise ones and
  each of a wrapper's launches included).
* ``launch_budget_twin`` — its second half, for ``kernel_backend="cuda"``
  only: the same rounds rerun on the torch backend must show the same
  collective schedule op for op, and each round of the kernels strictly
  fewer CUDA kernels. Only the card runs the kernels, so on the host the
  check reports itself not run (:class:`NotRun`), never ok.
* ``recompile_surface`` — the ``(window, frontier_cap)`` bucket lattice
  (``core/api.py::bucket_lattice``) stays within ``max_jit_variants``,
  and the run's bucket lies in it. The port has no jit, but each bucket
  is still a distinct set of shapes for the caching allocator (and for
  any later CUDA graph capture), so the bound keeps its meaning.

The sections that depend on the mesh (a ring step at one owner runs no
sort or send) are keyed by ``RunEngine.mesh_key`` (``"2x2"``): launches,
syncs and memory. ``recv_bytes`` entries are formula strings evaluated
in the run's size environment, so one manifest holds at every mesh.
"""
from __future__ import annotations

import ast
import dataclasses
import operator
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .hostlint import SYNC_SITES, sites_by_where
from .walker import (CollectiveSite, Site, collectives, count_round_launches,
                     count_syncs, cuda_round_kernels)


@dataclasses.dataclass
class Finding:
    """One actionable violation: which rule, which engine config, which
    program/round, and a message naming the offending op."""

    rule: str
    engine: str
    message: str
    program: str = ""

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)

    def __str__(self) -> str:  # pragma: no cover - cosmetic
        where = f" [{self.program}]" if self.program else ""
        return f"{self.rule}/{self.engine}{where}: {self.message}"


class NotRun(list):
    """A rule's verdict where this run cannot show what the rule claims
    (the kernels' twin check on the host): no finding, and the report
    marks the check "not run" with ``reason``, never "ok"."""

    def __init__(self, reason: str):
        super().__init__()
        self.reason = reason


RULES: Dict[str, Callable] = {}


def rule(name: str):
    def deco(fn):
        RULES[name] = fn
        return fn
    return deco


def run_rules(run, budget: dict,
              names: Optional[Sequence[str]] = None
              ) -> Dict[str, List[Finding]]:
    """Run (a subset of) the registry against one recorded engine;
    returns ``{rule_name: findings}`` (empty lists mean it passed, a
    :class:`NotRun` that it could not run here). A rule that does not
    apply to the config returns None and is left out."""
    out: Dict[str, List[Finding]] = {}
    for name in (names or sorted(RULES)):
        res = RULES[name](run, budget)
        if res is not None:
            out[name] = res
    return out


def mesh_section(budget: dict, key: str, mesh_key: str):
    """The manifest's ``key`` section for one mesh (``"2x2"``), or
    None."""
    return budget.get(key, {}).get(mesh_key)


# -- recv_bytes formula evaluation (the reference's, copied) --------------
def _ceil_div(a: int, b: int) -> int:
    return -(-int(a) // int(b))


_FORMULA_FUNCS = {"ceil_div": _ceil_div, "min": min, "max": max}
_BIN_OPS = {
    ast.Add: operator.add, ast.Sub: operator.sub, ast.Mult: operator.mul,
    ast.FloorDiv: operator.floordiv, ast.Mod: operator.mod,
}


def eval_formula(expr, env: Dict[str, int]) -> int:
    """Evaluate a budget size formula — integer arithmetic over the run's
    size names (n, d, cap, n_owned, n_pad, window, lanes, local_cap, ...)
    plus ceil_div/min/max. Anything else is a manifest error and
    raises."""
    if isinstance(expr, (int, np.integer)):
        return int(expr)

    def ev(node):
        if isinstance(node, ast.Expression):
            return ev(node.body)
        if isinstance(node, ast.Constant) and isinstance(node.value, int):
            return node.value
        if isinstance(node, ast.Name):
            if node.id in env:
                return int(env[node.id])
            raise ValueError(f"unknown size name {node.id!r} in formula")
        if isinstance(node, ast.BinOp) and type(node.op) in _BIN_OPS:
            return _BIN_OPS[type(node.op)](ev(node.left), ev(node.right))
        if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub):
            return -ev(node.operand)
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
                and node.func.id in _FORMULA_FUNCS and not node.keywords):
            return _FORMULA_FUNCS[node.func.id](*[ev(a) for a in node.args])
        raise ValueError(f"unsupported formula syntax: {ast.dump(node)}")

    return int(ev(ast.parse(str(expr), mode="eval")))


FORMULA_CANDIDATES = (
    "4",
    "8",
    "n_owned * 3 * 4",
    "n_owned * 2 * 4",
    "n_owned * 4",
    "n_owned * 8",
    "n * 3 * 4",
    "n * 2 * 4",
    "n * 4",
    "n_pad * 4",
    "n_pad * 8",
    "d_v * hcap * 3 * 4",
    "d_v * hcap * 2 * 4",
    "d_v * hcap * 4",
    "hcap * 4",
    "hcap * 8",
    "d_v * (cap + 1) * 4",
    "d_v * cap * 4",
    "d_v * cap * 8",
    "d * (cap + 1) * 4",
    "d * ceil_div(n_owned, 8)",
    "d * window",
    "d * 4",
)


def guess_formula(nbytes: int, env: Dict[str, int],
                  nbytes_b: Optional[int] = None,
                  env_b: Optional[Dict[str, int]] = None):
    """Match an observed payload against the candidate formulas; with a
    paired observation (the same collective in a second size
    environment) a candidate must reproduce both byte counts."""
    for cand in FORMULA_CANDIDATES:
        try:
            if eval_formula(cand, env) != int(nbytes):
                continue
            if (env_b is not None
                    and eval_formula(cand, env_b) != int(nbytes_b)):
                continue
        except ValueError:
            continue  # candidate names a size this env does not carry
        return cand
    return int(nbytes)


# -- round attribution ------------------------------------------------------
def split_round_collectives(sites: Sequence[Site]
                            ) -> Tuple[List[CollectiveSite], ...]:
    """Partition a round run's collectives into (setup, main, overflow,
    stray): before the fixpoint (the halo layouts' bind and entry
    regathers: paid a batch), inside it on the main arm, inside it on
    the sparse exchange's dense fallback (``branch="overflow"``), and a
    fallback outside a round (no budget names it)."""
    setup, main, overflow, stray = [], [], [], []
    for c in collectives(sites):
        if not c.in_round:
            (setup if not c.branch else stray).append(c)
        elif not c.branch:
            main.append(c)
        elif c.branch == "overflow":
            overflow.append(c)
        else:
            stray.append(c)
    return setup, main, overflow, stray


# call-time Traffic.op -> the primitive its c10d op maps to (the
# reference's names, and the port's table collectives)
TRAFFIC_TO_PRIM = {
    "psum": "psum",
    "psum_scalar": "psum",
    "psum_edge": "psum",
    "pmin_scalar": "pmin",
    "pmax_scalar": "pmax",
    "ppermute": "ppermute",
    "gather_frontier": "all_gather",
    "gather_halo": "all_gather",
    "gather_stats": "all_gather",
    "regather": "reduce_scatter",
    "psum_table": "psum",
    "psum_vertex": "psum",
    "gather_freelist": "all_gather",
}


def _notes(log, identity_ring: bool):
    """The notes that issue a c10d op: at one owner the ring's rotation
    is the identity, so its ``ppermute`` notes issue none."""
    return [t for t in log if not (identity_ring and t.op == "ppermute")]


def _align(log, sites: Sequence[Site], identity_ring: bool
           ) -> List[Tuple[object, Optional[CollectiveSite]]]:
    """Pair each note with the c10d op it describes, in issue order
    (``None`` where the run issued no op for it)."""
    cols = collectives(sites)
    notes = _notes(log, identity_ring)
    return [(t, cols[i] if i < len(cols) else None)
            for i, t in enumerate(notes)]


def cross_check_round(log, sites: Sequence[Site],
                      identity_ring: bool = False) -> List[str]:
    """Verify the call-time traffic notes against the c10d ops the
    recorder saw: the same count, in the same order, each note's op
    mapping (``TRAFFIC_TO_PRIM``) to the op's primitive, each noted
    ``recv_bytes`` equal to the op's payload, each note's branch the
    op's. Returns mismatch strings (empty: the model is honest).
    ``identity_ring``: the run had one owner, where the ring's
    ``ppermute`` notes issue no op."""
    mismatches: List[str] = []
    cols = collectives(sites)
    notes = _notes(log, identity_ring)
    if len(notes) != len(cols):
        mismatches.append(
            f"traffic log notes {len(notes)} collectives "
            f"({[t.op for t in notes]}) but the run issued {len(cols)} "
            f"({[c.op for c in cols]})"
        )
    for i, (t, c) in enumerate(zip(notes, cols)):
        want = TRAFFIC_TO_PRIM.get(t.op)
        if want is None:
            mismatches.append(f"[{i}]: unknown traffic op {t.op!r} (no "
                              "primitive mapping)")
        elif c.op != want:
            mismatches.append(f"[{i}]: traffic notes {t.op} (-> {want}) "
                              f"but the c10d op is {c.op}")
        if t.recv_bytes != c.out_bytes:
            mismatches.append(f"[{i}]: traffic notes {t.recv_bytes}B for "
                              f"{t.op} but the {c.op} carries "
                              f"{c.out_bytes}B")
        if getattr(t, "branch", "") != c.branch:
            mismatches.append(f"[{i}]: traffic notes branch "
                              f"{getattr(t, 'branch', '')!r} for {t.op} but "
                              f"the op ran on {c.branch!r}")
    return mismatches


def ring_steps(run) -> int:
    """Ring steps a placement takes on the run's owner group
    (``order._ring_steps``: ``max(d_v - 1, 1)``); 1 off the ring."""
    if run.config.vertex_sharding not in ("range", "halo"):
        return 1
    return max(run.sizes["d_v"] - 1, 1)


def collapse_ring(log, steps: int) -> list:
    """The notes with each ring placement cut to ONE step: the reference
    traces the ring's scan body once, the port notes every step it
    runs. A placement's steps note the same arrays in the same order, so
    a run of ``k * steps`` consecutive ``ppermute`` notes keeps its
    first ``k``."""
    if steps == 1:
        return list(log)
    out, i = [], 0
    while i < len(log):
        j = i
        while j < len(log) and log[j].op == "ppermute":
            j += 1
        if j > i:
            run = j - i
            if run % steps:
                raise RuntimeError(
                    f"{run} ppermute notes do not split into {steps} ring "
                    "steps")
            out += log[i:i + run // steps]
            i = j
        else:
            out.append(log[i])
            i += 1
    return out


def round_schedule(log, sites: Sequence[Site], steps: int = 1
                   ) -> Dict[str, List[Tuple[str, int]]]:
    """A round run's ``setup`` / ``main`` / ``overflow`` schedule as
    ``(primitive, recv_bytes)`` pairs, from its traffic notes: the first
    notes, as many as the run issued collectives before the fixpoint,
    are the set-up (no ring step there); the rest split by branch. The
    notes keep the ring's ``ppermute`` at one owner too, and each
    placement counts one ring step (``collapse_ring``), so the schedule
    is the same at every mesh (the reference traces it so)."""
    n_setup = len([c for c in collectives(sites) if not c.in_round])
    out: Dict[str, List[Tuple[str, int]]] = {"setup": [], "main": [],
                                             "overflow": []}
    for i, t in enumerate(collapse_ring(log, steps)):
        side = ("setup" if i < n_setup else
                "overflow" if getattr(t, "branch", "") else "main")
        out[side].append((TRAFFIC_TO_PRIM.get(t.op, t.op), t.recv_bytes))
    return out


def program_histogram(log, steps: int = 1) -> dict:
    """A program's collective histogram from its traffic notes, one ring
    step a placement (mesh independent, as ``round_schedule``)."""
    hist: dict = {}
    for t in collapse_ring(log, steps):
        p = TRAFFIC_TO_PRIM.get(t.op, t.op)
        hist[p] = hist.get(p, 0) + 1
    return hist


def _identity_ring(run) -> bool:
    return (run.config.vertex_sharding in ("range", "halo")
            and run.sizes["d_v"] == 1)


# -- rule 1: collective budget --------------------------------------------
@rule("collective_budget")
def check_collective_budget(run, budget: dict) -> List[Finding]:
    cfg = run.config
    env = run.sizes
    ring1 = _identity_ring(run)
    steps = ring_steps(run)
    findings: List[Finding] = []

    def bad(msg: str, program: str = "") -> None:
        findings.append(Finding("collective_budget", cfg.name, msg, program))

    want_progs = budget.get("program_collectives", {})
    for prog, pr in run.programs.items():
        want = want_progs.get(prog)
        got = program_histogram(pr.log, steps)
        if want is None:
            bad(f"no program_collectives budget for {prog!r} (observed "
                f"{got or '{}'}) — regenerate with `audit --write-budgets`",
                prog)
        elif {k: int(v) for k, v in want.items()} != got:
            bad(f"collective histogram drifted: budget {want} vs run "
                f"{got or '{}'}", prog)
        for m in cross_check_round(pr.log, pr.sites, ring1):
            bad(f"traffic-model cross-check in {prog}: {m}", prog)

    want_rounds = budget.get("rounds", {})
    runs = [(r, log, sites, ("setup", "main")) for r, (log, sites)
            in run.rounds.items()]
    runs += [(r, log, sites, ("overflow",)) for r, (log, sites)
             in run.overflow.items()]
    for rname, log, sites, keys in runs:
        _, _, _, stray = split_round_collectives(sites)
        for c in stray:
            bad(f"unattributable collective {c.op} ({c.out_bytes}B) on the "
                f"{c.branch!r} arm outside a round in {rname}", rname)
        sched = round_schedule(log, sites, steps)
        rb = want_rounds.get(rname)
        if rb is None:
            bad(f"no round budget for {rname!r} (observed "
                f"{ {k: [o for o, _ in v] for k, v in sched.items()} })",
                rname)
        else:
            for key in keys:
                spec = rb.get(key, [])
                side = sched[key]
                if len(spec) != len(side):
                    bad(f"{rname}/{key}: budget lists "
                        f"{[s['op'] for s in spec]} but the round runs "
                        f"{[o for o, _ in side]}", rname)
                    continue
                for i, (s, (op, nb)) in enumerate(zip(spec, side)):
                    if s["op"] != op:
                        bad(f"{rname}/{key}[{i}]: budget op {s['op']!r} "
                            f"but the round runs {op!r}", rname)
                    wb = eval_formula(s["recv_bytes"], env)
                    if wb != nb:
                        bad(f"{rname}/{key}[{i}]: {op} moves {nb}B but "
                            f"the budget formula {s['recv_bytes']!r} = "
                            f"{wb}B", rname)
        for m in cross_check_round(log, sites, ring1):
            bad(f"traffic-model cross-check in {rname}: {m}", rname)

    if budget.get("forbid_round_vertex_psum"):
        n = env["n"]
        exempt = set(budget.get("round_psum_notes_exempt", ()))
        scopes = [(p, pr.log, pr.sites) for p, pr in run.programs.items()]
        scopes += [(r, log, s) for r, (log, s) in run.rounds.items()]
        scopes += [(r, log, s) for r, (log, s) in run.overflow.items()]
        for prog, log, sites in scopes:
            for t, c in _align(log, sites, ring1):
                if (c is not None and c.op == "psum" and c.in_round
                        and c.out_elems >= n and t.op not in exempt):
                    bad(f"vertex-sized psum inside a fixpoint round: "
                        f"{c.out_elems} elems (>= n={n}) noted {t.op!r} "
                        "— the halo layouts must "
                        "move owned slices (reduce_scatter) and bounded "
                        "frontier/halo buffers only", prog)
    return findings


# -- rule 2: host syncs -------------------------------------------------------
# what a loop condition's sync is paid for (``SyncSite.per``)
LOOP_PERS = ("round", "wave", "eviction round", "step")


def loop_sync_mismatches(sites: Sequence[Site],
                         iterations: Dict[str, int]) -> List[str]:
    """Each loop condition ``SYNC_SITES`` names syncs exactly once an
    iteration of its loop: the syncs the recorder saw at the function
    against the iterations the interpreter counted
    (``RoundRecorder.iterations``). Returns mismatch
    strings."""
    got = count_syncs(sites)["round"]
    out = []
    for e in SYNC_SITES:
        if e.per not in LOOP_PERS or e.kind != "round":
            continue
        n_it = iterations.get(e.where, 0)
        if got.get(e.where, 0) != n_it * e.count:
            out.append(f"{e.where} synced {got.get(e.where, 0)} times in "
                       f"{n_it} iterations of its loop ({e.count} an "
                       f"iteration, per {e.per})")
    return out



@rule("host_sync")
def check_host_sync(run, budget: dict) -> List[Finding]:
    cfg = run.config
    findings: List[Finding] = []
    named = sites_by_where()

    def bad(msg: str, program: str = "") -> None:
        findings.append(Finding("host_sync", cfg.name, msg, program))

    scopes = [(p, pr.sites) for p, pr in run.programs.items()]
    scopes += [(r, s) for r, (_, s) in run.rounds.items()]
    for prog, sites in scopes:
        seen = set()
        for s in sites:
            if not s.sync or (s.where, s.sync) in named:
                continue
            key = (s.where, s.sync, s.line)
            if key in seen:
                continue
            seen.add(key)
            bad(f"extra {s.sync} sync: {s.op} at "
                f"{s.where or '<outside the package>'}:{s.line} — no "
                "hostlint.SYNC_SITES entry names it", prog)
    for prog, pr in run.programs.items():
        for m in loop_sync_mismatches(pr.sites, pr.iterations):
            bad(m, prog)
    want = mesh_section(budget, "host_sync", run.mesh_key)
    if want is None:
        bad(f"no host_sync budget for mesh {run.mesh_key} — regenerate "
            "with `audit --write-budgets`")
    else:
        for prog, pr in run.programs.items():
            got = count_syncs(pr.sites)
            w = want.get("programs", {}).get(prog)
            if w != got:
                bad(f"syncs drifted: budget {w} vs run {got}", prog)
        for rname, (_, sites) in run.rounds.items():
            got = count_syncs(sites)
            w = want.get("per_round", {}).get(rname)
            if w != got:
                bad(f"syncs per round drifted: budget {w} vs run {got}",
                    rname)
    thresh = int(budget.get("large_output_bytes", 1024))
    for prog, pr in run.programs.items():
        for s in pr.sites:
            if s.d2h_bytes >= thresh:
                bad(f"{s.op} copies {s.d2h_bytes}B (>= {thresh}B) to the "
                    f"host at {s.where}:{s.line} — a large device-to-host "
                    "copy inside a batch program", prog)
    return findings


# -- rule 3: donation -----------------------------------------------------------
@rule("donation")
def check_donation(run, budget: dict) -> List[Finding]:
    cfg = run.config
    findings: List[Finding] = []
    declared = budget.get("donated_args", {})
    for prog, pr in run.programs.items():
        want = tuple(declared.get(prog, ()))
        got = tuple(run.donated.get(prog, ()))
        if set(want) != set(got):
            findings.append(Finding(
                "donation", cfg.name,
                f"donated-arg set drifted: budget declares {sorted(want)} "
                f"but the engine donates {sorted(got)}", prog))
        for name in want:
            if name in pr.in_place or name in pr.freed:
                continue
            findings.append(Finding(
                "donation", cfg.name,
                f"state argument {name!r} is neither written in place nor "
                "unreachable after the program returns — a donated buffer "
                "kept alive is a hidden per-batch copy", prog))
    return findings


# -- rule 4: dtype policy ---------------------------------------------------------
@rule("dtype_policy")
def check_dtype_policy(run, budget: dict) -> List[Finding]:
    cfg = run.config
    allowed = int(budget.get("max_tainted_truncations", 0))
    total = [Finding("dtype_policy", cfg.name, msg, prog)
             for prog, pr in run.programs.items() for msg in pr.narrowings]
    return total if len(total) > allowed else []


# -- rule 5: per-round launch budget ------------------------------------------
def round_launches(sites: Sequence[Site], device) -> dict:
    """A round run's launch histogram: the dispatcher's launch-class ops
    on the host; on the card the CUDA kernels the profiler counted inside
    the run's fixpoint rounds."""
    if str(device).startswith("cuda"):
        return {"cuda_kernels": sum(cuda_round_kernels(sites).values())}
    return count_round_launches(sites)


def round_kernels(sites: Sequence[Site]) -> Dict[str, int]:
    """CUDA kernels of each round a card run took: the
    ``audit:<function>:<k>`` ranges with ``k`` below the function's
    loop-condition syncs (the ops after its last one are no round)."""
    syncs: Dict[str, int] = {}
    for s in sites:
        if s.sync == "round" and s.round_func and s.where.endswith(
                "::" + s.round_func):
            syncs[s.round_func] = syncs.get(s.round_func, 0) + 1
    return {key: n for key, n in cuda_round_kernels(sites).items()
            if int(key.rsplit(":", 1)[1])
            < syncs.get(key.split(":")[1], 0)}


@rule("launch_budget")
def check_launch_budget(run, budget: dict) -> List[Finding]:
    """Pin the per-round launch histogram (``round_launches``) of the
    run's device."""
    cfg = run.config
    findings: List[Finding] = []

    def bad(msg: str, program: str = "") -> None:
        findings.append(Finding("launch_budget", cfg.name, msg, program))

    want_rounds = mesh_section(budget, "round_launches", run.mesh_key)
    if run.rounds and want_rounds is None:
        bad(f"no round_launches budget for mesh {run.mesh_key} — "
            "regenerate with `audit --write-budgets`")
        want_rounds = {}
    for rname, (_, sites) in run.rounds.items():
        got = round_launches(sites, run.device)
        want = (want_rounds or {}).get(rname)
        if want is None:
            bad(f"no round_launches budget for {rname!r} (observed "
                f"{got or '{}'})", rname)
        elif {k: int(v) for k, v in want.items()} != got:
            bad(f"launch histogram drifted: budget {want} vs run "
                f"{got or '{}'}", rname)
    return findings


@rule("launch_budget_twin")
def check_launch_budget_twin(run, budget: dict):
    """Prove the kernel backend's fusion claim against its torch twin:
    the same rounds rerun with ``kernel_backend="torch"`` must issue the
    same collectives op for op (payload and arm too), and each round of
    the kernels must launch STRICTLY fewer CUDA kernels (the profiler's
    count, split into rounds at the loop-condition syncs). A torch config
    is its own twin (None: not applicable); on the host a kernel wrapper
    runs its plain version, so the claim is not run there."""
    cfg = run.config
    if cfg.kernel_backend == "torch" or not run.rounds:
        return None
    if not str(run.device).startswith("cuda"):
        return NotRun("the kernels run on the card only: rerun with "
                      "--device cuda")
    findings: List[Finding] = []

    def bad(msg: str, program: str = "") -> None:
        findings.append(Finding("launch_budget_twin", cfg.name, msg,
                                program))

    for rname, mine, twin in twin_rounds(run):
        a = [(c.op, c.out_bytes, c.branch) for c in collectives(mine)]
        b = [(c.op, c.out_bytes, c.branch) for c in collectives(twin)]
        if a != b:
            bad(f"collective schedule diverged from the torch twin: "
                f"{cfg.kernel_backend} {a} vs torch {b} — the kernels may "
                "only replace LOCAL partials, never a collective", rname)
        ka, kb = round_kernels(mine), round_kernels(twin)
        if not ka or set(ka) != set(kb):
            bad(f"the rounds differ from the torch twin's: "
                f"{sorted(ka)} vs {sorted(kb)}", rname)
        for key in sorted(set(ka) & set(kb)):
            if ka[key] >= kb[key]:
                bad(f"{key}: {cfg.kernel_backend} launches {ka[key]} CUDA "
                    f"kernels but the torch twin launches {kb[key]} — the "
                    "kernels must STRICTLY reduce the per-round launch "
                    "count", rname)
    return findings


def twin_rounds(run):
    """``(round name, this run's sites, the torch twin's sites)`` for each
    round of a kernel-backend run, the twin rerun on the same mesh."""
    from .programs import (resolve_mesh, run_promotion_round,
                           run_removal_round)
    cfg = run.config
    mesh = resolve_mesh(cfg, run.mesh_shape)
    n, cap, lanes = run.params.n, run.params.capacity, run.params.lanes
    halo = cfg.vertex_sharding in ("range", "halo")
    fcap = run.frontier_cap if cfg.frontier_exchange == "sparse" else None
    kw = dict(window=run.window if halo else None, lanes=lanes,
              kernel_backend="torch", device=run.device)
    twins = {
        "removal_round": lambda: run_removal_round(
            cfg.vertex_sharding, n, cap, mesh, fcap, **kw),
        "promotion_round": lambda: run_promotion_round(
            cfg.vertex_sharding, n, cap, mesh, fcap, **kw),
    }
    return [(r, sites, twins[r]()[1]) for r, (_, sites) in run.rounds.items()
            if r in twins]


# -- rule 6: recompile surface ----------------------------------------------
@rule("recompile_surface")
def check_recompile_surface(run, budget: dict) -> List[Finding]:
    """The bucket lattice a config's planners can reach. The port runs no
    jit, but each ``(window, cap)`` bucket is a distinct set of shapes
    for the caching allocator and for any later CUDA graph, and keys one
    sharded program (``CoreMaintainer._sharded_fn``): a bucket past the
    bound is a new one mid-stream."""
    from .programs import lattice
    cfg = run.config
    findings: List[Finding] = []
    max_variants = int(budget.get("max_jit_variants", 0))
    if cfg.engine == "host":
        variants = max(1, run.params.lanes).bit_length()
        if variants > max_variants:
            findings.append(Finding(
                "recompile_surface", cfg.name,
                f"{variants} pow2 batch buckets (lanes <= "
                f"{run.params.lanes}) exceed max_jit_variants="
                f"{max_variants}"))
        return findings
    lat = lattice(run)
    if len(lat) > max_variants:
        findings.append(Finding(
            "recompile_surface", cfg.name,
            f"the planner can reach {len(lat)} (window, cap) buckets {lat} "
            f"but max_jit_variants={max_variants} — every extra bucket is "
            "a new set of shapes mid-stream"))
    if (run.window, run.frontier_cap) not in lat:
        findings.append(Finding(
            "recompile_surface", cfg.name,
            f"the run's bucket (window={run.window}, "
            f"cap={run.frontier_cap}) is not in the planner lattice {lat} "
            "— the run used an unplanned variant"))
    return findings


# registers the memory_budget rule (memory imports Finding/eval_formula/
# rule from this module, fully defined by the time this line runs)
from . import memory as _memory  # noqa: E402,F401
