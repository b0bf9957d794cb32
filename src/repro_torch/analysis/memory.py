"""Per-rank memory auditing — live storage bytes over recorded runs.

The counterpart of the reference's ``analysis/memory.py``. The
reference runs a buffer-lifetime pass over traced jaxprs; the port
measures what is actually alive: ``walker.RoundRecorder(track_memory=
True)`` keeps the bytes of every storage alive after each op (a
``weakref.finalize`` on each output's untyped storage, deduplicated by
storage; the program's inputs counted from the start), so the peak, each
round's peak (ops under a fixpoint function), the at-rest state
(``STATE_ARGS``) and the bytes written in place fall out of one run.

Symbolic formulas, as the reference's: the live buffers at the peak
point are re-expressed as closed forms in the size names (``n``,
``n_owned``, ``local_cap``, ``window``, ``hcap``, ...). One run cannot
tell the names apart, so each program runs at several ``(n, capacity,
lanes)`` points on the same mesh (``FIT_POINTS``): the runs are the same
op sequence (the seeded state takes the same rounds at every size), so
the buffers live at a point pair up by allocation order and each
dimension is solved against every point at once (``_dim_formula``,
copied from the reference). Each formula is then checked at a held-out
point (``HELD_OUT``). The mesh itself is not varied: a ring step at one
owner runs no sort, so runs on different meshes are different op
sequences, and the manifest keeps one memory section per mesh.

The replicated-buffer rule: under ``"range"`` / ``"halo"`` no vertex-domain
buffer the layout or its session allocates may have ``n`` rows
(``replicated_vertex_sites``, read off ``vertex_layout.record_shapes``).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from .rules import Finding, eval_formula, mesh_section, rule

# the persistent state arguments of each program (the at-rest working
# set), by name as ``programs.ProgramRun.state`` records them
STATE_ARGS: Dict[str, Tuple[str, ...]] = {
    "apply_batch": ("src", "dst", "valid", "core", "label", "n_edges"),
    "insert_batch": ("src", "dst", "valid", "core", "label", "n_edges"),
    "remove_batch": ("src", "dst", "valid", "core", "label"),
}

# the (n, capacity, lanes) points the formulas are fitted at, and the
# held-out one: ``n`` divides by 4 and is never a power of two; capacity
# and lanes move ``local_cap``, ``window`` and ``hcap``. The last two
# fit points plan a window wider than ``n``, so the O(window) statistic
# passes peak there, as they do on a real graph (window >> n), while the
# O(n) placements peak at the first ones: the peak formula is the max
# over both kinds of point.
FIT_POINTS = ((192, 384, 8), (240, 480, 8), (192, 2048, 256),
              (336, 4096, 512))
HELD_OUT = (288, 2304, 128)

DIM_CANDIDATES = (
    "n + 2",
    "cap + 1",
    "local_cap - window",
    "2 * local_cap",
    "d_e * local_cap",
    "local_cap",
    "d_v * hcap",
    "hcap",
    "max(d_v - 1, 1)",
    "window",
    "cap",
    "n",
    "n_owned",
    "lanes",
    "d",
    "d_e",
    "d_v",
    "ceil_div(n_owned, 8)",
    "ceil_div(n, 8)",
    "n_owned * d",
    # the port's own: the halo membership's candidate list (2 per
    # windowed slot, 2 per lane of both lists) and the packed lanes
    "2 * window + 4 * lanes",
    "2 * lanes",
    "lanes + 1",
    "window + 1",
    "hcap + 1",
    "n_owned + 1",
    "n + 1",
)

SIZE_NAMES = ("n", "n_owned", "local_cap", "window", "hcap", "lanes", "cap",
              "d", "d_e", "d_v")


def _dim_formula(values: Sequence[int],
                 envs: Sequence[Dict[str, int]]) -> Optional[str]:
    """The first candidate matching the dimension's value in EVERY
    paired environment; None folds an env-constant dimension into the
    coefficient; a varying dimension with no candidate raises (the
    reference's solver)."""
    if all(v == 1 for v in values) or not any(values):
        return None  # a unit or empty dimension is structure, not size
    for cand in DIM_CANDIDATES:
        try:
            ok = all(eval_formula(cand, e) == v
                     for v, e in zip(values, envs))
        except ValueError:
            continue
        if ok:
            return cand
    if len(set(values)) == 1:
        return None
    lin = _linear_formula(values, envs)
    if lin is not None:
        return lin
    points = ", ".join(f"{v} @ n={e.get('n')} local_cap="
                       f"{e.get('local_cap')} lanes={e.get('lanes')}"
                       for v, e in zip(values, envs))
    raise RuntimeError(
        f"cannot express buffer dimension ({points}) with any "
        "DIM_CANDIDATES entry — add a candidate to "
        "repro_torch.analysis.memory"
    )


def _linear_formula(values: Sequence[int],
                    envs: Sequence[Dict[str, int]]) -> Optional[str]:
    """``a * name + b`` (integers) for the first size name that fits the
    dimension at every point (the port's plain place_block level arrays
    are ``n_levels + 1 = n + 3`` long, the card's level table counts
    ``kernels/order.py``'s ``n_levels + 3 = n + 5``, its packed lane lists
    multiples of ``lanes``), or None."""
    for name in SIZE_NAMES:
        xs = [e.get(name) for e in envs]
        if None in xs or len(set(xs)) < 2:
            continue
        (x0, v0), (x1, v1) = next(
            ((a, b) for a, b in zip(zip(xs, values), zip(xs[1:],
                                                         values[1:]))
             if a[0] != b[0]), ((xs[0], values[0]), (xs[-1], values[-1])))
        if (v1 - v0) % (x1 - x0):
            continue
        a = (v1 - v0) // (x1 - x0)
        b = v0 - a * x0
        if a and all(a * x + b == v for x, v in zip(xs, values)):
            form = name if a == 1 else f"{a} * {name}"
            return form if b == 0 else f"{form} {'+' if b > 0 else '-'} {abs(b)}"
    return None


def _point_formula(live_lists: Sequence[Sequence[tuple]],
                   envs: Sequence[Dict[str, int]]) -> str:
    """Closed form of one point's live bytes from the paired live lists
    (``(uid, shape, itemsize)``, allocation order; one list a point)."""
    if len({len(a) for a in live_lists}) != 1:
        raise RuntimeError(
            f"paired runs disagree on the live set: "
            f"{[len(a) for a in live_lists]} buffers — the program is not "
            "the same op sequence at every size point"
        )
    terms: Dict[Tuple[str, ...], int] = {}
    for bufs in zip(*live_lists):
        _, shape0, isz = bufs[0]
        if any(len(b[1]) != len(shape0) or b[2] != isz for b in bufs[1:]):
            raise RuntimeError(
                "paired live buffers disagree in rank/itemsize: "
                + " vs ".join(f"{b[2]}B{list(b[1])}" for b in bufs))
        coeff = isz
        factors: List[str] = []
        for dims in zip(*(b[1] for b in bufs)):
            f = _dim_formula([int(x) for x in dims], envs)
            if f is None:
                coeff *= int(dims[0])
            else:
                factors.append(f)
        if coeff == 0:
            continue
        key = tuple(sorted(factors))
        terms[key] = terms.get(key, 0) + coeff
    parts = []
    for key in sorted(terms, key=lambda k: (-len(k), k)):
        factors = [f"({f})" if ("+" in f or "-" in f) else f for f in key]
        parts.append(" * ".join([str(terms[key])] + factors))
    return " + ".join(parts) if parts else "0"


def _verified(formula: str, envs_and_values) -> str:
    for env, value in envs_and_values:
        got = eval_formula(formula, env)
        if got != value:
            raise RuntimeError(
                f"memory formula self-check failed: {formula!r} = {got} "
                f"but the run observed {value} (env {env})")
    return formula


def state_formula(runs, prog: str, name: str) -> str:
    """The at-rest formula of one state argument over paired runs."""
    shapes = [r.programs[prog].state[name] for r in runs]
    lists = [[(0, s, isz)] for s, isz in shapes]
    envs = [r.sizes for r in runs]
    return _verified(_point_formula(lists, envs),
                     [(e, _prod(s) * isz) for e, (s, isz)
                      in zip(envs, shapes)])


def _prod(shape) -> int:
    out = 1
    for d in shape:
        out *= int(d)
    return out


def _peak_form(runs, prog: str, indices: List[int], peaks: List[int],
               captured: List[dict]) -> str:
    envs = [r.sizes for r in runs]
    uniq = sorted(set(indices))

    def point_form(i: int) -> str:
        return _verified(
            _point_formula([c[i] for c in captured], envs),
            [(e, r.programs[prog].point_bytes[i])
             for e, r in zip(envs, runs)])

    if len(uniq) == 1:
        return point_form(uniq[0])
    return _verified("max(" + ", ".join(point_form(i) for i in uniq) + ")",
                     list(zip(envs, peaks)))


def generate_memory_section(runs, recapture) -> dict:
    """One mesh's memory section from runs of one config at the fit
    points (``runs``, the first at ``AuditParams``). ``recapture(points)``
    reruns the programs at every fit point keeping the live buffers at
    ``{program: points}`` and returns the new runs."""
    progs = list(runs[0].programs)
    want: Dict[str, set] = {}
    for prog in progs:
        pts = {r.programs[prog].peak_index for r in runs}
        pts |= {i for r in runs
                if (i := r.programs[prog].round_peak_index()) is not None}
        want[prog] = pts
    caps = recapture({p: tuple(sorted(v)) for p, v in want.items()})
    out: Dict[str, dict] = {}
    envs = [r.sizes for r in runs]
    for prog in progs:
        prs = [r.programs[prog] for r in runs]
        if len({len(p.point_bytes) for p in prs}) != 1:
            raise RuntimeError(
                f"{runs[0].config.name}/{prog}: the fit runs take "
                f"{[len(p.point_bytes) for p in prs]} ops — not one op "
                "sequence")
        captured = [c.programs[prog].captured for c in caps]
        rids = [p.round_peak_index() for p in prs]
        at_rest = [[name, state_formula(runs, prog, name)]
                   for name in STATE_ARGS.get(prog, ())
                   if name in prs[0].state]
        if "w" in prs[0].state:
            at_rest.append(["w", state_formula(runs, prog, "w")])
        in_place = [name for name in prs[0].in_place]
        in_place_form = "0"
        if in_place:
            lists = [[(0,) + r.programs[prog].state[k] for k in in_place]
                     for r in runs]
            in_place_form = _verified(
                _point_formula(lists, envs),
                [(e, sum(_prod(r.programs[prog].state[k][0])
                         * r.programs[prog].state[k][1] for k in in_place))
                 for e, r in zip(envs, runs)])
        out[prog] = {
            "at_rest": at_rest,
            "peak": _peak_form(runs, prog, [p.peak_index for p in prs],
                               [p.peak for p in prs], captured),
            "round_peak": (
                _peak_form(runs, prog, rids, [p.round_peak for p in prs],
                           captured)
                if all(r is not None for r in rids) else "0"),
            "in_place": in_place_form,
            "in_place_args": in_place,
        }
    return {"programs": out}


def held_out_check(section: dict, run) -> List[str]:
    """Mismatches of a memory section against a run at another size."""
    out = []
    for prog, spec in section["programs"].items():
        pr = run.programs[prog]
        for key, observed in (("peak", pr.peak),
                              ("round_peak", pr.round_peak)):
            want = eval_formula(spec[key], run.sizes)
            if want != observed:
                out.append(f"{prog}/{key}: formula {spec[key]!r} = {want}B "
                           f"but the run at n={run.params.n} capacity="
                           f"{run.params.capacity} lanes={run.params.lanes}"
                           f" holds {observed}B")
    return out


# -- the replicated-O(n)-buffer rule --------------------------------------
def replicated_vertex_sites(shapes: Sequence[Tuple[str, int]], n: int,
                            n_owned: int, hcap: int
                            ) -> List[Tuple[str, int]]:
    """The vertex-domain buffers (``vertex_layout.record_shapes``
    records) with ``n`` or more rows: under ``"range"`` / ``"halo"``
    every one must be an owned slice (``n_owned`` rows) or a halo array
    (``hcap`` rows, O(window + lanes), clamped to ``n_pad``), never a
    replicated ``[n]`` copy. The rule needs ``n_owned < n`` (two owners
    at least) and ``hcap < n`` (the audit point's halo is not clamped),
    else the sizes cannot tell the kinds apart."""
    if n_owned >= n:
        return []
    return [(op, rows) for op, rows in shapes
            if rows >= n and rows != hcap]


# -- the check rule -----------------------------------------------------------
@rule("memory_budget")
def check_memory(run, budget: dict) -> List[Finding]:
    cfg = run.config
    env = run.sizes
    findings: List[Finding] = []

    def bad(msg: str, program: str = "") -> None:
        findings.append(Finding("memory_budget", cfg.name, msg, program))

    mem = mesh_section(budget, "memory", run.mesh_key)
    if mem is None:
        bad(f"no memory section for mesh {run.mesh_key} — regenerate with "
            "`python -m repro_torch.analysis.audit --write-budgets`")
        return findings
    specs = mem.get("programs", {})
    for prog, pr in run.programs.items():
        spec = specs.get(prog)
        if spec is None:
            bad(f"no memory budget for program {prog!r}", prog)
            continue
        for key, observed in (("peak", pr.peak),
                              ("round_peak", pr.round_peak)):
            want = eval_formula(spec.get(key, "0"), env)
            if want != observed:
                bad(f"{key} live bytes drifted: budget formula "
                    f"{spec.get(key)!r} = {want}B but the run holds "
                    f"{observed}B on this rank", prog)
        rest = dict(spec.get("at_rest", []) or [])
        for name, (shape, isz) in pr.state.items():
            entry = rest.get(name)
            actual = _prod(shape) * isz
            if entry is None:
                bad(f"at_rest entry for state arg {name!r} missing from the "
                    "memory budget", prog)
            elif eval_formula(entry, env) != actual:
                bad(f"at_rest[{name}]: formula {entry!r} = "
                    f"{eval_formula(entry, env)}B but the state buffer "
                    f"holds {actual}B on this rank", prog)
        if sorted(spec.get("in_place_args", [])) != sorted(pr.in_place):
            bad(f"in-place state drifted: budget "
                f"{spec.get('in_place_args')} vs run {list(pr.in_place)}",
                prog)
    if budget.get("forbid_replicated_vertex_buffers"):
        for prog, pr in run.programs.items():
            for op, rows in replicated_vertex_sites(
                    pr.vertex_shapes, env["n"], env["n_owned"],
                    env["hcap"]):
                bad(f"O(n)-replicated vertex buffer: {op} allocates {rows} "
                    f"rows (>= n={env['n']}) under "
                    f"{cfg.vertex_sharding!r} — vertex-sized state must "
                    "stay owned slices", prog)
    return findings
