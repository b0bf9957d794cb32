"""Auditing of the engine matrix's programs — the port's counterpart of
``repro.analysis``.

The reference reads traced jaxprs; the port RUNS each program once on
small seeded state under a ``TorchDispatchMode`` (``walker.RoundRecorder``)
and reads what the dispatcher saw: a round is the code between two
loop-condition host syncs, as the reference's round is a ``while``
body. Per engine configuration, before any benchmark runs, it answers:

  * what collectives each fixpoint round issues, at what payload
    (``collective_budget`` against the committed ``budgets/<engine>.json``,
    with the call-time traffic notes cross-checked against the c10d ops),
  * which host syncs a batch and a round pay, each named in
    ``hostlint.SYNC_SITES``, each loop condition once an iteration of
    its loop, and no large device-to-host copy (``host_sync``),
  * whether the state arguments the reference donates are written in
    place or dropped (``donation``),
  * whether an integer narrowing ever meets a value outside the narrower
    type, the ``1 << 62`` sentinel among them (``dtype_policy``),
  * how many launch-class ops a round issues (on the card: how many CUDA
    kernels, from ``torch.profiler``), and that the hand-written kernels'
    rounds launch strictly fewer CUDA kernels than their torch twin over
    the same collectives (``launch_budget`` and ``launch_budget_twin``;
    the twin check runs on the card only and reports itself not run
    elsewhere),
  * how many ``(window, cap)`` buckets the planners can key
    (``recompile_surface``),
  * what each program keeps alive per rank — peak / per-round / at-rest
    / in-place byte formulas, and no ``[n]`` vertex buffer under the
    range layouts (``memory_budget``, ``memory.py``),

plus an AST lint of the batch path's syncs (``hostlint``). CLI:
``python -m repro_torch.analysis.audit --engine all`` on the card, or
``... --device cpu [--world 4]`` on the host.

Names of the reference with no counterpart here: ``sub_jaxprs``,
``iter_sites``, ``program_body`` and ``body_arg_map`` walk or unwrap a
traced program, and the port has none (a run's ops are recorded as they
dispatch; each rank runs its own program, so there is no shard_map body
to unwrap); the lowered-HLO donation markers (``tf.aliasing_output``,
``jax.buffer_donor``) have no PyTorch lowering to read, so ``donation``
checks storages and weakrefs instead; ``check_bench`` (``benchcheck``)
checks a bench artifact that only a benchmark of the port's own will
write.

The CLI module's names (``audit_engines``, ``load_budget``, ...) load on
first use, so ``python -m repro_torch.analysis.audit`` does not find its
own module imported by the package first.
"""
from .hostlint import SYNC_SITES, LintFinding, lint_file  # noqa: F401
from .memory import (  # noqa: F401
    generate_memory_section,
    replicated_vertex_sites,
)
from .programs import (  # noqa: F401
    ENGINE_CONFIGS,
    AuditParams,
    EngineConfig,
    RunEngine,
    record_program,
    run_engine,
    run_promotion_round,
    run_removal_round,
    run_weighted_round,
)
from .rules import (  # noqa: F401
    RULES,
    TRAFFIC_TO_PRIM,
    Finding,
    NotRun,
    cross_check_round,
    eval_formula,
    guess_formula,
    loop_sync_mismatches,
    run_rules,
    split_round_collectives,
)
from .walker import (  # noqa: F401
    COLLECTIVE_OPS,
    LAUNCH_OPS,
    CollectiveSite,
    LoopCounter,
    RoundRecorder,
    Site,
    collectives,
    count_collectives,
    count_round_launches,
    cuda_round_kernels,
    op_names,
    primitive_names,
    tainted_truncations,
)

_AUDIT_NAMES = frozenset({
    "BUDGET_DIR", "BUDGET_SCHEMA", "SCHEMA", "audit_engines",
    "generate_budget", "load_budget", "make_check", "make_report",
    "write_budgets",
})


def __getattr__(name):
    if name in _AUDIT_NAMES:
        from . import audit
        return getattr(audit, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
