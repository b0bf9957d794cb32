"""AST lint: no device->host sync in the port's batch path beyond the
ones ``SYNC_SITES`` names.

The counterpart of the reference's ``analysis/hostlint.py``, with the
same per-function lint over the same targets (``LINT_TARGETS``:
``core/api.py``, ``engine.py``, ``sharded.py``, ``remove.py``,
``insert.py``, ``vertex_layout.py`` and ``launch/mesh.py``; the port
adds ``graph_ops.py`` and ``order.py``, whose loop conditions and
renumber gate are host reads too, and ``kernels/order.py``'s wrapper,
whose launch sizes its scratch from host numbers only). Forbidden inside
a linted function:

  * ``<expr>.block_until_ready(...)``, ``<expr>.item()`` and
    ``torch.cuda.synchronize(...)`` — always a sync;
  * ``int(...)`` / ``float(...)`` / ``bool(...)`` / ``np.asarray(...)``
    / ``np.array(...)`` applied to, and ``.tolist()`` / ``.cpu()`` /
    ``.numpy()`` called on, an expression that mentions a
    device-resident field (``self.src`` etc., ``DEVICE_FIELDS``) or a
    device parameter or loop verdict by bare name (``DEVICE_PARAMS``).

The reference's batch program is one compiled program with no host
read; the port's fixpoints are Python loops, and each iteration reads
its verdict on the host BY DESIGN. Those reads are not exempt by a mark:
``SYNC_SITES`` names each one — file, function, the call, how many per
iteration of what, and why. A construct in a linted function passes
only under an entry of its file, function and call, at most ``count``
of them; a renamed function loses its entry and fires again. The
``# sync: ok`` mark exempts a line as in the reference (for files
outside the targets); in the port's targets a mark is itself a finding
(``lint_targets``), so no sync hides behind one.

``SYNC_SITES`` also lists the syncs the recorder sees at run time and
the AST cannot (a boolean-mask index, ``torch.unique``, a tensor built
from Python data: each blocks the host on a card): the ``host_sync``
audit rule holds every sync of a recorded run to an entry of its
issuing function and kind.

Run as ``python -m repro_torch.analysis.hostlint``.
"""
from __future__ import annotations

import ast
import dataclasses
import os
import sys
from typing import Dict, List, Optional, Sequence, Tuple

_PKG = os.path.normpath(os.path.join(os.path.dirname(__file__), os.pardir))
_CORE_DIR = os.path.join(_PKG, "core")
_LAUNCH_DIR = os.path.join(_PKG, "launch")
API_PATH = os.path.join(_CORE_DIR, "api.py")
ENGINE_PATH = os.path.join(_CORE_DIR, "engine.py")
SHARDED_PATH = os.path.join(_CORE_DIR, "sharded.py")
REMOVE_PATH = os.path.join(_CORE_DIR, "remove.py")
INSERT_PATH = os.path.join(_CORE_DIR, "insert.py")
VERTEX_LAYOUT_PATH = os.path.join(_CORE_DIR, "vertex_layout.py")
GRAPH_OPS_PATH = os.path.join(_CORE_DIR, "graph_ops.py")
ORDER_PATH = os.path.join(_CORE_DIR, "order.py")
ORDER_KERNELS_PATH = os.path.join(_PKG, "kernels", "order.py")
MESH_PATH = os.path.join(_LAUNCH_DIR, "mesh.py")

# the per-batch edit path + every planning helper it calls
SYNC_FREE_FUNCS = frozenset({
    "apply_batch",
    "insert_edges",
    "remove_edges",
    "_validated",
    "_ensure_capacity",
    "_window",
    "_frontier_bucket",
    "_get_sharded_fn",
    "plan_window",
    "plan_frontier_cap",
    "bucket_lattice",
})

LINT_TARGETS = {
    API_PATH: SYNC_FREE_FUNCS,
    ENGINE_PATH: frozenset({
        "batch_program", "apply_batch", "batch_dedup", "table_lookup",
        "batch_program_halo", "build_halo_ids", "apply_batch_weighted",
    }),
    SHARDED_PATH: frozenset({"make_sharded_apply"}),
    REMOVE_PATH: frozenset({
        "removal_fixpoint", "removal_fixpoint_halo",
        "weighted_core_fixpoint_pass", "weighted_core_fixpoint_pass_halo",
        "_weighted_h_index_halo", "remove_batch",
    }),
    INSERT_PATH: frozenset({
        "freelist_alloc", "write_edge_slots",
        "promotion_fixpoint", "promotion_fixpoint_halo",
        "_forward_reach", "_forward_reach_halo",
        "_evict_fixpoint", "_evict_fixpoint_halo",
        "weighted_promotion_fixpoint", "weighted_promotion_fixpoint_halo",
        "insert_batch",
    }),
    VERTEX_LAYOUT_PATH: frozenset({
        "bind", "gather_values", "complete", "refresh_mask",
        "refresh_values", "locate", "any_owned", "frontier_peak",
        "add_at", "gather_state", "gather_mask", "own", "make_layout",
        "_overflowed", "_sparse_payload", "_halo_targets", "_set_halo",
    }),
    GRAPH_OPS_PATH: frozenset({
        "weighted_h_index", "weighted_support", "mcd_hi_dout",
        "hi_and_dout_same", "din_and_expand", "count_same_level_in",
        "slot_high_water",
    }),
    ORDER_PATH: frozenset({
        "maybe_renumber", "maybe_renumber_ring", "place_block",
        "place_block_plain", "place_levels_plain", "_mover_order",
        "_level_bases", "_place_from_ranks", "place_block_ring",
    }),
    ORDER_KERNELS_PATH: frozenset({"place_levels"}),
    MESH_PATH: frozenset({
        "make_edge_mesh", "make_edge_vertex_mesh", "make_mesh",
    }),
}

DEVICE_FIELDS = frozenset({
    "src", "dst", "valid", "core", "label", "n_edges", "w",
    "last_batch_stats", "last_insert_stats", "last_remove_stats",
})

DEVICE_PARAMS = frozenset({
    "src", "dst", "valid", "core", "label", "n_edges", "stats",
    "seed", "slots",
    "owned", "owned_mask", "halo_ids", "core_own", "label_own",
    "src_h", "dst_h", "core_h", "label_h",
    "w", "total_w", "ins_w",
    "new_src", "new_dst", "new_ok", "iok", "rok",
    "hi", "dout_same", "u_pos", "v_pos",
    # the port's loop verdicts and the tensors they are read from
    "cont", "changed", "need", "drop", "lo", "g_idx",
})

STATIC_META_ATTRS = frozenset({"shape", "dtype", "ndim", "size",
                               "itemsize", "sharding", "device"})

SYNC_BUILTINS = frozenset({"int", "float", "bool"})
SYNC_ATTR_CALLS = frozenset({
    ("np", "asarray"), ("np", "array"),
    ("numpy", "asarray"), ("numpy", "array"),
    ("jax", "device_get"),
})
# the torch idiom beside the reference's: these methods sync when their
# receiver is device state (``self.core.tolist()``), as the calls above
# do on a device argument; ``.item()`` and ``torch.cuda.synchronize``
# always do
SYNC_METHOD_CALLS = frozenset({"tolist", "cpu", "numpy"})
ALLOW_MARK = "# sync: ok"


@dataclasses.dataclass(frozen=True)
class SyncSite:
    """One sync the port keeps by design.

    ``path`` is relative to the package (``core/remove.py``), ``func``
    the function that issues it, ``call`` the construct (``"bool"``,
    ``"int"``: a host read the AST lint sees; ``"torch.tensor"``,
    ``"mask index"``, ``"torch.unique"``, ``".to(device)"``: a hidden
    sync only the recorder sees), ``count`` how many such constructs the
    function holds, ``per`` what one sync is paid for, ``why`` the
    reason."""

    path: str
    func: str
    call: str
    count: int
    per: str
    why: str

    @property
    def where(self) -> str:
        return f"{self.path}::{self.func}"

    @property
    def kind(self) -> str:
        """The recorder's sync kind: a host read ends a round."""
        return "round" if self.call in ("bool", "int") else "hidden"


_LOOP = ("the fixpoint's loop condition: the reference's lax.while_loop "
         "is a Python loop here, and every rank reads the same completed "
         "verdict")
_ROUNDS = ("`rounds` counted on the host, returned as a device scalar "
           "(the reference's loop carry): one host-to-device copy a call")
_MASK = ("compacts the kept batch lanes by a boolean mask (nonzero sizes "
         "the result on the host); O(batch), once a batch")

SYNC_SITES: Tuple[SyncSite, ...] = (
    # -- loop conditions (the lines ROADMAP's parked list names) ---------
    SyncSite("core/remove.py", "removal_fixpoint", "bool", 1, "round", _LOOP),
    SyncSite("core/remove.py", "weighted_core_fixpoint_pass", "bool", 1,
             "round", _LOOP),
    SyncSite("core/remove.py", "removal_fixpoint_halo", "bool", 1, "round",
             _LOOP),
    SyncSite("core/remove.py", "_weighted_h_index_halo", "bool", 1, "step",
             "the halo bisection's loop condition (an all-reduced verdict)"),
    SyncSite("core/remove.py", "weighted_core_fixpoint_pass_halo", "bool",
             1, "round", _LOOP),
    SyncSite("core/insert.py", "promotion_fixpoint", "bool", 1, "round",
             _LOOP),
    SyncSite("core/insert.py", "_forward_reach", "bool", 1, "wave",
             "the forward wave's loop condition"),
    SyncSite("core/insert.py", "_evict_fixpoint", "bool", 1,
             "eviction round", "the eviction fixpoint's loop condition"),
    SyncSite("core/insert.py", "promotion_fixpoint_halo", "bool", 1,
             "round", _LOOP),
    SyncSite("core/insert.py", "_forward_reach_halo", "bool", 1, "wave",
             "the forward wave's loop condition (an all-reduced verdict)"),
    SyncSite("core/insert.py", "_evict_fixpoint_halo", "bool", 1,
             "eviction round",
             "the eviction fixpoint's loop condition (all-reduced)"),
    SyncSite("core/graph_ops.py", "weighted_h_index", "bool", 1, "step",
             "the weighted h-index bisection's loop condition"),
    SyncSite("core/order.py", "maybe_renumber", "bool", 1, "batch",
             "the renumber gate: the reference's lax.cond is a Python "
             "branch"),
    SyncSite("core/order.py", "maybe_renumber_ring", "bool", 1, "batch",
             "the ring renumber gate (an all-reduced verdict)"),
    SyncSite("core/vertex_layout.py", "_overflowed", "bool", 1,
             "sparse refresh",
             "the sparse exchange's fallback choice, read off the gathered "
             "counts: the reference's lax.cond is a Python branch"),
    SyncSite("core/api.py", "_refresh_bounds", "int", 2,
             "window growth", "the amortized exact-bound refresh"),
    SyncSite("core/api.py", "_observed_frontier", "int", 1, "batch",
             "the planned sparse cap reads earlier batches' pmaxed "
             "max_frontier (the same on every rank)"),
    # -- hidden syncs the recorder sees ------------------------------------
    SyncSite("core/remove.py", "removal_fixpoint", "torch.tensor", 1,
             "batch", _ROUNDS),
    SyncSite("core/remove.py", "weighted_core_fixpoint_pass",
             "torch.tensor", 1, "batch", _ROUNDS),
    SyncSite("core/remove.py", "removal_fixpoint_halo", "torch.tensor", 2,
             "batch", _ROUNDS + " (and `n_overflow`)"),
    SyncSite("core/remove.py", "weighted_core_fixpoint_pass_halo",
             "torch.tensor", 1, "batch", _ROUNDS),
    SyncSite("core/insert.py", "promotion_fixpoint", "torch.tensor", 1,
             "batch", _ROUNDS),
    SyncSite("core/insert.py", "promotion_fixpoint_halo", "torch.tensor",
             2, "batch", _ROUNDS + " (and `n_overflow`)"),
    SyncSite("core/engine.py", "batch_program", "mask index", 5, "batch",
             _MASK + "; `valid[slots] = True` lifts a Python bool"),
    SyncSite("core/engine.py", "batch_program_halo", "mask index", 5,
             "batch", _MASK + "; `valid[slots] = True` lifts a Python "
             "bool"),
    SyncSite("core/engine.py", "build_halo_ids", "torch.unique", 1,
             "batch", "the halo membership's unique ids (sized on the "
             "host), once a batch"),
    SyncSite("core/insert.py", "write_edge_slots", "mask index", 4,
             "call", "the host engine's bump allocation compacts the kept "
             "lanes"),
    SyncSite("core/api.py", "apply_batch", ".to(device)", 7, "batch",
             "uploads the padded batch lanes from the host"),
)


def sites_by_where() -> Dict[Tuple[str, str], SyncSite]:
    """``{(path::func, kind): entry}`` for the recorder's check."""
    return {(s.where, s.kind): s for s in SYNC_SITES}


@dataclasses.dataclass(frozen=True)
class LintFinding:
    path: str
    func: str
    lineno: int
    message: str

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)

    def __str__(self) -> str:
        return (f"{self.path}:{self.lineno}: in sync-free "
                f"{self.func}(): {self.message}")


def _touches_device_state(node: ast.AST) -> bool:
    if isinstance(node, ast.Attribute):
        if node.attr in STATIC_META_ATTRS:
            return False
        if (isinstance(node.value, ast.Name)
                and node.value.id == "self"
                and node.attr in DEVICE_FIELDS):
            return True
    if isinstance(node, ast.Name) and node.id in DEVICE_PARAMS:
        return True
    return any(_touches_device_state(c) for c in ast.iter_child_nodes(node))


def _sync_calls(fn: ast.AST, lines: Sequence[str]):
    """Yield ``(node, call, message)`` for every sync construct in a
    function, skipping ``# sync: ok`` lines."""
    for node in ast.walk(fn):
        if not isinstance(node, ast.Call):
            continue
        line = lines[node.lineno - 1] if node.lineno <= len(lines) else ""
        if ALLOW_MARK in line:
            continue
        f = node.func
        if isinstance(f, ast.Attribute):
            if f.attr == "item" and not node.args:
                yield node, ".item()", (
                    "calls .item() — an unconditional device sync")
            elif (f.attr in SYNC_METHOD_CALLS and not node.args
                    and _touches_device_state(f.value)):
                yield node, f".{f.attr}()", (
                    f".{f.attr}() forces a device-resident field to host")
            elif f.attr == "block_until_ready":
                yield node, ".block_until_ready()", (
                    "calls .block_until_ready() — an unconditional device "
                    "sync")
            elif (f.attr == "synchronize" and isinstance(f.value,
                                                         ast.Attribute)
                    and f.value.attr == "cuda"):
                yield node, "torch.cuda.synchronize", (
                    "calls torch.cuda.synchronize() — a device sync")
            elif (isinstance(f.value, ast.Name)
                    and (f.value.id, f.attr) in SYNC_ATTR_CALLS
                    and any(_touches_device_state(a) for a in node.args)):
                yield node, f"{f.value.id}.{f.attr}", (
                    f"{f.value.id}.{f.attr}(...) forces a device-resident "
                    "field to host")
        elif (isinstance(f, ast.Name) and f.id in SYNC_BUILTINS
                and any(_touches_device_state(a) for a in node.args)):
            yield node, f.id, (
                f"{f.id}(...) forces a device-resident field to host "
                "(blocks on the in-flight batch)")


def _rel(path: str) -> str:
    p = os.path.normpath(os.path.abspath(path))
    if p.startswith(_PKG + os.sep):
        return os.path.relpath(p, _PKG).replace(os.sep, "/")
    return p


def lint_file(path: Optional[str] = None,
              funcs: Optional[frozenset] = None,
              sites: Optional[Sequence[SyncSite]] = None
              ) -> List[LintFinding]:
    """Lint one source file; returns findings for every sync construct
    inside the named functions (default: the file's ``LINT_TARGETS``
    entry, or the api.py set) that no ``sites`` entry (default
    ``SYNC_SITES``) allows."""
    path = path or API_PATH
    if funcs is None:
        funcs = LINT_TARGETS.get(os.path.normpath(path), SYNC_FREE_FUNCS)
    allowed = {(s.path, s.func, s.call): s.count
               for s in (SYNC_SITES if sites is None else sites)}
    rel = _rel(path)
    with open(path) as fh:
        src = fh.read()
    tree = ast.parse(src, filename=path)
    lines = src.splitlines()
    findings: List[LintFinding] = []
    for node in ast.walk(tree):
        if (isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
                and node.name in funcs):
            used: Dict[str, int] = {}
            for call_node, call, msg in _sync_calls(node, lines):
                key = (rel, node.name, call)
                used[call] = used.get(call, 0) + 1
                if used[call] <= allowed.get(key, 0):
                    continue  # a named sync (SYNC_SITES)
                findings.append(LintFinding(path, node.name,
                                            call_node.lineno, msg))
    return findings


def lint_targets() -> List[LintFinding]:
    """Every target file: the sync lint, and no ``# sync: ok`` mark (an
    allowed sync is a ``SYNC_SITES`` entry, never a mark)."""
    findings: List[LintFinding] = []
    for path, funcs in sorted(LINT_TARGETS.items()):
        findings += lint_file(path, funcs)
        with open(path) as fh:
            for i, line in enumerate(fh, 1):
                if ALLOW_MARK in line and not line.lstrip().startswith(
                        ("#", '"', "'")) and "ALLOW_MARK" not in line:
                    findings.append(LintFinding(
                        path, "", i, f"a `{ALLOW_MARK}` mark hides a sync: "
                        "name it in SYNC_SITES instead"))
    return findings


def main(argv: Optional[Sequence[str]] = None) -> int:
    paths = list(argv if argv is not None else sys.argv[1:])
    findings = ([f for p in paths for f in lint_file(p)] if paths
                else lint_targets())
    for f in findings:
        print(f)
    if findings:
        print(f"hostlint: {len(findings)} sync violation(s)")
        return 1
    names = paths or sorted(LINT_TARGETS)
    print(f"hostlint: clean ({', '.join(os.path.basename(p) for p in names)};"
          f" {len(SYNC_SITES)} named sync sites)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
