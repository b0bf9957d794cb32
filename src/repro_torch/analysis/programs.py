"""Run the engine matrix's programs on small seeded state for auditing.

The counterpart of the reference's ``analysis/programs.py``. The
reference traces each program (``jax.make_jaxpr``) and never executes
it; the port has no trace, so it RUNS each program once under
``walker.RoundRecorder`` on the state the reference traces (an empty
slot table, every core 0, masked batch lanes) at fixed small sizes, and
the audit rules read the recorded sites:

* ``ENGINE_CONFIGS`` — the reference's nine engine configurations
  (host / unified / sharded / vertex_range / frontier_sparse /
  vertex_halo / cuda / weighted / weighted_sharded). The reference's
  ``pallas`` config is ``cuda`` here: the replicated sharded engine
  with ``kernel_backend="cuda"`` (the hand-written kernels compute the
  LOCAL partials the layout completes), and its twin is ``sharded``:
  the same collectives, strictly fewer launches a round on the card.
  ``vertex_halo`` runs on a 2-axis ``(d_e, d_v)`` mesh
  (``launch/mesh.py::make_edge_vertex_mesh``), ``(2, 2)`` by default
  on 4 ranks; the audit also runs it under ``(4, 1)``;
* ``run_removal_round`` / ``run_promotion_round`` /
  ``run_weighted_round`` — the counterparts of ``trace_*_round``: ONE
  fixpoint round under a vertex layout, returning the call-time traffic
  log (``record_traffic``) and the recorded sites. The seeded state
  makes the fixpoint run exactly one round (one wave and one eviction
  round inside a promotion round, one bisection step inside a weighted
  round), so the in-round sites ARE the per-round program.
  ``overflow=True`` seeds 40 changed owners on owner 0 instead, so
  every sparse refresh of the first round overflows a cap of 16 and
  takes its dense fallback (the port records only the arm it takes; the
  reference traces both), and a removal runs a second round that drops
  nothing;
* ``run_engine`` — the full picture for one config: each batch
  program's run (sites, live bytes, what happened to the state
  arguments), the round runs, the planned (window, frontier-cap)
  bucket and the size environment budget formulas evaluate in.

Every run takes the card unless the caller asks for the CPU
(``device="cpu"``, as the tests do): ``device=None`` is the card, and
without one it raises (``repro_torch.device.resolve_device``). On the
card the round runs also count each round's CUDA kernels
(``RoundRecorder(profile_kernels=True)``).

Every sharded run is SPMD: every rank of the initialized
``torch.distributed`` world calls it with the same arguments, and each
rank gets its own record (the audit reads rank 0's). ``n`` and
``capacity`` must divide by the world (and ``n`` by ``d_v``), so the
range and halo layouts pad nothing and the formulas stay exact. ``n``
is not a power of two, so a pow2 halo capacity never equals ``n`` or
``n_owned``.
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from ..core.api import bucket_lattice, plan_frontier_cap, plan_window
from ..core.engine import (apply_batch, apply_batch_weighted,
                           build_halo_ids, halo_cap_for)
from ..core.insert import (insert_batch, promotion_fixpoint,
                           promotion_fixpoint_halo)
from ..core.remove import (remove_batch, removal_fixpoint,
                           removal_fixpoint_halo,
                           weighted_core_fixpoint_pass)
from ..core.sharded import make_sharded_apply
from ..core.vertex_layout import (ReplicatedVertices, Traffic, make_layout,
                                  record_shapes, record_traffic)
from ..device import resolve_device
from ..launch.mesh import (EDGE_SHARD_AXIS, make_edge_mesh,
                           make_edge_vertex_mesh, table_group)
from .walker import RoundRecorder, Site

EDGE_AXIS = "data"
# the state arguments the reference donates (``DONATED_STATE_ARGS``);
# the port writes them in place or drops them (``rules.check_donation``)
DONATED_STATE_ARGS = ("src", "dst", "valid", "core", "label", "n_edges")
WEIGHTED_DONATED_STATE_ARGS = ("src", "dst", "valid", "w", "core", "label",
                               "n_edges")
# owner 0's changed vertices in an overflow-seeded round (> the cap 16)
OVERFLOW_ROWS = 40


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """One point of the engine matrix, keyed by its audit name."""

    name: str
    engine: str                       # "host" | "unified" | "sharded"
    vertex_sharding: str = "replicated"
    frontier_exchange: str = "bitmask"
    frontier_cap: int = 0             # pinned sparse cap (sparse only)
    freelist: str = "interleaved"
    kernel_backend: str = "torch"     # "torch" | "cuda" stat kernels
    weighted: bool = False
    # the canonical (d_e, d_v) factorization of vertex_sharding="halo"
    mesh_shape: Optional[Tuple[int, int]] = None

    @property
    def is_sharded(self) -> bool:
        return self.engine == "sharded"


ENGINE_CONFIGS: Dict[str, EngineConfig] = {
    c.name: c
    for c in (
        EngineConfig("host", "host"),
        EngineConfig("unified", "unified"),
        EngineConfig("sharded", "sharded"),
        EngineConfig("vertex_range", "sharded", vertex_sharding="range"),
        EngineConfig(
            "frontier_sparse", "sharded", vertex_sharding="range",
            frontier_exchange="sparse", frontier_cap=16,
        ),
        EngineConfig(
            "vertex_halo", "sharded", vertex_sharding="halo",
            frontier_exchange="sparse", frontier_cap=16,
            mesh_shape=(2, 2),
        ),
        EngineConfig("cuda", "sharded", kernel_backend="cuda"),
        EngineConfig("weighted", "unified", weighted=True),
        EngineConfig("weighted_sharded", "sharded", weighted=True),
    )
}


@dataclasses.dataclass(frozen=True)
class AuditParams:
    """Fixed run sizes (the reference's): ``n`` and ``capacity`` divide
    by every audited world (1 and 4, in every factorization)."""

    n: int = 192
    capacity: int = 384
    lanes: int = 8  # padded batch lanes (both insert and remove lists)

    @property
    def n_levels(self) -> int:
        return self.n + 2


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def resolve_mesh(cfg: EngineConfig,
                 mesh_shape: Optional[Tuple[int, int]] = None):
    """The mesh a sharded config runs on over the initialized world: the
    1-D edge mesh, or under ``"halo"`` the 2-axis mesh of
    ``mesh_shape`` (else the config's canonical factorization when it
    fits the world, else ``(1, world)``)."""
    d = world_size()
    if cfg.vertex_sharding != "halo":
        if mesh_shape is not None:
            raise ValueError(
                f"mesh_shape={mesh_shape} applies only to "
                "vertex_sharding='halo' configs"
            )
        return make_edge_mesh(axis=EDGE_AXIS)
    shape = mesh_shape or cfg.mesh_shape or (1, d)
    if shape[0] * shape[1] != d:
        if mesh_shape is not None:
            raise ValueError(
                f"mesh_shape {shape[0]}x{shape[1]} needs "
                f"{shape[0] * shape[1]} ranks, the world has {d}"
            )
        shape = (1, d)
    return make_edge_vertex_mesh(mesh_shape=tuple(shape), axis=EDGE_AXIS,
                                 edge_axis=EDGE_SHARD_AXIS)


def _geometry(mesh):
    """(owner group, edge groups, d_e, d_v, table rank, owner rank)."""
    names = tuple(mesh.mesh_dim_names)
    group = mesh.get_group(EDGE_AXIS)
    edge = tuple(mesh.get_group(a) for a in names if a != EDGE_AXIS)
    d_v = dist.get_world_size(group)
    d_e = mesh.size() // d_v
    tg = table_group(mesh)
    return (group, edge, d_e, d_v, dist.get_rank(tg),
            dist.get_rank(group))


def _shard(x: torch.Tensor, parts: int, r: int) -> torch.Tensor:
    k = x.shape[0] // parts
    return x[r * k:(r + 1) * k].clone()


def _zeros(k, dtype, device):
    return torch.zeros(k, dtype=dtype, device=device)


def _check_sizes(n: int, cap: int, d: int, d_v: int) -> None:
    if n % d_v or cap % d:
        raise ValueError(
            f"audit sizes n={n}, capacity={cap} must divide the world "
            f"d={d} and d_v={d_v} (pad-free range/halo layouts keep the "
            "formulas exact)"
        )


def _device(device) -> str:
    """The run's device as a string: None is the card (raises without
    one)."""
    return str(resolve_device(device))


def _recorder(device) -> RoundRecorder:
    """A round run's recorder: on the card it also counts each round's
    CUDA kernels."""
    return RoundRecorder(profile_kernels=device.startswith("cuda"))


def _round_state(n, cap, lanes, device, overflow: bool, what: str):
    """The global state of one seeded round: no live slot (src 0, dst 1),
    masked lanes; ``overflow`` seeds ``OVERFLOW_ROWS`` changed owners on
    owner 0 (cores 1 to drop, or ``hi`` 1 to promote)."""
    src = _zeros(cap, torch.int32, device)
    dst = torch.ones(cap, dtype=torch.int32, device=device)
    valid = _zeros(cap, torch.bool, device)
    core = _zeros(n, torch.int32, device)
    label = _zeros(n, torch.int64, device)
    hi = _zeros(n, torch.int32, device)
    if overflow and what == "removal":
        core[:OVERFLOW_ROWS] = 1
    if overflow and what == "promotion":
        hi[:OVERFLOW_ROWS] = 1
    nu = _zeros(lanes, torch.int32, device)
    nv = torch.ones(lanes, dtype=torch.int32, device=device)
    nok = _zeros(lanes, torch.bool, device)
    return src, dst, valid, core, label, hi, nu, nv, nok


def _run_round(what: str, vertex_sharding: str, n: int, cap: int, mesh,
               frontier_cap, window, lanes, kernel_backend, overflow,
               device) -> Tuple[List[Traffic], List[Site]]:
    device = _device(device)
    group, edge, d_e, d_v, tr, vr = _geometry(mesh)
    d = d_e * d_v
    _check_sizes(n, cap, d, d_v)
    src, dst, valid, core, label, hi, nu, nv, nok = _round_state(
        n, cap, lanes, device, overflow, what)
    src, dst, valid = (_shard(x, d, tr) for x in (src, dst, valid))
    if vertex_sharding in ("range", "halo"):
        layout = make_layout(vertex_sharding, n, group, d_v, frontier_cap,
                             edge, device=device)
        core, label, hi = (_shard(x, d_v, vr) for x in (core, label, hi))
        w = src.shape[0] if window is None else window
        with _recorder(device) as rec, record_traffic() as log:
            src_w, dst_w, valid_w = src[:w], dst[:w], valid[:w]
            halo_ids = build_halo_ids(layout, src_w, dst_w, nu, nv, nu, nv,
                                      n)
            session = layout.bind(halo_ids)
            core_h = session.gather_values(core)
            label_h = session.gather_values(label)
            src_h = session.locate(src_w)
            dst_h = session.locate(dst_w)
            if what == "removal":
                out = removal_fixpoint_halo(
                    src_h, dst_h, valid_w, core, label, core_h, label_h,
                    session, n + 2, kernel_backend=kernel_backend)
            else:
                out = promotion_fixpoint_halo(
                    src_h, dst_h, valid_w, core, label, core_h, label_h,
                    nu, nv, session.locate(nu), session.locate(nv), nok, hi,
                    torch.zeros_like(hi), session, n + 2,
                    kernel_backend=kernel_backend)
        rounds = out[4]
    else:
        layout = ReplicatedVertices(n, group, device=device)
        with _recorder(device) as rec, record_traffic() as log:
            if what == "removal":
                out = removal_fixpoint(src, dst, valid, core, label, n,
                                       n + 2, layout=layout,
                                       kernel_backend=kernel_backend)
            else:
                out = promotion_fixpoint(
                    src, dst, valid, core, label, nu, nv, nok, hi,
                    torch.zeros_like(hi), n, n + 2, layout=layout,
                    kernel_backend=kernel_backend)
        rounds = out[2]
    if not overflow and int(rounds) != 1:
        raise RuntimeError(
            f"the seeded {what} state ran {int(rounds)} rounds, not one"
        )
    return log, rec.sites


def run_removal_round(vertex_sharding: str, n: int, cap: int, mesh,
                      frontier_cap: Optional[int] = None,
                      window: Optional[int] = None, lanes: int = 8,
                      kernel_backend: str = "torch", overflow: bool = False,
                      device=None) -> Tuple[List[Traffic], List[Site]]:
    """Run ONE removal round under a vertex layout on ``mesh``: the halo
    set-up of the batch program (under ``"range"`` / ``"halo"``: the
    membership, ``bind``, the two entry regathers, the positions), then
    the fixpoint, which the seeded state ends after one round. Returns
    ``(traffic log, recorded sites)``. ``window`` is the per-shard
    active window the engine binds its halo over (None: the shard)."""
    return _run_round("removal", vertex_sharding, n, cap, mesh,
                      frontier_cap, window, lanes, kernel_backend, overflow,
                      device)


def run_promotion_round(vertex_sharding: str, n: int, cap: int, mesh,
                        frontier_cap: Optional[int] = None, lanes: int = 8,
                        window: Optional[int] = None,
                        kernel_backend: str = "torch",
                        overflow: bool = False, device=None
                        ) -> Tuple[List[Traffic], List[Site]]:
    """Run ONE promotion round (one forward wave, one eviction round,
    the two placements, the refresh, the next round's statistics and
    the vote) — the insertion-side counterpart of
    ``run_removal_round``."""
    return _run_round("promotion", vertex_sharding, n, cap, mesh,
                      frontier_cap, window, lanes, kernel_backend, overflow,
                      device)


def run_weighted_round(n: int, cap: int, mesh,
                       kernel_backend: str = "torch", device=None
                       ) -> Tuple[List[Traffic], List[Site]]:
    """Run ONE weighted h-index round on the replicated layout: one
    weighted edge ``(0, 1)`` between two vertices of core 1, so the
    bisection takes one step (one support completion) and the round
    moves nothing — the round shape of both weighted phases."""
    device = _device(device)
    group, _, d_e, d_v, tr, _ = _geometry(mesh)
    d = d_e * d_v
    _check_sizes(n, cap, d, d_v)
    src = _zeros(cap, torch.int32, device)
    dst = torch.ones(cap, dtype=torch.int32, device=device)
    valid = _zeros(cap, torch.bool, device)
    valid[0] = True
    ew = torch.ones(cap, dtype=torch.int32, device=device)
    core = _zeros(n, torch.int32, device)
    core[:2] = 1
    src, dst, valid, ew = (_shard(x, d, tr) for x in (src, dst, valid, ew))
    layout = ReplicatedVertices(n, group, device=device)
    with _recorder(device) as rec, record_traffic() as log:
        _, rounds, _ = weighted_core_fixpoint_pass(
            src, dst, valid, ew, core, n, layout=layout,
            kernel_backend=kernel_backend)
    if int(rounds) != 1:
        raise RuntimeError(f"the seeded weighted state ran {int(rounds)} "
                           "rounds, not one")
    return log, rec.sites


@dataclasses.dataclass
class ProgramRun:
    """One batch program's recorded run."""

    sites: List[Site]
    point_bytes: List[int]        # live storage bytes after every op
    point_in_round: List[bool]
    captured: Dict[int, tuple]    # point -> live (uid, shape, itemsize)
    state: Dict[str, Tuple[tuple, int]]  # state arg -> (shape, itemsize)
    in_place: Tuple[str, ...]     # state args the program wrote in place
    freed: Tuple[str, ...]        # state args unreachable after the call
    narrowings: List[str]         # dtype_policy findings of the run
    log: List[Traffic] = dataclasses.field(default_factory=list)
    # (op, rows) of every vertex-domain buffer the halo layout allocated
    vertex_shapes: List[Tuple[str, int]] = dataclasses.field(
        default_factory=list)
    # path::function -> iterations of its loop (``walker.LOOP_FUNCS``)
    iterations: Dict[str, int] = dataclasses.field(default_factory=dict)

    @property
    def peak(self) -> int:
        return max(self.point_bytes) if self.point_bytes else 0

    @property
    def peak_index(self) -> int:
        return self.point_bytes.index(self.peak)

    def round_peak_index(self) -> Optional[int]:
        best = None
        for i, (b, r) in enumerate(zip(self.point_bytes,
                                       self.point_in_round)):
            if r and (best is None or b > self.point_bytes[best]):
                best = i
        return best

    @property
    def round_peak(self) -> int:
        i = self.round_peak_index()
        return 0 if i is None else self.point_bytes[i]


# (config, program) pairs this process has run under the recorder: the
# first run of a program under a dispatch mode takes one-time paths in
# torch (lazy imports that raise and catch), whose exception cycles keep
# frames, and the tensors they hold, alive while garbage collection is
# paused; so the first run is a warm-up and only later runs are kept
_WARMED: set = set()


def record_program(fn, args: list, state: Dict[str, int],
                   outputs: Dict[str, int], capture=(),
                   warm_key=None) -> ProgramRun:
    """Run ``fn(*args)`` once under the recorder with live-byte tracking
    and the narrowing check. ``state`` maps state-argument names to
    their positions in ``args``, ``outputs`` to their positions in the
    result. ``args`` is emptied: after the call only the result holds
    the state, so a state argument the program neither wrote in place
    nor returned is unreachable (its weakref dead). ``warm_key``: run a
    discarded warm-up on copies first, once per key and process."""
    if warm_key is not None and warm_key not in _WARMED:
        copies = [a.clone() if isinstance(a, torch.Tensor) else a
                  for a in args]
        record_program(fn, copies, state, outputs)
        _WARMED.add(warm_key)
    shapes = {k: (tuple(args[i].shape), args[i].element_size())
              for k, i in state.items()}
    ptrs = {k: args[i].untyped_storage().data_ptr()
            for k, i in state.items()}
    refs = {k: weakref.ref(args[i]) for k, i in state.items()}
    with RoundRecorder(track_memory=True, capture=capture,
                       check_narrowing=True) as rec, \
            record_traffic() as log, record_shapes() as vshapes:
        call = tuple(args)
        args.clear()
        rec.track(*call)
        out = fn(*call)
        del call
    in_place = tuple(
        k for k, i in outputs.items() if k in ptrs
        and out[i].untyped_storage().data_ptr() == ptrs[k])
    freed = tuple(k for k in state if k not in in_place
                  and refs[k]() is None)
    del out
    return ProgramRun(rec.sites, rec.point_bytes, rec.point_in_round,
                      rec.captured, shapes, in_place, freed,
                      rec.narrowings, log, list(vshapes), rec.iterations)


@dataclasses.dataclass
class RunEngine:
    """Everything the audit rules inspect for one engine config (the
    counterpart of ``TracedEngine``)."""

    config: EngineConfig
    params: AuditParams
    n_devices: int
    window: int            # planned per-shard active-window bucket
    frontier_cap: int      # planned sparse-cap bucket (0 = exchange off)
    programs: Dict[str, ProgramRun]
    donated: Dict[str, Tuple[str, ...]]   # program -> donated state args
    rounds: Dict[str, Tuple[List[Traffic], List[Site]]]
    overflow: Dict[str, Tuple[List[Traffic], List[Site]]]
    sizes: Dict[str, int]
    device: str = "cpu"
    mesh_shape: Optional[Tuple[int, int]] = None

    @property
    def mesh_key(self) -> str:
        """``"<d_e>x<d_v>"``, with ``"@cuda"`` on the card: the key of the
        manifest's sections that depend on where the program runs (a
        ring step at one owner runs no sort; on the card the kernels
        replace their plain versions and host copies sync)."""
        key = f"{self.sizes['d_e']}x{self.sizes['d_v']}"
        return key + ("@cuda" if self.device.startswith("cuda") else "")


def _lanes(lanes: int, device, weighted: bool) -> list:
    b = _zeros(lanes, torch.int32, device)
    ok = _zeros(lanes, torch.bool, device)
    out = [b, b.clone()]
    if weighted:
        out.append(torch.ones(lanes, dtype=torch.int32, device=device))
    return out + [ok, b.clone(), b.clone(), ok.clone()]


def _program_args(n_state, local_cap, lanes, device, weighted):
    """The reference's ``_batch_args``: an empty table, every core 0,
    masked lanes. Returns (args, state positions)."""
    args = [_zeros(local_cap, torch.int32, device),
            _zeros(local_cap, torch.int32, device),
            _zeros(local_cap, torch.bool, device)]
    names = ["src", "dst", "valid"]
    if weighted:
        args.append(torch.ones(local_cap, dtype=torch.int32, device=device))
        names.append("w")
    args += [_zeros(n_state, torch.int32, device),
             _zeros(n_state, torch.int64, device),
             torch.zeros((), dtype=torch.int32, device=device)]
    names += ["core", "label", "n_edges"]
    state = {k: i for i, k in enumerate(names)}
    return args + _lanes(lanes, device, weighted), state


def run_engine(name: str, params: Optional[AuditParams] = None,
               mesh_shape: Optional[Tuple[int, int]] = None,
               device=None, capture: Optional[Dict[str, tuple]] = None,
               rounds: bool = True) -> RunEngine:
    """Run every auditable program of one engine config once (SPMD on
    every rank of the world for a sharded config; host and unified run
    on this process alone). ``capture`` maps a program to the points
    whose live buffers the memory pass keeps; ``rounds=False`` skips the
    round runs (the memory fit's extra size points)."""
    if name not in ENGINE_CONFIGS:
        raise ValueError(
            f"unknown engine config {name!r} "
            f"(expected one of {sorted(ENGINE_CONFIGS)})"
        )
    cfg = ENGINE_CONFIGS[name]
    params = params or AuditParams()
    device = _device(device)
    capture = capture or {}
    n, cap, lanes = params.n, params.capacity, params.lanes
    mesh = resolve_mesh(cfg, mesh_shape) if cfg.is_sharded else None
    if mesh is not None:
        _, _, d_e, d_v, tr, vr = _geometry(mesh)
    else:
        d_e = d_v = 1
        tr = vr = 0
    d = d_e * d_v
    _check_sizes(n, cap, d, d_v)
    local_cap = cap // d
    n_owned = n // d_v
    window = plan_window(0, lanes, local_cap)
    fcap = plan_frontier_cap(cfg.frontier_exchange, cfg.frontier_cap,
                             lanes, n_owned)
    halo = cfg.vertex_sharding in ("range", "halo")
    donated = (WEIGHTED_DONATED_STATE_ARGS if cfg.weighted
               else DONATED_STATE_ARGS)
    programs: Dict[str, ProgramRun] = {}
    donations: Dict[str, Tuple[str, ...]] = {}
    round_runs: Dict[str, Tuple[List[Traffic], List[Site]]] = {}
    overflow: Dict[str, Tuple[List[Traffic], List[Site]]] = {}
    nl = params.n_levels

    if cfg.engine == "host":
        # the seed two-call path: out-of-place table writes, nothing
        # donated (its manifest says so)
        args, _ = _program_args(n, cap, lanes, device, False)
        src, dst, valid, core, label, n_edges, iu, iv, iok = args[:9]
        programs["insert_batch"] = record_program(
            lambda *a: insert_batch(*a, n, nl),
            [src, dst, valid, core, label, iu, iv, iok, n_edges],
            dict(src=0, dst=1, valid=2, core=3, label=4, n_edges=8),
            dict(src=0, dst=1, valid=2, n_edges=3, core=4, label=5),
            capture.get("insert_batch", ()), (name, "insert_batch"))
        args, _ = _program_args(n, cap, lanes, device, False)
        slots = torch.full((lanes,), -1, dtype=torch.int32, device=device)
        programs["remove_batch"] = record_program(
            lambda *a: remove_batch(*a, n, nl),
            list(args[:5]) + [slots],
            dict(src=0, dst=1, valid=2, core=3, label=4),
            dict(valid=0, core=1, label=2),
            capture.get("remove_batch", ()), (name, "remove_batch"))
        donations = {"insert_batch": (), "remove_batch": ()}
    else:
        n_state = n_owned if halo else n
        args, state = _program_args(n_state, local_cap, lanes, device,
                                    cfg.weighted)
        if cfg.engine == "unified":
            if cfg.weighted:
                def fn(*a):
                    return apply_batch_weighted(
                        *a, n, nl, window,
                        kernel_backend=cfg.kernel_backend)
            else:
                def fn(*a):
                    return apply_batch(*a, n, nl, window,
                                       kernel_backend=cfg.kernel_backend)
        else:
            fn = make_sharded_apply(
                mesh, n, nl, axis=EDGE_AXIS, local_active=window,
                vertex_sharding=cfg.vertex_sharding, freelist=cfg.freelist,
                frontier_exchange=cfg.frontier_exchange, frontier_cap=fcap,
                kernel_backend=cfg.kernel_backend, weighted=cfg.weighted)
        programs["apply_batch"] = record_program(
            fn, args, state, dict(state),
            capture.get("apply_batch", ()),
            (name, str(mesh_shape), "apply_batch"))
        donations["apply_batch"] = donated
        if cfg.is_sharded and rounds:
            if cfg.weighted:
                round_runs["weighted_round"] = run_weighted_round(
                    n, cap, mesh, cfg.kernel_backend, device)
            else:
                rcap = fcap if cfg.frontier_exchange == "sparse" else None
                kw = dict(window=window if halo else None, lanes=lanes,
                          kernel_backend=cfg.kernel_backend, device=device)
                round_runs["removal_round"] = run_removal_round(
                    cfg.vertex_sharding, n, cap, mesh, rcap, **kw)
                round_runs["promotion_round"] = run_promotion_round(
                    cfg.vertex_sharding, n, cap, mesh, rcap, **kw)
                if rcap is not None:
                    overflow["removal_round"] = run_removal_round(
                        cfg.vertex_sharding, n, cap, mesh, rcap,
                        overflow=True, **kw)
                    overflow["promotion_round"] = run_promotion_round(
                        cfg.vertex_sharding, n, cap, mesh, rcap,
                        overflow=True, **kw)

    n_pad = n_owned * d_v if halo else n
    hcap = halo_cap_for(window, 2 * lanes, n_pad) if halo else 0
    sizes = dict(n=n, d=d, d_e=d_e, d_v=d_v, cap=fcap, n_owned=n_owned,
                 n_pad=n_pad, hcap=hcap, lanes=lanes, window=window,
                 local_cap=local_cap)
    shape = (d_e, d_v) if cfg.vertex_sharding == "halo" else None
    return RunEngine(
        config=cfg, params=params, n_devices=d, window=window,
        frontier_cap=fcap, programs=programs, donated=donations,
        rounds=round_runs, overflow=overflow, sizes=sizes,
        device=device, mesh_shape=shape)


def lattice(run: RunEngine) -> list:
    """The (window, cap) buckets the planners can reach for this run's
    config and sizes (``api.bucket_lattice``)."""
    cfg = run.config
    return bucket_lattice(run.sizes["local_cap"], run.params.lanes,
                          cfg.frontier_exchange, cfg.frontier_cap,
                          run.sizes["n_owned"])
