"""The recorder every audit rule stands on: what one run of a program
dispatches, op by op, split into fixpoint rounds.

The counterpart of the reference's ``analysis/walker.py``. The reference
walks traced jaxprs: a ``lax.while_loop`` body traces once, so the
equations inside it ARE the per-round program. The port has no traced
program; its fixpoints are Python loops whose condition is a host read
of a device verdict. So the port RUNS each program on small seeded
state under :class:`RoundRecorder`, a ``TorchDispatchMode``, and reads
the same facts off what the dispatcher sees:

* every aten / c10d op is a :class:`Site`, with the bytes of its
  outputs, where it sits (``in_round``: inside one of the fixpoint
  functions, ``ROUND_FUNCS`` — the port's ``while`` body), which
  sync-delimited segment it ran in (``round``: a new one opens at each
  host read, ``ROUND_SYNC_OPS`` or a device-to-host copy) and the
  package frame that issued it (``where``);
* collectives are the c10d ops (``COLLECTIVE_OPS``), mapped to the
  reference's primitive names; a ``recv_`` of a ``batch_isend_irecv``
  is one ``ppermute``, its ``send`` half is not counted again;
* a call of a port kernel (``kernels/*.py``, a ctypes launch the
  dispatcher never sees) is ONE launch-class site, as a
  ``pallas_call`` is one equation: read off the kernel modules'
  ``LAUNCHES`` counters between two dispatched ops;
* host syncs: ``ROUND_SYNC_OPS`` (a scalar read) and a device-to-host
  copy open a round; ops that block the host on a card without a scalar
  read are ``hidden`` syncs and open none: a boolean-mask index and
  ``nonzero`` / ``unique`` (sized on the host: counted on the host too,
  so the two devices' counts differ only by copies) and, on a card, a
  host-to-device copy, a tensor built from Python data and a host value
  written into a device tensor. Each is one ``torch.cuda`` sync-debug
  warning on the card.

Optionally the recorder tracks live storage bytes at every op
(``track_memory``: a ``weakref.finalize`` on each output's untyped
storage, deduplicated by storage; a gloo collective's work object holds
its tensors until gloo's worker thread lets go of it, at a moment the
scheduler picks, so the recorder holds them too and lets go only once
that work is gone, before the next op: :meth:`RoundRecorder._settle`)
and checks every integer narrowing for values outside int32
(``check_narrowing``; the flags stay on the device until the recorder
exits). ``profile_kernels`` runs ``torch.profiler`` around the block,
wraps each fixpoint round in a ``record_function`` range named
``audit:<function>:<round>`` and adds one
``kind="cuda"`` site a range with the CUDA kernels launched inside it
(``launches``): the card's launch count of a round, hand-written kernels
and elementwise kernels alike (``cuda_round_kernels``). The recorder
also counts the iterations of the loop functions' ``while`` loops
through the interpreter (:class:`LoopCounter`, ``iterations``), the
count the host-sync checks hold each loop-condition sync to.
"""
from __future__ import annotations

import bisect
import collections
import dataclasses
import dis
import gc
import importlib
import os
import re
import sys
import time
import weakref
from typing import Dict, List, Optional, Sequence, Set, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from ..core import vertex_layout

# c10d op -> the reference's collective primitive (``allreduce_`` by its
# reduce op: ``REDUCE_PRIMS``)
COLLECTIVE_OPS = {
    "allreduce_": "psum",
    "allreduce_coalesced_": "psum",
    "_allgather_base_": "all_gather",
    "allgather_into_tensor_coalesced_": "all_gather",
    "allgather_": "all_gather",
    "_reduce_scatter_base_": "reduce_scatter",
    "reduce_scatter_tensor_coalesced_": "reduce_scatter",
    "reduce_scatter_": "reduce_scatter",
    "recv_": "ppermute",
}
# ReduceOp codes (``ReduceOp.SUM`` / ``MIN`` / ``MAX``)
REDUCE_PRIMS = {0: "psum", 3: "pmin", 4: "pmax"}
# the sending half of a ppermute: issued, not counted as its own site
SEND_OPS = frozenset({"send"})
# point-to-point c10d ops: gloo runs them on the calling thread, and a
# ring holds their work objects across ops (``batch_isend_irecv``)
P2P_OPS = frozenset({"send", "recv_", "recv_any_source_"})
# how long :meth:`RoundRecorder._settle` waits for a worker thread
SETTLE_TIMEOUT_S = 60.0

# launch-class aten ops: the gather / scatter / sort family each runs as
# its own kernel on the card (``index`` is a gather, ``index_put_`` a
# scatter); a port kernel call is one launch-class site of its own
LAUNCH_OPS = frozenset({
    "index", "gather", "index_select", "index_put_", "index_put",
    "index_add_", "index_add", "scatter_", "scatter", "scatter_add_",
    "scatter_add", "scatter_reduce_", "scatter_reduce", "sort", "argsort",
})

# host reads of a device value: each ends a sync-delimited round
ROUND_SYNC_OPS = frozenset({"_local_scalar_dense", "item", "is_nonzero"})
# ops that block the host on a CUDA device without a scalar read
HIDDEN_SYNC_OPS = frozenset({
    "nonzero", "masked_select", "_unique2", "unique_consecutive",
    "unique_dim", "repeat_interleave",
})
_COPY_OPS = frozenset({"_to_copy", "copy_"})
_NARROW_OPS = frozenset({"_to_copy", "copy_"})

# the fixpoint functions: an op issued under one of them runs once per
# round (the port's ``while`` body)
ROUND_FUNCS = frozenset({
    "removal_fixpoint", "removal_fixpoint_halo",
    "promotion_fixpoint", "promotion_fixpoint_halo",
    "weighted_core_fixpoint_pass", "weighted_core_fixpoint_pass_halo",
})

# the CUDA runtime's launch calls as torch.profiler records them: one a
# kernel launch (aten's kernels, CUB's and the hand-written ones)
LAUNCH_EVENTS = frozenset({"cudaLaunchKernel", "cudaLaunchKernelExC",
                           "cuLaunchKernel", "cuLaunchKernelEx"})
RANGE_PREFIX = "audit:"

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_ANALYSIS = os.path.join(_PKG, "analysis")
_DIST = os.path.dirname(torch.distributed.__file__)
_BIG = 1 << 62  # core/engine.py's sentinel key


@dataclasses.dataclass(frozen=True)
class Site:
    """One dispatched op (or one port kernel call) of a recorded run."""

    op: str                 # aten / c10d packet name, or the kernel counter
    kind: str               # "op" | "collective" | "kernel"
    round: int              # sync-delimited segment (0 before the first)
    in_round: bool          # issued under a ROUND_FUNCS frame
    round_func: str         # the outermost fixpoint function, or ""
    where: str              # "core/remove.py::removal_fixpoint" (issuer)
    line: int
    out_bytes: int = 0
    out_elems: int = 0
    prim: str = ""          # collectives: the reference primitive
    branch: str = ""        # vertex_layout's arm: "" or "overflow"
    launches: int = 0       # kernels: the counter's delta
    sync: str = ""          # "round" | "hidden" | ""
    d2h_bytes: int = 0      # a device-to-host copy's payload

    @property
    def launch_class(self) -> bool:
        return self.kind == "kernel" or self.op in LAUNCH_OPS


@dataclasses.dataclass(frozen=True)
class CollectiveSite:
    """One collective with its payload, in the reference's shape
    (``walker.CollectiveSite``): ``out_bytes`` is what each rank
    receives."""

    op: str
    out_bytes: int
    out_elems: int
    in_round: bool
    branch: str


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(x) -> List[torch.Tensor]:
    return [t for t in tree_leaves(x) if isinstance(t, torch.Tensor)]


def _kernel_counters() -> List[dict]:
    """The ``LAUNCHES`` dicts of the port's kernel modules."""
    from ..kernels import coremaint, flash_attention, fm_interaction, \
        segment_ell
    return [coremaint.LAUNCHES, segment_ell.LAUNCHES,
            fm_interaction.LAUNCHES, flash_attention.LAUNCHES]


def _snapshot(counters: Sequence[dict]) -> Dict[str, int]:
    out: Dict[str, int] = {}
    for c in counters:
        out.update(c)
    return out


def _in_torch_distributed() -> bool:
    """Is the op dispatched from ``torch.distributed``'s own code (a
    collective's ``wait()`` that copies its result out), which still
    holds the work object?"""
    f = sys._getframe(2)
    while f is not None:
        fn = f.f_code.co_filename
        if fn.startswith(_DIST):
            return True
        if fn.startswith(_PKG):
            return False
        f = f.f_back
    return False


class RoundRecorder(TorchDispatchMode):
    """Record every op dispatched inside the block as a :class:`Site`.

    ``track_memory`` keeps the live storage bytes after every op
    (``point_bytes``; ``capture`` names the points whose live buffers are
    kept, as ``(uid, shape, itemsize)``); ``check_narrowing`` flags every
    integer narrowing of a value outside the narrower type
    (``narrowings`` after the block); ``profile_kernels`` counts each
    fixpoint round's CUDA kernels under ``torch.profiler`` (the card).
    ``iterations`` are the loops' iterations. Garbage collection is
    paused inside the block so live bytes are deterministic."""

    def __init__(self, track_memory=False, capture: Sequence[int] = (),
                 check_narrowing=False, profile_kernels=False):
        super().__init__()
        self.sites: List[Site] = []
        self.round = 0
        self.track_memory = track_memory
        self._capture = frozenset(int(i) for i in capture)
        self.check_narrowing = check_narrowing
        self.profile_kernels = profile_kernels
        self._prof = None
        self.kernel_names: Dict[str, collections.Counter] = {}
        self._loops = LoopCounter()
        self.point_bytes: List[int] = []
        self.point_in_round: List[bool] = []
        self.captured: Dict[int, Tuple[tuple, ...]] = {}
        self.narrowings: List[str] = []
        self._flags: List[Tuple[str, torch.Tensor]] = []
        self._live: Dict[int, tuple] = {}
        self._live_bytes = 0
        self._uid = 0
        self._counters: List[dict] = []
        self._last: Dict[str, int] = {}
        self._range = None
        self._range_key = None
        self._syncs_by_func: Dict[str, int] = {}
        self._gc = False
        # (tensors, refs the work holds to each, work objects) of the
        # collectives whose work may still be on a worker thread
        self._held: List[Tuple[list, List[int], list]] = []

    # -- context --------------------------------------------------------
    def __enter__(self):
        self._counters = _kernel_counters()
        self._last = _snapshot(self._counters)
        if self.profile_kernels:
            from torch.profiler import ProfilerActivity, profile
            self._prof = profile(activities=[ProfilerActivity.CPU,
                                             ProfilerActivity.CUDA])
            self._prof.__enter__()
        self._loops.__enter__()
        self._gc = gc.isenabled()
        gc.disable()
        return super().__enter__()

    def __exit__(self, *exc):
        if exc[0] is None:
            self._settle()
        self._held.clear()
        try:
            out = super().__exit__(*exc)
        finally:
            if self._gc:
                gc.enable()
            self._loops.__exit__(*exc)
        self._poll_kernels(None)
        self._close_range()
        if self._prof is not None:
            torch.cuda.synchronize()
            self._prof.__exit__(*exc)
            counts, self.kernel_names = profile_round_kernels(self._prof)
            self._prof = None
            for key, n in counts.items():
                func, k = key[len(RANGE_PREFIX):].rsplit(":", 1)
                self.sites.append(Site(
                    op="cuda_kernels", kind="cuda", round=int(k),
                    in_round=True, round_func=func, where=key, line=0,
                    launches=n))
        if self._flags:
            hits = torch.stack([f for _, f in self._flags]).cpu().tolist()
            self.narrowings += [m for (m, _), h in zip(self._flags, hits)
                                if h]
            self._flags = []
        return out

    @property
    def iterations(self) -> Dict[str, int]:
        """``{path::function: iterations of its loop}``."""
        return dict(self._loops.iterations)

    def track(self, *tensors: torch.Tensor) -> None:
        """Count tensors made outside the block (a program's inputs) as
        live from here on."""
        for t in tensors:
            if isinstance(t, torch.Tensor):
                self._track(t)

    # -- the stack ---------------------------------------------------------
    @staticmethod
    def _frames() -> Tuple[str, int, str]:
        """(issuer path::function, line, outermost fixpoint function)
        of the current op, from the Python stack."""
        f = sys._getframe(2)
        where, line, rfunc = "", 0, ""
        while f is not None:
            fn = f.f_code.co_filename
            if fn.startswith(_PKG) and not fn.startswith(_ANALYSIS):
                if not where:
                    rel = os.path.relpath(fn, _PKG).replace(os.sep, "/")
                    where, line = f"{rel}::{f.f_code.co_name}", f.f_lineno
                if f.f_code.co_name in ROUND_FUNCS:
                    rfunc = f.f_code.co_name
            f = f.f_back
        return where, line, rfunc

    # -- kernels -------------------------------------------------------------
    def _poll_kernels(self, ctx) -> None:
        if not self._counters:
            return
        now = _snapshot(self._counters)
        if now == self._last:
            return
        where, line, rfunc = ctx if ctx is not None else ("", 0, "")
        for k, v in now.items():
            d = v - self._last.get(k, 0)
            if d > 0:
                self.sites.append(Site(
                    op=k, kind="kernel", round=self.round,
                    in_round=bool(rfunc), round_func=rfunc, where=where,
                    line=line, launches=d))
        self._last = now

    # -- memory ----------------------------------------------------------------
    def _track(self, t: torch.Tensor) -> None:
        try:
            st = t.untyped_storage()
        except (RuntimeError, NotImplementedError):
            return
        key = st._cdata
        if key in self._live:
            return
        nb = st.nbytes()
        shape = (tuple(t.shape) if _nbytes(t) == nb
                 else (nb // max(t.element_size(), 1),))
        self._live[key] = (self._uid, shape, t.element_size(), nb)
        self._uid += 1
        self._live_bytes += nb
        weakref.finalize(st, self._free, key)

    def _free(self, key) -> None:
        rec = self._live.pop(key, None)
        if rec is not None:
            self._live_bytes -= rec[3]

    def _collective(self, func, args, kwargs):
        """Run a gloo collective and keep its tensors until
        :meth:`_settle`: each work object holds references to them, and
        gloo drops its own on its worker thread after the program's
        ``wait()`` has returned. A tensor the program drops first would
        be freed there, late by however long that thread waits for a
        CPU, and a late free moves the live bytes of the points between.
        ``held`` is how many references the finished work holds to each
        tensor (its inputs, its outputs and its future's value)."""
        ts = list({id(t): t for t in _tensors((args, kwargs))}.values())
        before = [t._use_count() for t in ts]
        out = func(*args, **kwargs)
        works = [w for w in tree_leaves(out)
                 if isinstance(w, torch.ScriptObject)]
        for w in works:
            w.wait()
        held = [t._use_count() - b for t, b in zip(ts, before)]
        self._held.append((ts, held, works))
        return out

    def _settle(self) -> None:
        """Let go of the collectives' tensors once their work objects are
        gone (the program drops its own before the next op): drop this
        recorder's reference to each work, wait until the worker thread
        has dropped its own (the tensors' use counts fall by ``held``),
        then drop the tensors. A tensor nothing else holds is freed here,
        on this thread, before the next op: where a prompt worker thread
        would have let it go."""
        while self._held:
            ts, held, works = self._held.pop(0)
            want = [t._use_count() - h for t, h in zip(ts, held)]
            works.clear()
            deadline = time.monotonic() + SETTLE_TIMEOUT_S
            pause = 1e-5
            while any(t._use_count() > w for t, w in zip(ts, want)):
                if time.monotonic() > deadline:
                    raise RuntimeError(
                        "a collective's work object outlived the next op; "
                        "the memory recorder takes synchronous collectives "
                        "only")
                time.sleep(pause)
                pause = min(2 * pause, 1e-3)
            del ts

    # -- profiler ranges -------------------------------------------------------
    def _close_range(self) -> None:
        if self._range is not None:
            torch.ops.profiler._record_function_exit._RecordFunction(
                self._range)
            self._range = None
            self._range_key = None

    def _open_range(self, rfunc: str) -> None:
        key = (rfunc, self._syncs_by_func.get(rfunc, 0)) if rfunc else None
        if key == self._range_key:
            return
        self._close_range()
        if key is not None:
            self._range = torch.ops.profiler._record_function_enter_new(
                f"{RANGE_PREFIX}{key[0]}:{key[1]}", None)
            self._range_key = key

    # -- dispatch ----------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self._held and not _in_torch_distributed():
            self._settle()
        ctx = self._frames()
        self._poll_kernels(ctx)
        if self.profile_kernels:
            self._open_range(ctx[2])
        name = func.overloadpacket.__name__
        if self.check_narrowing and name in _NARROW_OPS:
            self._narrowing(name, args, kwargs, ctx)
        if (self.track_memory and func.namespace == "c10d"
                and name not in P2P_OPS
                and all(t.device.type == "cpu"
                        for t in _tensors((args, kwargs)))):
            out = self._collective(func, args, kwargs)
        else:
            out = func(*args, **kwargs)
        self._record(func, name, args, kwargs, out, ctx)
        return out

    def _narrowing(self, name, args, kwargs, ctx) -> None:
        src = args[1] if name == "copy_" else args[0]
        if name == "copy_":
            dst_dtype = args[0].dtype
        else:
            dst_dtype = kwargs.get("dtype") or src.dtype
        if (src.dtype.is_floating_point or src.dtype == torch.bool
                or dst_dtype.is_floating_point or dst_dtype == torch.bool
                or src.is_complex()):
            return
        if torch.iinfo(dst_dtype).bits >= torch.iinfo(src.dtype).bits:
            return
        if src.numel() == 0:
            return
        lo, hi = torch.iinfo(dst_dtype).min, torch.iinfo(dst_dtype).max
        flag = ((src < lo) | (src > hi)).any()
        big = (src == _BIG).any()
        where, line, _ = ctx
        self._flags.append((
            f"{src.dtype}->{dst_dtype} {name} at {where}:{line} narrows a "
            f"value outside {dst_dtype}", flag))
        self._flags.append((
            f"{src.dtype}->{dst_dtype} {name} at {where}:{line}: the "
            "1 << 62 sentinel reaches a narrowing", big))

    def _record(self, func, name, args, kwargs, out, ctx) -> None:
        where, line, rfunc = ctx
        ns = func.namespace
        kind, prim, nbytes, nelems = "op", "", 0, 0
        sync, d2h = "", 0
        outs = _tensors(out)
        if ns == "c10d":
            if name in SEND_OPS:
                return
            prim = COLLECTIVE_OPS.get(name, "")
            if prim:
                kind = "collective"
                if name.startswith("allreduce"):
                    prim = REDUCE_PRIMS.get(int(args[2].op()), "psum")
                payload = _tensors(args[0])
                nbytes = sum(_nbytes(t) for t in payload)
                nelems = sum(t.numel() for t in payload)
        else:
            nbytes = sum(_nbytes(t) for t in outs)
            nelems = sum(t.numel() for t in outs)
        if name in ROUND_SYNC_OPS:
            sync = "round"
        elif name in _COPY_OPS:
            src = args[1] if name == "copy_" else args[0]
            dst = args[0] if name == "copy_" else (outs[0] if outs else src)
            if isinstance(src, torch.Tensor) and src.device != dst.device:
                if src.device.type != "cpu" and dst.device.type == "cpu":
                    sync, d2h = "round", _nbytes(dst)
                else:
                    sync = "hidden"
        elif name in HIDDEN_SYNC_OPS:
            sync = "hidden"  # sized on the host (on a card: a sync)
        elif name == "lift_fresh":
            if outs and outs[0].device.type != "cpu":
                sync = "hidden"  # a tensor from Python data, copied over
        elif name in ("index", "index_put_", "index_put"):
            idx = args[1] if len(args) > 1 else ()
            if any(isinstance(i, torch.Tensor) and i.dtype == torch.bool
                   for i in (idx or ())):
                sync = "hidden"  # a boolean mask: nonzero on a card
            elif (name != "index" and len(args) > 2
                    and isinstance(args[2], torch.Tensor)
                    and args[2].device.type == "cpu"
                    and args[0].device.type != "cpu"):
                sync = "hidden"  # a host value (``x[i] = True``) copied over
        if sync == "round" and rfunc and where.endswith("::" + rfunc):
            # the fixpoint's own loop condition closes one of its rounds
            self._syncs_by_func[rfunc] = \
                self._syncs_by_func.get(rfunc, 0) + 1
        self.sites.append(Site(
            op=name, kind=kind, round=self.round, in_round=bool(rfunc),
            round_func=rfunc, where=where, line=line, out_bytes=nbytes,
            out_elems=nelems, prim=prim, branch=vertex_layout._BRANCH,
            sync=sync, d2h_bytes=d2h))
        if sync == "round":
            self.round += 1
        if self.track_memory:
            for t in outs:
                self._track(t)
            idx = len(self.point_bytes)
            self.point_bytes.append(self._live_bytes)
            self.point_in_round.append(bool(rfunc))
            if idx in self._capture:
                self.captured[idx] = tuple(
                    (uid, shape, isz) for uid, shape, isz, _ in
                    sorted(self._live.values()))


# -- loop iterations -----------------------------------------------------------
# the loop functions: each holds one ``while`` loop whose condition is a
# host read (``hostlint.SYNC_SITES`` names it, per round, wave, eviction
# round or bisection step) and returns only from inside the loop
LOOP_FUNCS = (
    "core/remove.py::removal_fixpoint",
    "core/remove.py::removal_fixpoint_halo",
    "core/remove.py::weighted_core_fixpoint_pass",
    "core/remove.py::weighted_core_fixpoint_pass_halo",
    "core/remove.py::_weighted_h_index_halo",
    "core/insert.py::promotion_fixpoint",
    "core/insert.py::promotion_fixpoint_halo",
    "core/insert.py::_forward_reach",
    "core/insert.py::_forward_reach_halo",
    "core/insert.py::_evict_fixpoint",
    "core/insert.py::_evict_fixpoint_halo",
    "core/graph_ops.py::weighted_h_index",
)


def _loop_code(where: str):
    path, func = where.split("::")
    mod = importlib.import_module(
        f"{__package__.rsplit('.', 1)[0]}.{path[:-3].replace('/', '.')}")
    code = getattr(mod, func).__code__
    # a ``with`` block's exception handlers sit after the body and jump
    # back into it: only the body's back-edges are the loop's
    body_end = min((e.target for e in dis.Bytecode(code).exception_entries),
                   default=len(code.co_code))
    heads = {i.argval for i in dis.get_instructions(code)
             if i.opname.startswith("JUMP_BACKWARD") and i.offset < body_end}
    if len(heads) != 1:
        raise RuntimeError(f"{where} has {len(heads)} loop back-edge "
                           "targets; the loop counter needs exactly one")
    return code, heads.pop()


class LoopCounter:
    """Count the iterations of ``LOOP_FUNCS``' loops as the interpreter
    runs them (``sys.monitoring``, local to those functions' code): a
    call starts one (the loop is the function's body), each jump back to
    the loop head another. The count is the program's own control flow,
    independent of what the dispatcher sees, so a loop condition that
    starts to sync twice an iteration shows against it."""

    def __init__(self, funcs: Sequence[str] = LOOP_FUNCS):
        loops = {w: _loop_code(w) for w in funcs}
        self._where = {code: w for w, (code, _) in loops.items()}
        self._head = {code: head for code, head in loops.values()}
        self.iterations: Dict[str, int] = {w: 0 for w in funcs}
        self._tool: Optional[int] = None

    def __enter__(self):
        mon = sys.monitoring
        free = [i for i in range(6) if mon.get_tool(i) is None]
        if not free:
            raise RuntimeError("no free sys.monitoring tool id")
        self._tool = free[-1]
        mon.use_tool_id(self._tool, "repro_torch.analysis")
        ev = mon.events
        mon.register_callback(self._tool, ev.PY_START, self._start)
        mon.register_callback(self._tool, ev.JUMP, self._jump)
        for code in self._where:
            mon.set_local_events(self._tool, code, ev.PY_START | ev.JUMP)
        return self

    def _start(self, code, offset):
        self.iterations[self._where[code]] += 1

    def _jump(self, code, offset, dest):
        if dest == self._head[code] and dest < offset:
            self.iterations[self._where[code]] += 1

    def __exit__(self, *exc):
        mon = sys.monitoring
        for code in self._where:
            mon.set_local_events(self._tool, code, 0)
        mon.register_callback(self._tool, mon.events.PY_START, None)
        mon.register_callback(self._tool, mon.events.JUMP, None)
        mon.free_tool_id(self._tool)
        self._tool = None
        return False


# -- CUDA kernels a round (the card) ---------------------------------------
def kernel_name(name: str) -> str:
    """A CUDA kernel's function name without its namespace, template
    arguments and parameters."""
    name = name.replace("(anonymous namespace)::", "")
    name = name[5:] if name.startswith("void ") else name
    return re.split(r"[<(]", name)[0].split("::")[-1]


def profile_round_kernels(prof) -> Tuple[Dict[str, int],
                                         Dict[str, collections.Counter]]:
    """CUDA kernel launches per fixpoint round of a profiled recorder run:
    the ``audit:<function>:<round>`` ranges, each counting the runtime
    launch calls (``LAUNCH_EVENTS``) that start inside it. Returns
    ``(counts, names)``: launches a range, and a range's kernel names as
    the profiler links them to their launches (copies and memsets are
    not kernels)."""
    evs = prof.events()
    ranges: Dict[str, Tuple[int, int]] = {}
    for e in evs:
        if e.name.startswith(RANGE_PREFIX):
            lo, hi = e.time_range.start, e.time_range.end
            old = ranges.get(e.name)
            ranges[e.name] = (lo, hi) if old is None else (
                min(lo, old[0]), max(hi, old[1]))
    starts = sorted(e.time_range.start for e in evs
                    if e.name in LAUNCH_EVENTS)
    linked = sorted((e.time_range.start, kernel_name(k.name))
                    for e in evs for k in getattr(e, "kernels", ()) or ()
                    if not k.name.startswith(("Memset", "Memcpy")))
    at = [t for t, _ in linked]
    counts: Dict[str, int] = {}
    names: Dict[str, collections.Counter] = {}
    for key, (lo, hi) in ranges.items():
        counts[key] = (bisect.bisect_right(starts, hi)
                       - bisect.bisect_left(starts, lo))
        names[key] = collections.Counter(
            name for _, name in linked[bisect.bisect_left(at, lo):
                                       bisect.bisect_right(at, hi)])
    return counts, names


def cuda_round_kernels(sites: Sequence[Site]) -> Dict[str, int]:
    """``{"audit:<function>:<round>": CUDA kernels}`` of a run recorded
    with ``profile_kernels`` (empty off the card)."""
    return {s.where: s.launches for s in sites if s.kind == "cuda"}


# -- views over recorded sites --------------------------------------------
def collectives(sites: Sequence[Site]) -> List[CollectiveSite]:
    """Every collective of a run, with its payload."""
    return [CollectiveSite(s.prim, s.out_bytes, s.out_elems, s.in_round,
                           s.branch)
            for s in sites if s.kind == "collective"]


def count_collectives(sites: Sequence[Site],
                      prims: Optional[Sequence[str]] = None) -> dict:
    """Histogram of collective primitives over a run."""
    names = None if prims is None else frozenset(prims)
    hist: dict = {}
    for c in collectives(sites):
        if names is None or c.op in names:
            hist[c.op] = hist.get(c.op, 0) + 1
    return hist


def count_round_launches(sites: Sequence[Site]) -> dict:
    """Histogram of launch-class sites issued inside fixpoint rounds
    (``Site.in_round``): the aten gather / scatter / sort family, and
    each port kernel CALL as one launch under its counter name (the
    dispatched ops inside a kernel wrapper are its set-up: the output
    buffer and the views of it, never a gather or scatter)."""
    hist: dict = {}
    for s in sites:
        if s.in_round and s.launch_class:
            hist[s.op] = hist.get(s.op, 0) + 1
    return hist


def op_names(sites: Sequence[Site]) -> Set[str]:
    """Every op name of a run (the counterpart of ``primitive_names``)."""
    return {s.op for s in sites}


primitive_names = op_names


def count_syncs(sites: Sequence[Site]) -> Dict[str, Dict[str, int]]:
    """``{"round": {issuer: n}, "hidden": {issuer: n}}`` over a run."""
    out: Dict[str, Dict[str, int]] = {"round": {}, "hidden": {}}
    for s in sites:
        if not s.sync:
            continue
        d = out[s.sync]
        d[s.where] = d.get(s.where, 0) + 1
    return out


def tainted_truncations(fn, *args, **kwargs) -> List[str]:
    """Run ``fn(*args, **kwargs)`` under the recorder's narrowing check
    and return its findings: every integer narrowing of a value outside
    the narrower type (the counterpart of the reference's static taint
    walk, ``rules.tainted_truncations``)."""
    with RoundRecorder(check_narrowing=True) as rec:
        fn(*args, **kwargs)
    return rec.narrowings
