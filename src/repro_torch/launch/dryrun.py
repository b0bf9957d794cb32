"""Pod dry-run: run every (arch x shape) cell's step once on the production
meshes over a fake world of 256 or 512 ranks, with meta-tensor shards,
and collect per-device FLOPs, collective bytes, memory and roofline
terms.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-34b \
      --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out results.json
  PYTHONPATH=src python -m repro_torch.launch.dryrun --both-meshes \
      --cells qwen2-7b:train_4k,pna:full_graph_sm

The port of the reference's ``launch/dryrun.py``, re-expressed. The
reference lowers and compiles each cell on 512 virtual TPU devices and
reads the compiled HLO text. The port has no compiler: this process
initializes a ``"fake"`` process group of the mesh's size (no peer, no
communication, rank 0's view), builds the mesh (``launch.mesh.
make_production_mesh``), places the cell's inputs by its ``in_specs``
as meta DTensors (``parallel.sharding.place``: each rank's shard, no
storage), runs the cell's function once, and redistributes its outputs
to ``out_specs``. A ``TorchDispatchMode`` (``Recorder``) sees every op
below DTensor: each ``_c10d_functional`` collective's kind, result
bytes and group (``collective_bytes`` applies the reference's ring
model), the matmul FLOPs of the local shapes (``dot_flops``: torch's
``flop_counter`` figure, 2 M N K a matmul) and the bytes every local op
reads and writes (a fusion-blind upper bound, the counterpart of XLA's
"bytes accessed").

The port unrolls its layers in Python, so every layer is counted: the
reference's per-layer probe (which corrects XLA's count of a rolled
scan body) has no counterpart and ``--unroll`` changes nothing. Cells
run the plain backend (``kernel_backend="torch"``): meta tensors launch
no kernel. The fake world is this process's own; the dry-run never
touches a real one (the tests and the smoke run it in a child process).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
import traceback
from typing import Any, Dict, List

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from ..configs import arch_names, get_arch
from .mesh import HW, make_production_mesh
from .steps import build_cell, cell_names

KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute")

# _c10d_functional ops -> the reference's collective kind
_KIND = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-permute",
    "broadcast_": "collective-permute",
}

# the functional-collective namespaces' ops that move no data
_NOT_COLLECTIVES = ("wait_tensor", "_wrap_tensor_autograd")


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(v) for v in x)
    return 0


def _group_ranks(name: str) -> List[int]:
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group

    return dist.get_process_group_ranks(_resolve_process_group(name))


class Recorder(TorchDispatchMode):
    """A ``TorchDispatchMode`` recording, for the ops below DTensor, the
    collectives (``records``: kind, result bytes, group size, whether
    the group lies in one node of ``HW["ranks_per_node"]``), the matmul
    FLOPs (``dot_flops``) and the bytes the local ops read and write
    (``bytes_accessed``). Ops on DTensors are left to DTensor (the mode
    returns ``NotImplemented``), which runs them as local ops and
    collectives that come back through the mode; the ops DTensor runs
    on fake global-shape tensors to propagate shapes are not counted."""

    def __init__(self):
        super().__init__()
        self.records: List[Dict[str, Any]] = []
        self.dot_flops = 0.0
        self.bytes_accessed = 0.0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **kwargs)
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if any(issubclass(t, FakeTensor) for t in types):
            return out  # DTensor's shape propagation on global shapes
        ns = func.namespace
        packet = func._overloadpacket
        if ns.startswith("_c10d_functional") or ns == "c10d":
            if packet.__name__ not in _NOT_COLLECTIVES:
                self._collective(packet.__name__, args, kwargs, out)
            return out
        if packet in flop_registry:
            self.dot_flops += float(
                flop_registry[packet](*args, **kwargs, out_val=out))
        self.bytes_accessed += _nbytes(list(args)) + _nbytes(out)
        return out

    def _collective(self, name, args, kwargs, out):
        kind = _KIND.get(name)
        if kind is None:
            raise ValueError(f"dry-run: no ring model for the collective "
                             f"{name}")
        group = next(a for a in reversed(list(args) + list(kwargs.values()))
                     if isinstance(a, str))
        ranks = _group_ranks(group)
        per_node = HW["ranks_per_node"]
        self.records.append({
            "kind": kind, "bytes": _nbytes(out), "group_size": len(ranks),
            "intra_node": len({r // per_node for r in ranks}) == 1,
        })


def collective_bytes(records) -> dict:
    """Per-device WIRE bytes of every collective, ring-algorithm model:

      all-gather        result * (p-1)/p
      reduce-scatter    result * (p-1)        (result is the shard)
      all-reduce        2 * result * (p-1)/p  (RS + AG phases)
      all-to-all        result * (p-1)/p
      collective-permute result

    ``records``: ``{"kind", "bytes" (the result's), "group_size"}`` each
    (``Recorder.records``); the reference parses the same from HLO op
    lines. Keys: the five kinds and ``op_counts``."""
    out = {k: 0.0 for k in KINDS}
    counts = {k: 0 for k in out}
    for rec in records:
        kind, total, p = rec["kind"], rec["bytes"], rec["group_size"]
        out[kind] += _wire(kind, total, p)
        counts[kind] += 1
    out["op_counts"] = counts
    return out


def _wire(kind: str, total: float, p: int) -> float:
    if kind == "all-reduce":
        return 2.0 * total * (p - 1) / p
    if kind == "reduce-scatter":
        return 1.0 * total * (p - 1)
    if kind == "collective-permute":
        return float(total)
    return 1.0 * total * (p - 1) / p  # all-gather, all-to-all


def collective_seconds(records) -> float:
    """The collective term: each record's wire bytes over NVLink 4
    (``ici_bw_per_link * ici_links``) when its group lies in one node,
    else over the card's InfiniBand port (``ib_bw_per_gpu``)."""
    nvlink = HW["ici_bw_per_link"] * HW["ici_links"]
    return sum(_wire(r["kind"], r["bytes"], r["group_size"])
               / (nvlink if r["intra_node"] else HW["ib_bw_per_gpu"])
               for r in records)


def model_flops(arch: str, shape: str) -> float:
    """Analytic MODEL_FLOPS: 6*N*D train (N_active for MoE), 2*N*D for
    prefill, 2*N_active per decoded token + attention KV term."""
    mod = get_arch(arch)
    cell = next(c for c in mod.SHAPES if c.name == shape)
    if mod.FAMILY == "lm":
        cfg = mod.full()
        n_act = cfg.n_active_params
        if cell.kind == "train":
            d = cell.params["batch"] * cell.params["seq"]
            return 6.0 * n_act * d
        if cell.kind == "prefill":
            d = cell.params["batch"] * cell.params["seq"]
            return 2.0 * n_act * d
        # decode: matmul flops + attention against the cache
        b, t = cell.params["batch"], cell.params["cache"]
        if cfg.attention == "mla":
            m = cfg.mla
            attn = 2.0 * b * t * cfg.n_heads * (
                m.kv_lora + m.rope_head_dim + m.kv_lora
            )
        else:
            attn = 4.0 * b * t * cfg.n_heads * cfg.d_head
        return 2.0 * n_act * b + attn * cfg.n_layers
    if mod.FAMILY == "recsys":
        cfg = mod.full()
        b = cell.params.get("batch", 1)
        d_in = cfg.n_sparse * cfg.embed_dim
        dims = (d_in,) + tuple(cfg.mlp_dims) + (1,)
        mlp = sum(2 * a * c for a, c in zip(dims[:-1], dims[1:]))
        per_ex = mlp + 4 * cfg.n_sparse * cfg.embed_dim
        mult = 3.0 if cell.kind == "train" else 1.0
        if cell.kind == "retrieval":
            return 2.0 * cell.params["n_candidates"] * cfg.embed_dim
        return mult * per_ex * b
    return 0.0  # GNN: reported from the run only (no closed form)


def _tensors(x):
    """Every tensor in ``x``: a module's parameters, a mapping's values, a
    sequence's items, a dataclass's fields (``GraphBatch``)."""
    from torch import nn

    if isinstance(x, nn.Module):
        yield from x.parameters()
    elif isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)
    elif dataclasses.is_dataclass(x):
        for f in dataclasses.fields(x):
            yield from _tensors(getattr(x, f.name))


def _local_bytes(x) -> int:
    """Bytes of the local shards of every tensor in ``x``."""
    return sum(_nbytes(t.to_local() if isinstance(t, DTensor) else t)
               for t in _tensors(x))


def _mem_tracker(inputs):
    """A ``MemTracker`` holding every tensor of ``inputs`` (the modules'
    parameters, the optimizer state, the batch) from the start."""
    from torch.distributed._tools.mem_tracker import MemTracker

    mt = MemTracker()
    mt.track_external(*_tensors(inputs))
    return mt


def _to_specs(x, spec):
    """Outputs redistributed to their ``out_specs`` (the reference's
    ``out_shardings``); a module's parameters are placed already."""
    from torch import nn

    from ..parallel.sharding import is_dtensor, is_spec, redistribute

    if spec is None or isinstance(x, nn.Module):
        return x
    if is_dtensor(x) and is_spec(spec):
        return redistribute(x, spec)
    if isinstance(x, dict) and isinstance(spec, dict):
        return {k: _to_specs(v, spec[k]) if k in spec else v
                for k, v in x.items()}
    if isinstance(x, (list, tuple)) and isinstance(spec, (list, tuple)):
        return type(x)(_to_specs(v, s) for v, s in zip(x, spec))
    return x


def init_fake_world(world_size: int) -> None:
    """This process's fake world of ``world_size`` ranks (rank 0), any
    earlier one destroyed first."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def run_cell(arch: str, shape: str, multi_pod: bool, verbose: bool = True,
             smoke: bool = False, mesh=None):
    """One cell on the production mesh of ``multi_pod`` (or on ``mesh``,
    a ``DeviceMesh`` of the current world; ``smoke`` takes the reduced
    config and shapes, unpinned, as the reference's small dry-run
    does). Returns the reference's result keys.

    ``lower_s`` is the time to place the inputs, ``compile_s`` the time
    of the run. ``flops`` and ``dot_flops`` are both the per-device
    matmul FLOPs (the port has no compiler's elementwise count);
    ``bytes_accessed`` is the fusion-blind sum of every local op's
    inputs and outputs. ``mem``: ``argument_bytes`` / ``output_bytes``
    are the local shards' bytes of the placed inputs and of the
    outputs; ``peak_bytes`` is torch's ``MemTracker`` peak over the run
    (the meta shards' sizes: the inputs, then every tensor the step
    allocates on a rank), ``temp_bytes`` that peak less the inputs; both
    ``None`` where ``MemTracker`` refuses the cell (a module called on
    tensors that need no gradient: DeepFM's serving cells).
    Every layer runs, so the reference's ``probe_layers`` / ``unroll``
    correction has nothing to correct."""
    from ..parallel.sharding import place

    if mesh is None:
        mesh = make_production_mesh(multi_pod=multi_pod)
    prog = build_cell(arch, shape, smoke=smoke, multi_pod=multi_pod,
                      device="cpu")
    t0 = time.time()
    inputs = place(tuple(prog.abstract_inputs), prog.in_specs, mesh)
    t_lower = time.time() - t0
    arg_bytes = _local_bytes(inputs)
    rec, mem = Recorder(), _mem_tracker(inputs)
    t0 = time.time()
    try:
        with mem, rec:
            out = _to_specs(prog.fn(*inputs), prog.out_specs)
        peak = sum(v["Total"]
                   for v in mem.get_tracker_snapshot("peak").values())
    except RuntimeError as e:
        # MemTracker's module hooks refuse a module called on tensors
        # that need no gradient (DeepFM's serving cells): run untracked
        if "register a hook" not in str(e):
            raise
        rec, peak = Recorder(), None
        t0 = time.time()
        with rec:
            out = _to_specs(prog.fn(*inputs), prog.out_specs)
    t_compile = time.time() - t0
    coll = collective_bytes(rec.records)
    n_dev = mesh.size()
    shape_str = "x".join(str(d) for d in mesh.shape)
    result = {
        "arch": arch,
        "shape": shape,
        "mesh": shape_str,
        "n_devices": int(n_dev),
        "lower_s": round(t_lower, 1),
        "compile_s": round(t_compile, 1),
        "flops": rec.dot_flops,
        "dot_flops": rec.dot_flops,
        "bytes_accessed": rec.bytes_accessed,
        "collective_bytes": coll,
        "mem": {
            "argument_bytes": arg_bytes,
            "output_bytes": _local_bytes(out),
            "temp_bytes": None if peak is None else peak - arg_bytes,
            "peak_bytes": peak,
        },
    }
    mem_floor = (result["mem"]["argument_bytes"]
                 + result["mem"]["output_bytes"])
    result["roofline"] = {
        "t_compute_s": result["dot_flops"] / HW["peak_flops_bf16"],
        "t_memory_s": mem_floor / HW["hbm_bw"],
        "t_collective_s": collective_seconds(rec.records),
        "t_memory_xla_upper_s": result["bytes_accessed"] / HW["hbm_bw"],
    }
    terms = {k: v for k, v in result["roofline"].items()
             if k in ("t_compute_s", "t_memory_s", "t_collective_s")}
    result["roofline"]["dominant"] = max(terms, key=terms.get)
    mf = 0.0 if smoke else model_flops(arch, shape)
    result["model_flops_global"] = mf
    dot_global = result["dot_flops"] * n_dev
    result["model_vs_hlo"] = (mf / dot_global) if dot_global else None
    if verbose:
        print(f"== {arch} x {shape} on {result['mesh']} "
              f"({n_dev} devices) ==")
        print(f"   place {t_lower:.1f}s  run {t_compile:.1f}s")
        print(f"   mem: {result['mem']}")
        print(f"   dot_flops={result['dot_flops']:.3e} "
              f"bytes={result['bytes_accessed']:.3e}")
        print(f"   model_flops={mf:.3e} useful-ratio={result['model_vs_hlo']}")
        print(f"   collectives: {coll}")
        print(f"   roofline: {terms}")
        sys.stdout.flush()
    return result


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--include-coremaint", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--unroll", action="store_true",
                    help="accepted for the reference's CLI: the port "
                    "counts every layer")
    ap.add_argument("--cells", default=None,
                    help="comma-separated arch:shape cells (instead of "
                    "--arch / --shape / --all)")
    args = ap.parse_args(argv)

    cells = []
    if args.cells:
        cells = [tuple(c.split(":")) for c in args.cells.split(",")]
    elif args.all:
        for a in arch_names(include_coremaint=args.include_coremaint):
            for s in cell_names(a):
                cells.append((a, s))
    else:
        archs = [args.arch] if args.arch else arch_names()
        for a in archs:
            shapes = [args.shape] if args.shape else cell_names(a)
            for s in shapes:
                cells.append((a, s))

    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    results, failures = [], []
    for mp in meshes:  # one fake world a mesh size
        init_fake_world(512 if mp else 256)
        for a, s in cells:
            try:
                results.append(run_cell(a, s, multi_pod=mp))
            except Exception as e:  # noqa: BLE001
                traceback.print_exc()
                failures.append((a, s, mp, repr(e)))
    import torch.distributed as dist
    dist.destroy_process_group()
    print(f"\n{len(results)} cells ran OK, {len(failures)} failed")
    for f in failures:
        print("FAILED:", f)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(results, fh, indent=1)
        print(f"wrote {args.out}")
    sys.exit(1 if failures else 0)


if __name__ == "__main__":
    main()
