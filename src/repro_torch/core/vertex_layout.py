"""Vertex-state layout — who holds each per-vertex statistic — and the
collectives of the sharded engine.

The port of the reference's ``core/vertex_layout.py`` for the
replicated layout. Every maintenance round is "edge pass -> per-vertex
decision -> commit": the edge pass produces PARTIAL per-vertex
statistics (each rank scatters only its own slots of the table), and
the layout completes them:

* ``ReplicatedVertices`` — every rank keeps the full ``[n]`` vertex
  state, and a partial statistic completes with one ``all_reduce(SUM)``
  over the mesh's ``"data"`` group (``axis``); ``axis=None`` is the
  single-device identity.

The reference runs one program over a ``jax.sharding.Mesh``; the port
is SPMD: every rank runs the same Python, and ``axis`` is a
``torch.distributed`` process group. The reference's collectives map
one to one: ``psum`` -> ``all_reduce(SUM)``, ``pmax`` ->
``all_reduce(MAX)``, ``all_gather`` -> ``all_gather`` (stacked to
``[world, ...]``), ``axis_index`` -> the rank in the group. Masks and
flags travel as int32 or uint8: gloo and NCCL do not both reduce
``bool``. The range and halo layouts (``HaloShardedVertices``) are
ROADMAP Queue 1 B items 2-4.

Traffic accounting
------------------
``record_traffic()`` records one ``Traffic(op, recv_bytes)`` per
collective issued inside it, with the payload each rank RECEIVES. The
reference records at trace time, once per traced loop body (so its log
of a fixpoint is the per-round budget); the port records at call time,
once per collective actually issued. The layout's completions are
``"psum"`` as in the reference; the table collectives of the batch
program, which the reference does not record, are ``"psum_table"``
(found flags and counts), ``"pmax_scalar"`` (the high-water mark) and
``"gather_freelist"`` (the free-list ranking's gather).
"""
from __future__ import annotations

import dataclasses
from contextlib import contextmanager
from typing import Any, Iterator, List, Optional

import torch
import torch.distributed as dist


@dataclasses.dataclass
class Traffic:
    """One collective issued by the sharded engine (call-time record)."""

    op: str          # "psum" | "psum_table" | "pmax_scalar" | ...
    recv_bytes: int  # payload each participating rank receives


_LOG: Optional[List[Traffic]] = None


@contextmanager
def record_traffic() -> Iterator[List[Traffic]]:
    """Capture the collectives issued inside the block. One session at a
    time: a nested entry raises ``RuntimeError`` and leaves the active
    session's log intact."""
    global _LOG
    if _LOG is not None:
        raise RuntimeError(
            "record_traffic() does not nest: the inner context would "
            "steal the active one's records"
        )
    _LOG = log = []
    try:
        yield log
    finally:
        _LOG = None


def _note(op: str, recv_bytes: int) -> None:
    if _LOG is not None:
        _LOG.append(Traffic(op, int(recv_bytes)))


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


# -- the collectives (axis: a process group) ---------------------------------
def axis_index(axis) -> int:
    """This rank's coordinate on the mesh axis."""
    return dist.get_rank(axis)


def axis_size(axis) -> int:
    return dist.get_world_size(axis)


def psum(x: torch.Tensor, axis, op: str = "psum") -> torch.Tensor:
    """``all_reduce(SUM)`` of an integer tensor over ``axis``, IN PLACE
    (pass a tensor nothing else holds); identity when ``axis`` is None.
    A bool tensor is summed as int32 (a new tensor)."""
    if axis is None:
        return x
    if x.dtype == torch.bool:
        x = x.to(torch.int32)
    x = x.contiguous()
    _note(op, _nbytes(x))
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=axis)
    return x


def pmax(x: torch.Tensor, axis, op: str = "pmax_scalar") -> torch.Tensor:
    """``all_reduce(MAX)`` over ``axis``, in place; identity off a mesh."""
    if axis is None:
        return x
    x = x.contiguous()
    _note(op, _nbytes(x))
    dist.all_reduce(x, op=dist.ReduceOp.MAX, group=axis)
    return x


def all_gather(x: torch.Tensor, axis, op: str) -> torch.Tensor:
    """``[world, *x.shape]``: every rank's ``x`` in rank order. A bool
    tensor travels as uint8 (the reference's bool bytes) and comes back
    bool."""
    is_bool = x.dtype == torch.bool
    y = (x.to(torch.uint8) if is_bool else x).contiguous()
    parts = [torch.empty_like(y) for _ in range(axis_size(axis))]
    _note(op, len(parts) * _nbytes(y))
    dist.all_gather(parts, y, group=axis)
    out = torch.stack(parts)
    return out.bool() if is_bool else out


@dataclasses.dataclass(frozen=True)
class ReplicatedVertices:
    """Full ``[n]`` vertex state on every rank; statistics complete by
    ``all_reduce(SUM)`` over ``axis`` (identity when ``axis`` is None)."""

    n: int
    axis: Any = None  # a torch.distributed process group, or None
    device: torch.device | str = "cpu"

    def complete(self, stats: torch.Tensor) -> torch.Tensor:
        """Partial per-vertex stats -> completed stats, full ``[n, ...]``
        (in place over a mesh axis)."""
        return psum(stats, self.axis, "psum")

    def own(self, full: torch.Tensor) -> torch.Tensor:
        return full

    def gather_mask(self, owned_mask: torch.Tensor) -> torch.Tensor:
        return owned_mask

    def any_owned(self, owned_mask: torch.Tensor) -> torch.Tensor:
        """Local: a mask computed from completed statistics and the
        replicated state is the same on every rank."""
        return torch.any(owned_mask)

    def frontier_peak(self, full_mask: torch.Tensor) -> torch.Tensor:
        """Frontier size of one exchanged mask: with replicated state,
        the popcount (int32 device scalar). Local, no collective."""
        return torch.sum(full_mask, dtype=torch.int32)

    def zeros(self, dtype=torch.int32) -> torch.Tensor:
        return torch.zeros(self.n, dtype=dtype, device=self.device)

    def add_at(self, owned: torch.Tensor, idx: torch.Tensor,
               vals: torch.Tensor) -> torch.Tensor:
        """``owned.at[idx].add(vals)``: a new tensor, duplicates summed."""
        return owned.index_add(0, idx.long(), vals.to(owned.dtype))


VertexLayout = ReplicatedVertices


def make_layout(kind: str, n: int, axis,
                device: torch.device | str = "cpu") -> VertexLayout:
    """Factory keyed by the public ``vertex_sharding`` name; a
    misconfiguration raises here, at construction."""
    if kind == "replicated":
        return ReplicatedVertices(n, axis, device)
    if kind in ("range", "halo"):
        raise NotImplementedError(
            f"vertex layout {kind!r} is ROADMAP Queue 1 B item "
            f"{2 if kind == 'range' else 4} (the port has the replicated "
            "layout)"
        )
    raise ValueError(f"unknown vertex layout {kind!r}")
