"""Per-vertex reductions over an ELL neighbour matrix, on a Hopper kernel,
with their plain PyTorch versions and launch counters.

Each wrapper replaces one Pallas TPU kernel of the reference's
``kernels/segment_ell.py``:

* ``ell_stat``      <- ``ell_stat``: per vertex, ``count_ge`` /
  ``count_gt`` / ``sum`` / ``max`` of its neighbours' ``vals`` against its
  own ``self_vals``, in ``vals``' dtype;
* ``ell_aggregate`` <- ``ell_aggregate``: per vertex, the ``sum`` or
  ``max`` of its neighbours' feature rows ``feats [n, F]``.

``nbrs [n, D]`` holds each vertex's neighbour ids, padded with ``n``. As
in the reference, an id below ``n`` is a neighbour (a negative one
included: it wraps once over the ``n + 1`` values with a zero row
appended, so ``-1`` reads 0; an id still out of range reads 0), a row with
no neighbour gives 0 for every op, ``max`` folds its sentinel
(``-(2**30)``, ``-1e30``) in wherever the row holds a pad entry, and
``n == 0`` or ``D == 0`` gives zeros. Counts and integer sums wrap to
``vals``' dtype, as the Pallas kernel's cast back does.

On a CUDA tensor a wrapper launches its kernel from
``csrc/segment_ell.cu`` (``ell_stat``: a tile of 256 rows staged in
shared memory, one thread folding each row in column order;
``ell_aggregate``: a warp a row; see the source for what bounds each) or
raises; it never falls back. The
kernels are forward-only. On a CPU tensor it runs the plain version
beside it (``*_plain``).
"""
from __future__ import annotations

import ctypes

import torch

from . import build as B

_OPS = ("count_ge", "count_gt", "count_eq_gt_label", "sum", "max")
_STAT_CODES = {"count_ge": 0, "count_gt": 1, "sum": 2, "max": 3}
_AGG_CODES = {"sum": 2, "max": 3}
_DTYPES = {torch.int32: 0, torch.int64: 1, torch.float32: 2,
           torch.bfloat16: 3}
_STAT_DTYPES = (torch.int32, torch.int64, torch.float32)
_AGG_DTYPES = (torch.float32, torch.bfloat16)
STAT_SENTINEL = -(2**30)
AGG_SENTINEL = -1e30

_TAGS = {torch.int32: "i32", torch.int64: "i64", torch.float32: "f32",
         torch.bfloat16: "bf16"}

# kernel launches, counted where each kernel is launched: one entry per
# instance of the templated kernels, an op and a value dtype each
LAUNCHES = {**{f"ell_stat[{op},{_TAGS[t]}]": 0 for op in _STAT_CODES
               for t in _STAT_DTYPES},
            **{f"ell_aggregate[{op},{_TAGS[t]}]": 0 for op in _AGG_CODES
               for t in _AGG_DTYPES}}

_P, _I64, _INT = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
B.register({
    "ell_stat": [_P] * 4 + [_I64, _I64, _INT, _INT, _P],
    "ell_aggregate": [_P] * 3 + [_I64, _I64, _I64, _INT, _INT, _P],
})


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check_nbrs(nbrs: torch.Tensor, *others) -> None:
    if nbrs.dim() != 2:
        raise ValueError(f"nbrs must be [n, max_deg], got {tuple(nbrs.shape)}")
    for x in others:
        if x.device != nbrs.device:
            raise ValueError("all inputs must be on one device")
        if x.shape[0] != nbrs.shape[0]:
            raise ValueError(
                f"per-vertex input has {x.shape[0]} rows, expected "
                f"{nbrs.shape[0]}")


def _cuda_ready(what: str, nbrs, dtypes, *vals) -> None:
    """What the CUDA kernels take: int32 ids, one value dtype from
    ``dtypes``, contiguous tensors, no autograd."""
    if nbrs.dtype != torch.int32:
        raise TypeError(f"{what}: the CUDA kernel takes int32 nbrs, got "
                        f"{nbrs.dtype}")
    for x in vals:
        if x.dtype not in dtypes or x.dtype != vals[0].dtype:
            raise TypeError(f"{what}: the CUDA kernel takes one of {dtypes} "
                            f"for every value input, got {x.dtype}")
    for x in (nbrs, *vals):
        if not x.is_contiguous():
            raise ValueError("the CUDA kernels take contiguous tensors")
    B.forward_only(what, *vals)


# ---------------------------------------------------------------------------
# plain versions (the CPU path and the card's yardstick)
# ---------------------------------------------------------------------------
def _column(x: torch.Tensor, ids: torch.Tensor):
    """One column of ids: ``(is_neighbour, is_pad, gathered values)``,
    the gather as ``jnp.take`` over ``x`` with a zero row appended."""
    n = x.shape[0]
    ids = ids.long()
    r = torch.where(ids < 0, ids + n + 1, ids)
    inb = (r >= 0) & (r < n)
    got = x[torch.where(inb, r, torch.zeros_like(r))]
    keep = inb.view((-1,) + (1,) * (x.dim() - 1))
    return ids < n, ids >= n, torch.where(keep, got, torch.zeros_like(got))


def _fold_max(acc, seen, nb, x):
    """Running max over the neighbours only (``torch.maximum`` carries
    NaN through, as ``jnp.max`` does); ``seen`` marks rows that have
    one."""
    acc = torch.where(nb & seen, torch.maximum(acc, x), torch.where(
        nb, x, acc))
    return acc, seen | nb


def _finish_max(acc, seen, any_pad, sentinel):
    """The sentinel joins a row that holds a pad entry; a row with no
    neighbour gives 0."""
    sent = torch.full_like(acc, sentinel)
    acc = torch.where(any_pad, torch.maximum(acc, sent), acc)
    return torch.where(seen, acc, torch.zeros_like(acc))


def ell_stat_plain(nbrs, vals, self_vals, op="count_ge"):
    """``ell_stat`` in plain PyTorch, one column of ``nbrs`` at a time
    (no ``[n, D]`` gather is kept); integer sums in int64, cast back."""
    n, d = nbrs.shape
    dt = vals.dtype
    if n == 0 or d == 0:
        return torch.zeros((n,), dtype=dt, device=vals.device)
    acc_dt = dt if (dt.is_floating_point or op == "max") else torch.int64
    acc = torch.zeros(n, dtype=acc_dt, device=vals.device)
    seen = torch.zeros(n, dtype=torch.bool, device=vals.device)
    any_pad = torch.zeros_like(seen)
    for j in range(d):
        nb, pad, x = _column(vals, nbrs[:, j])
        any_pad |= pad
        if op == "count_ge":
            acc += (nb & (x >= self_vals)).to(acc_dt)
        elif op == "count_gt":
            acc += (nb & (x > self_vals)).to(acc_dt)
        elif op == "sum":
            acc += torch.where(nb, x, torch.zeros_like(x)).to(acc_dt)
        else:
            acc, seen = _fold_max(acc, seen, nb, x)
    if op == "max":
        return _finish_max(acc, seen, any_pad, STAT_SENTINEL)
    return acc.to(dt)


def ell_aggregate_plain(nbrs, feats, op="sum"):
    """``ell_aggregate`` in plain PyTorch with an ``[n, F]`` accumulator,
    one column of ``nbrs`` at a time (the ``[n, D, F]`` gather is never
    built); ``sum`` accumulates in float32 and rounds once."""
    n, d = nbrs.shape
    f = feats.shape[1]
    if n == 0 or d == 0:
        return torch.zeros((n, f), dtype=feats.dtype, device=feats.device)
    acc = torch.zeros((n, f), dtype=torch.float32, device=feats.device)
    seen = torch.zeros((n, 1), dtype=torch.bool, device=feats.device)
    any_pad = torch.zeros_like(seen)
    for j in range(d):
        nb, pad, x = _column(feats, nbrs[:, j])
        nb, x = nb[:, None], x.float()
        any_pad |= pad[:, None]
        if op == "sum":
            acc += torch.where(nb, x, torch.zeros_like(x))
        else:
            acc, seen = _fold_max(acc, seen, nb, x)
    if op == "max":
        # the sentinel in feats' dtype, as jnp.where casts it
        sent = torch.tensor(AGG_SENTINEL, dtype=feats.dtype).item()
        acc = _finish_max(acc, seen, any_pad, sent)
    return acc.to(feats.dtype)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------
def ell_stat(nbrs: torch.Tensor, vals: torch.Tensor,
             self_vals: torch.Tensor, op: str = "count_ge") -> torch.Tensor:
    """Per-vertex neighbour statistic ``[n]`` in ``vals``' dtype.

    nbrs:      [n, max_deg] int32, pad entries = n
    vals:      [n] per-vertex value
    self_vals: [n] the per-vertex comparison value (usually == vals)
    op:        count_ge (mcd) | count_gt (hi) | sum | max

    Replaces the reference's Pallas ``ell_stat``; on the card one launch
    of ``ell_stat_kernel`` (int32, int64 or float32 values)."""
    if op not in _OPS:
        raise ValueError(f"op {op} not in {_OPS}")
    _check_nbrs(nbrs, vals, self_vals)
    n, d = nbrs.shape
    if n == 0 or d == 0:
        return torch.zeros((n,), dtype=vals.dtype, device=vals.device)
    if op not in _STAT_CODES:
        # listed by the reference, implemented by neither its kernel nor
        # its oracle
        raise ValueError(op)
    if nbrs.device.type == "cpu":
        return ell_stat_plain(nbrs, vals, self_vals, op)
    _cuda_ready("ell_stat", nbrs, _STAT_DTYPES, vals, self_vals)
    out = torch.empty(n, dtype=vals.dtype, device=vals.device)
    B.launch("ell_stat", nbrs.data_ptr(), vals.data_ptr(),
             self_vals.data_ptr(), out.data_ptr(), n, d, _STAT_CODES[op],
             _DTYPES[vals.dtype])
    LAUNCHES[f"ell_stat[{op},{_TAGS[vals.dtype]}]"] += 1
    return out


def ell_aggregate(nbrs: torch.Tensor, feats: torch.Tensor,
                  op: str = "sum") -> torch.Tensor:
    """GNN neighbour aggregation over an ELL layout.

    nbrs:  [n, max_deg] int32 (pad = n)
    feats: [n, F] float
    Returns [n, F] aggregated features (sum or max) in ``feats``' dtype.

    Replaces the reference's Pallas ``ell_aggregate``; on the card one
    launch of ``ell_aggregate_kernel`` (float32 or bfloat16 features)."""
    _check_nbrs(nbrs, feats)
    n, d = nbrs.shape
    f = feats.shape[1]
    if n == 0 or d == 0:
        return torch.zeros((n, f), dtype=feats.dtype, device=feats.device)
    if op not in _AGG_CODES:
        raise ValueError(op)
    if nbrs.device.type == "cpu":
        return ell_aggregate_plain(nbrs, feats, op)
    _cuda_ready("ell_aggregate", nbrs, _AGG_DTYPES, feats)
    out = torch.empty((n, f), dtype=feats.dtype, device=feats.device)
    B.launch("ell_aggregate", nbrs.data_ptr(), feats.data_ptr(),
             out.data_ptr(), n, d, f, _AGG_CODES[op], _DTYPES[feats.dtype])
    LAUNCHES[f"ell_aggregate[{op},{_TAGS[feats.dtype]}]"] += 1
    return out
