"""Hand-written Hopper kernels for label placement's level reductions:
``core/order.py`` ``place_block`` on a CUDA tensor.

``place_levels(core, label, moving, rank, at_head, n_levels)`` gives every
moving vertex its new label at the head (``at_head``) or the tail of its
level's block, from its rank in the (level, round_key, label) order of
the movers, and every other vertex its own label: the part of
``place_block`` after its sort. Its plain version is ``core/order.py``
``place_levels_plain``, the same steps of the plain path that
``place_block`` takes on any other device (the reference's
``segment_min`` / ``segment_max`` and segment sum, bit for bit); no TPU
kernel is replaced.

On a CUDA tensor it launches ``csrc/order.cu``'s three kernels (the level
table's init, the level pass with per-block tables in shared memory, the
assignment pass; see the source for the design and its bound) or raises;
it never falls back. ``LAUNCHES`` counts the launches (three a call) and
``VERTICES`` the vertices they covered. A vertex whose level does not fit
the shared table (``shared_levels``) takes the spill path; the kernel
tallies those on the device, once a block, and ``spill_count`` reads the
tally (a sync: never on the batch path).
"""
from __future__ import annotations

import ctypes

import torch

from . import build as B

LAUNCHES = {"place_levels": 0}
VERTICES = {"place_levels": 0}

_P, _I64 = ctypes.c_void_p, ctypes.c_longlong
B.register({
    "order_place": [_P] * 8 + [_I64, _I64, ctypes.c_int, _P],
})


def reset_launches() -> None:
    for d in (LAUNCHES, VERTICES):
        for k in d:
            d[k] = 0


def _entry(name: str, restype, argtypes):
    fn = getattr(B.library(), name)
    fn.restype, fn.argtypes = restype, argtypes
    return fn


def shared_levels(n_levels: int) -> int:
    """The levels the level pass keeps in shared memory for ``n_levels``
    on the current CUDA device: a vertex whose level is this or more takes
    the spill path."""
    got = _entry("order_shared_levels", _I64, [_I64])(n_levels)
    if got < 0:
        raise RuntimeError(f"order_shared_levels failed: CUDA error {-got}")
    return got


def spill_count() -> int:
    """Vertices that took the spill path since ``reset_spill_count``
    (reads the device-side tally: synchronous)."""
    out = ctypes.c_longlong()
    rc = _entry("order_spill_read", ctypes.c_int,
                [ctypes.POINTER(ctypes.c_longlong)])(ctypes.byref(out))
    if rc != 0:
        raise RuntimeError(f"order_spill_read failed: CUDA error {rc}")
    return out.value


def reset_spill_count() -> None:
    rc = _entry("order_spill_reset", ctypes.c_int, [])()
    if rc != 0:
        raise RuntimeError(f"order_spill_reset failed: CUDA error {rc}")


def place_levels(core: torch.Tensor, label: torch.Tensor,
                 moving: torch.Tensor, rank: torch.Tensor, at_head: bool,
                 n_levels: int) -> torch.Tensor:
    """New labels ``[n]`` int64 from int32 ``core`` (the new levels), int64
    ``label``, bool ``moving`` and int32 ``rank`` (each vertex's position
    in the order of (level, round_key, label), every non-mover's level
    read as ``n_levels``), all ``[n]`` CUDA tensors.

    The level table is three scratch buffers: min and max label ``[n_levels]``
    int64 and the mover counts, turned into first ranks in place,
    ``[n_levels + 3]`` int32 (the last two: the highest mover level and the
    level pass's finished blocks)."""
    n = core.shape[0]
    for name, x, dt in (("core", core, torch.int32),
                        ("label", label, torch.int64),
                        ("moving", moving, torch.bool),
                        ("rank", rank, torch.int32)):
        if x.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {x.dtype}")
        if x.shape != (n,):
            raise ValueError(f"{name} has shape {tuple(x.shape)}, "
                             f"expected ({n},)")
        if x.device.type != "cuda" or x.device != core.device:
            raise ValueError("place_levels takes CUDA tensors on one device")
        if not x.is_contiguous():
            raise ValueError("the CUDA kernels take contiguous tensors")
    if not 1 <= n_levels < 2**31 - 3:
        raise ValueError(f"n_levels must lie in [1, 2**31 - 3), got {n_levels}")
    if n == 0:
        return label.clone()
    dev = core.device
    lo = torch.empty(n_levels, dtype=torch.int64, device=dev)
    hi = torch.empty(n_levels, dtype=torch.int64, device=dev)
    cnt = torch.empty(n_levels + 3, dtype=torch.int32, device=dev)
    out = torch.empty_like(label)
    B.launch("order_place", core.data_ptr(), label.data_ptr(),
             moving.data_ptr(), rank.data_ptr(), lo.data_ptr(), hi.data_ptr(),
             cnt.data_ptr(), out.data_ptr(), n, n_levels, int(at_head))
    LAUNCHES["place_levels"] += 3
    VERTICES["place_levels"] += n
    return out
