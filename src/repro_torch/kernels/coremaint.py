"""Hand-written Hopper kernels for the core-maintenance round statistics,
their plain PyTorch versions, and the loader of the CUDA library.

Each wrapper here replaces one Pallas TPU kernel of the reference
(``src/repro/kernels/coremaint.py``):

* ``coo_stat``              <- ``coo_stat`` (``_stat_kernel``): packed
  per-vertex ``[n, C]`` int32 sums of per-edge indicator columns over a
  COO slot window, for the unit stats ``mcd_hi_dout`` (C=3),
  ``hi_dout`` (2), ``mcd`` (1), ``din`` (1, aux = ``rp``) and
  ``same_in`` (1, aux = candidate mask);
* ``fused_removal_round``   <- ``fused_removal_round``: the
  ``mcd_hi_dout`` stats, then ``drop = (mcd < core) & (core > 0)`` and
  ``new_core = core - drop``;
* ``fused_promotion_stats`` <- ``fused_promotion_stats``: the
  ``hi_dout`` stats and ``viol = hi + dout_same > core``;
* ``coo_stat(stat="wsum")`` <- ``coo_stat(stat="wsum")``
  (``_wsum_kernel``): per vertex, the sum of the int32 slot weights
  ``edge_w`` to neighbours whose core clears the vertex's int32
  threshold ``aux`` — the weighted h-index bisection's inner pass.

On a CUDA tensor a wrapper launches its kernel from
``csrc/coremaint.cu`` (edge-parallel, one thread per slot, int32
``atomicAdd`` into the packed output; integer sums make any order
bit-exact) or raises; it never falls back. On a CPU tensor it runs the
plain version beside it (``*_plain``), which repeats the same predicates
with ``index_add_`` pairs. The TPU kernels fold the per-vertex decision
into the last edge block of an in-order grid; Hopper's blocks finish in
any order, so the two fused wrappers launch a second tiny per-vertex
kernel after the edge pass, and count both launches.

What bounds them on an H100: the bytes of the window (src, dst, valid:
about 9 B a slot; wsum adds the 4 B weight), the vertex state read once
and the output written once. On power-law (RMAT) graphs the random endpoint gathers and the
atomic contention at hub vertices are the likely limit.

The library is built with ``nvcc`` from the package's own source on
first use, into ``build/repro_torch/`` at the checkout root (or
``$REPRO_TORCH_BUILD_DIR``), and loaded with ``ctypes``. A missing
``nvcc``, a failed build or a failed launch raises ``RuntimeError``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

import torch

# stat name -> (kernel enum in csrc/coremaint.cu, packed output columns)
_STATS = {
    "mcd_hi_dout": (0, 3),
    "hi_dout": (1, 2),
    "mcd": (2, 1),
    "din": (3, 1),
    "same_in": (4, 1),
}
# the stats whose predicates read the k-order label; the others take
# ``label=None``
_LABEL_STATS = ("mcd_hi_dout", "hi_dout", "din")

# kernel launches, counted where each kernel is launched: one entry per
# coo_stat stat (each is its own instance of the templated kernel) and
# one per fused wrapper, which launches two kernels per call
LAUNCHES = {**{f"coo_stat[{s}]": 0 for s in (*_STATS, "wsum")},
            "fused_removal_round": 0, "fused_promotion_stats": 0}

_SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "coremaint.cu"
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC"]
_lib: Optional[ctypes.CDLL] = None


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH or $CUDA_HOME/bin): the CUDA kernels of "
        "repro_torch build from source on first use"
    )


def build(verbose: bool = False) -> Path:
    """Compile ``csrc/coremaint.cu`` into a shared library named by the
    hash of its source and flags (a rebuilt source never loads a stale
    library). Returns the library's path; builds only when missing."""
    text = _SOURCE.read_bytes()
    tag = hashlib.sha256(text + " ".join(_NVCC_FLAGS).encode()).hexdigest()
    out_dir = build_dir()
    out = out_dir / f"libcoremaint_{tag[:16]}.so"
    if out.exists():
        return out
    out_dir.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    cmd = [_nvcc(), *_NVCC_FLAGS, "-o", tmp, str(_SOURCE)]
    if verbose:
        cmd.insert(1, "-Xptxas=-v")
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}"
        )
    if verbose:
        print(proc.stdout + proc.stderr, flush=True)
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half
    return out


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        p, i64 = ctypes.c_void_p, ctypes.c_longlong
        lib.coremaint_stat.argtypes = [p, p, p, p, p, p, p, i64, i64,
                                       ctypes.c_int, p]
        lib.coremaint_removal_decide.argtypes = [p, p, p, p, i64, p]
        lib.coremaint_promotion_decide.argtypes = [p, p, p, i64, p]
        lib.coremaint_wsum.argtypes = [p, p, p, p, p, p, p, i64, i64, p]
        for fn in (lib.coremaint_stat, lib.coremaint_removal_decide,
                   lib.coremaint_promotion_decide, lib.coremaint_wsum):
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {rc}")


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _u8(mask: torch.Tensor) -> torch.Tensor:
    """A boolean mask as the kernel's byte array (no copy for bool)."""
    if mask.dtype != torch.bool:
        mask = mask != 0
    return mask.view(torch.uint8)


def _check_inputs(src, dst, valid, core, label, n, aux=None,
                  needs_label=True):
    if label is None:
        if needs_label:
            raise TypeError("label must be int64 (k-order labels), got None")
    elif label.dtype != torch.int64:
        raise TypeError(
            f"label must be int64 (k-order labels), got {label.dtype}"
        )
    if src.dtype != torch.int32 or dst.dtype != torch.int32:
        raise TypeError(
            f"src/dst must be int32, got {src.dtype}/{dst.dtype}"
        )
    if core.dtype != torch.int32:
        raise TypeError(f"core must be int32, got {core.dtype}")
    e = src.shape[0]
    if dst.shape[0] != e or valid.shape[0] != e:
        raise ValueError("src, dst and valid must have one length")
    for name, x in (("core", core), ("label", label), ("aux", aux)):
        if x is not None and x.shape[0] != n:
            raise ValueError(f"{name} has {x.shape[0]} rows, expected {n}")
    dev = src.device
    for x in (dst, valid, core, label, aux):
        if x is not None and x.device != dev:
            raise ValueError("all inputs must be on one device")
    if dev.type == "cuda":
        for x in (src, dst, valid, core, label, aux):
            if x is not None and not x.is_contiguous():
                raise ValueError("the CUDA kernels take contiguous tensors")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")


# ---------------------------------------------------------------------------
# plain versions (the CPU path and the card's yardstick)
# ---------------------------------------------------------------------------
def _take0(x: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    """``jnp.take(x, idx, fill_value=0)``: an index in ``[-n, 0)`` wraps
    once, any other index outside ``[0, n)`` reads 0."""
    idx = torch.where(idx < 0, idx + n, idx)
    ok = (idx >= 0) & (idx < n)
    got = x[torch.where(ok, idx, torch.zeros_like(idx))]
    return torch.where(ok, got, torch.zeros_like(got))


def _edge_columns(stat, valid, cs, cd, ls, ld, auxs, auxd):
    """Per-edge indicator columns (to_src, to_dst) of one packed stat —
    the same predicates as the reference kernel's ``_edge_columns``."""
    same = valid & (cs == cd)
    if stat == "mcd_hi_dout":
        to_src = (valid & (cd >= cs), valid & (cd > cs), same & (ld > ls))
        to_dst = (valid & (cs >= cd), valid & (cs > cd), same & (ls > ld))
    elif stat == "hi_dout":
        to_src = (valid & (cd > cs), same & (ld > ls))
        to_dst = (valid & (cs > cd), same & (ls > ld))
    elif stat == "mcd":
        to_src = (valid & (cd >= cs),)
        to_dst = (valid & (cs >= cd),)
    elif stat == "din":
        to_src = (same & (ld < ls) & auxd,)
        to_dst = (same & (ls < ld) & auxs,)
    else:  # same_in
        to_src = (same & auxd,)
        to_dst = (same & auxs,)
    pack = lambda cols: torch.stack(  # noqa: E731
        [c.to(torch.int32) for c in cols], dim=-1)
    return pack(to_src), pack(to_dst)


def coo_stat_plain(src, dst, valid, core, label, n, stat="mcd_hi_dout",
                   aux=None):
    """``coo_stat`` in plain PyTorch: gather, indicator columns, and an
    ``index_add_`` pair that drops endpoints outside ``[0, n)``."""
    ncols = _STATS[stat][1]
    out = torch.zeros((n, ncols), dtype=torch.int32, device=src.device)
    if src.shape[0] == 0 or n == 0:
        return out
    src = src.long()
    dst = dst.long()
    cs, cd = _take0(core, src, n), _take0(core, dst, n)
    ls = ld = None
    if label is not None:
        ls, ld = _take0(label, src, n), _take0(label, dst, n)
    if aux is None:
        auxs = auxd = torch.zeros_like(valid, dtype=torch.bool)
    else:
        auxs, auxd = _take0(aux, src, n) != 0, _take0(aux, dst, n) != 0
    to_src, to_dst = _edge_columns(stat, valid != 0, cs, cd, ls, ld,
                                   auxs, auxd)
    for idx, cols in ((src, to_src), (dst, to_dst)):
        ok = (idx >= 0) & (idx < n)
        out.index_add_(0, torch.where(ok, idx, torch.zeros_like(idx)),
                       cols * ok.to(torch.int32)[:, None])
    return out


def wsum_plain(src, dst, valid, edge_w, core, thresh, n):
    """``coo_stat(stat="wsum")`` in plain PyTorch: ``[n, 1]`` int32
    sums of the slot weight where the other endpoint's core clears the
    endpoint's threshold; endpoints outside ``[0, n)`` as in
    ``coo_stat_plain``."""
    out = torch.zeros((n, 1), dtype=torch.int32, device=src.device)
    if src.shape[0] == 0 or n == 0:
        return out
    src = src.long()
    dst = dst.long()
    valid = valid != 0
    wi = edge_w.to(torch.int32)
    thresh = thresh.to(torch.int32)
    cs, cd = _take0(core, src, n), _take0(core, dst, n)
    ts, td = _take0(thresh, src, n), _take0(thresh, dst, n)
    zero = torch.zeros_like(wi)
    for idx, col in ((src, torch.where(valid & (cd >= ts), wi, zero)),
                     (dst, torch.where(valid & (cs >= td), wi, zero))):
        ok = (idx >= 0) & (idx < n)
        out.index_add_(0, torch.where(ok, idx, torch.zeros_like(idx)),
                       torch.where(ok, col, zero)[:, None])
    return out


def fused_removal_round_plain(src, dst, valid, core, label, n):
    stats = coo_stat_plain(src, dst, valid, core, label, n, "mcd_hi_dout")
    drop = (stats[:, 0] < core) & (core > 0)
    return (stats[:, 0], stats[:, 1], stats[:, 2],
            core - drop.to(core.dtype), drop)


def fused_promotion_stats_plain(src, dst, valid, core, label, n):
    stats = coo_stat_plain(src, dst, valid, core, label, n, "hi_dout")
    viol = (stats[:, 0] + stats[:, 1]) > core
    return stats[:, 0], stats[:, 1], viol


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------
def _launch_stat(src, dst, valid, core, label, n, stat, aux):
    code, ncols = _STATS[stat]
    out = torch.zeros((n, ncols), dtype=torch.int32, device=src.device)
    # the byte views stay referenced until the launch is queued: a
    # converted temporary freed earlier could hand its block to the next
    valid8 = _u8(valid)
    aux8 = _u8(aux) if aux is not None else None
    rc = _library().coremaint_stat(
        src.data_ptr(), dst.data_ptr(), valid8.data_ptr(), core.data_ptr(),
        label.data_ptr() if label is not None else None,
        aux8.data_ptr() if aux8 is not None else None, out.data_ptr(),
        src.shape[0], n, code, _stream(),
    )
    _check(rc, f"coremaint_stat[{stat}]")
    return out


def _wsum(src, dst, valid, core, label, n, aux, edge_w):
    """``coo_stat(stat="wsum")``; as in the reference, an empty window
    or ``n == 0`` gives zeros before the inputs are required."""
    _check_inputs(src, dst, valid, core, label, n, aux, needs_label=False)
    if src.shape[0] == 0 or n == 0:
        return torch.zeros((n, 1), dtype=torch.int32, device=src.device)
    if edge_w is None or aux is None:
        raise ValueError(
            "stat='wsum' needs edge_w (per-slot weights) and aux "
            "(per-vertex integer thresholds)"
        )
    if edge_w.shape[0] != src.shape[0]:
        raise ValueError("edge_w must have the window's length")
    if edge_w.device != src.device:
        raise ValueError("all inputs must be on one device")
    if src.device.type == "cpu":
        return wsum_plain(src, dst, valid, edge_w, core, aux, n)
    if not edge_w.is_contiguous():
        raise ValueError("the CUDA kernels take contiguous tensors")
    out = torch.zeros((n, 1), dtype=torch.int32, device=src.device)
    # the converted copies stay referenced until the launch is queued
    valid8 = _u8(valid)
    w32 = edge_w.to(torch.int32)
    thresh = aux.to(torch.int32)
    rc = _library().coremaint_wsum(
        src.data_ptr(), dst.data_ptr(), valid8.data_ptr(), w32.data_ptr(),
        core.data_ptr(), thresh.data_ptr(), out.data_ptr(), src.shape[0], n,
        _stream(),
    )
    _check(rc, "coremaint_wsum")
    LAUNCHES["coo_stat[wsum]"] += 1
    return out


def coo_stat(src: torch.Tensor, dst: torch.Tensor, valid: torch.Tensor,
             core: torch.Tensor, label: Optional[torch.Tensor], n: int,
             stat: str = "mcd_hi_dout",
             aux: Optional[torch.Tensor] = None,
             edge_w: Optional[torch.Tensor] = None) -> torch.Tensor:
    """LOCAL packed per-vertex statistics over a COO edge-slot window:
    ``[n, C]`` int32. ``aux`` is the per-vertex mask of "din" (``rp``)
    and "same_in" (the candidate mask), or the per-vertex integer
    thresholds of "wsum"; the other stats ignore it. ``edge_w`` is the
    per-slot weight column, read by "wsum" alone. ``label`` may be None
    for "mcd", "same_in" and "wsum", which never read it.

    Replaces the reference's Pallas ``coo_stat`` (``_stat_kernel``, and
    ``_wsum_kernel`` for "wsum"); on the card one edge-parallel launch
    of ``stat_kernel`` (``wsum_kernel``), bounded by the window's bytes
    plus the endpoint gathers and hub atomics."""
    if stat == "wsum":
        return _wsum(src, dst, valid, core, label, n, aux, edge_w)
    ncols = _STATS[stat][1]  # KeyError on an unknown stat
    _check_inputs(src, dst, valid, core, label, n, aux,
                  needs_label=stat in _LABEL_STATS)
    if src.shape[0] == 0 or n == 0:
        return torch.zeros((n, ncols), dtype=torch.int32, device=src.device)
    if src.device.type == "cpu":
        return coo_stat_plain(src, dst, valid, core, label, n, stat, aux)
    if stat in ("din", "same_in") and aux is None:
        aux = torch.zeros(n, dtype=torch.bool, device=src.device)
    out = _launch_stat(src, dst, valid, core, label, n, stat, aux)
    LAUNCHES[f"coo_stat[{stat}]"] += 1
    return out


def fused_removal_round(src: torch.Tensor, dst: torch.Tensor,
                        valid: torch.Tensor, core: torch.Tensor,
                        label: torch.Tensor, n: int):
    """One removal round — stats, drop decision, core commit. Returns
    ``(mcd, hi, dout_same, new_core, drop)`` with ``drop`` bool [n].
    Valid only where statistics complete locally (one device).

    Replaces the reference's Pallas ``fused_removal_round``; on the
    card two launches on one stream: the ``mcd_hi_dout`` edge pass, then
    ``removal_decide_kernel`` over the n vertices."""
    _check_inputs(src, dst, valid, core, label, n)
    if src.shape[0] == 0 or n == 0:
        z = torch.zeros(n, dtype=torch.int32, device=src.device)
        return z, z, z, core, torch.zeros(n, dtype=torch.bool,
                                          device=src.device)
    if src.device.type == "cpu":
        return fused_removal_round_plain(src, dst, valid, core, label, n)
    stats = _launch_stat(src, dst, valid, core, label, n, "mcd_hi_dout",
                         None)
    new_core = torch.empty_like(core)
    drop = torch.empty(n, dtype=torch.bool, device=src.device)
    rc = _library().coremaint_removal_decide(
        stats.data_ptr(), core.data_ptr(), new_core.data_ptr(),
        drop.data_ptr(), n, _stream(),
    )
    _check(rc, "coremaint_removal_decide")
    LAUNCHES["fused_removal_round"] += 2
    return stats[:, 0], stats[:, 1], stats[:, 2], new_core, drop


def fused_promotion_stats(src: torch.Tensor, dst: torch.Tensor,
                          valid: torch.Tensor, core: torch.Tensor,
                          label: torch.Tensor, n: int):
    """Promotion-round terminating statistics — ``(hi, dout_same)`` and
    the certificate-violator mask ``viol`` (bool [n]). Valid only where
    statistics complete locally (one device).

    Replaces the reference's Pallas ``fused_promotion_stats``; on the
    card two launches on one stream: the ``hi_dout`` edge pass, then
    ``promotion_decide_kernel`` over the n vertices."""
    _check_inputs(src, dst, valid, core, label, n)
    if src.shape[0] == 0 or n == 0:
        z = torch.zeros(n, dtype=torch.int32, device=src.device)
        return z, z, torch.zeros(n, dtype=torch.bool, device=src.device)
    if src.device.type == "cpu":
        return fused_promotion_stats_plain(src, dst, valid, core, label, n)
    stats = _launch_stat(src, dst, valid, core, label, n, "hi_dout", None)
    viol = torch.empty(n, dtype=torch.bool, device=src.device)
    rc = _library().coremaint_promotion_decide(
        stats.data_ptr(), core.data_ptr(), viol.data_ptr(), n, _stream(),
    )
    _check(rc, "coremaint_promotion_decide")
    LAUNCHES["fused_promotion_stats"] += 2
    return stats[:, 0], stats[:, 1], viol
