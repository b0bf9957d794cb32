"""Blockwise (flash) attention forward on a Hopper kernel, with its plain
PyTorch version and launch counter.

``flash_attention`` replaces the reference's Pallas ``flash_attention``
(``kernels/flash_attention.py``): q ``[B, H, Sq, D]``, k and v
``[B, Hkv, Sk, D]`` with ``H % Hkv == 0``, the kv head of q head ``h``
being ``h // (H // Hkv)``; causal masking is top-left aligned (query
``i`` sees key ``j`` when ``i >= j``, also when ``Sq != Sk``); the scale
defaults to the float ``1 / sqrt(D)`` and, of any sign, multiplies the
scores before the mask and the max; the sums run in float32 and the
output is in q's dtype. It accepts exactly the calls the reference
accepts: ``block_q`` and ``block_k`` (clipped to the sequence lengths)
must divide them, else ``ValueError``; the CUDA kernel picks its own
tile.

On a CUDA tensor it launches a kernel of ``csrc/flash_attention.cu`` or
raises; it never falls back, and it is forward-only. bfloat16 runs
``flash_wgmma_kernel``: the tensor cores (``wgmma``) fed by TMA through a
two-stage K/V ring, one producer and two consumer warpgroups per 128
queries, P rounded to bfloat16 for the P V product (the one difference
from the plain version). float32 runs ``flash_ffma_kernel``: register
micro-tiles of S and O on the CUDA cores, full float32 (no TF32). Both
need ``sm_90a``; the bfloat16 kernel's TMA maps are built on the host with
the CUDA driver's ``cuTensorMapEncodeTiled``, reached through the runtime. The
bound is the tensor cores' 989 TFLOP/s (bfloat16) or the CUDA cores' 67
TFLOP/s (float32) at prefill lengths; the measured times are in PERF.md.
On a CPU tensor it runs ``flash_attention_plain``, which follows the
kernel's arithmetic (not ``ref.mha_ref``, whose scale is rounded to q's
dtype).
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import build as B

_DTYPES = {torch.float32: 2, torch.bfloat16: 3}
HEAD_DIMS = (64, 128)
NEG_INF = -1e30

_TAGS = {torch.float32: "f32", torch.bfloat16: "bf16"}


def launch_key(causal: bool, dtype: torch.dtype, d: int) -> str:
    """The ``LAUNCHES`` entry of one kernel instance (a dtype and a head
    dimension) under one mask."""
    return (f"flash_attention[{'causal' if causal else 'full'},"
            f"{_TAGS[dtype]},d{d}]")


# kernel launches, counted where the kernel is launched: one entry per
# instance and mask
LAUNCHES = {launch_key(c, t, d): 0 for c in (True, False) for t in _TAGS
            for d in HEAD_DIMS}

_P, _I64, _INT = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
B.register({"flash_attention": [_P] * 4 + [_INT, _INT, _INT, _I64, _I64,
                                           _INT, ctypes.c_float, _INT,
                                           _INT, _P]})


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check_shapes(q, k, v, block_q: int, block_k: int):
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(
            f"q must be [B, H, Sq, D] and k, v [B, Hkv, Sk, D], got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, h, sq, d = q.shape
    bk, hkv, sk, dk = k.shape
    if bk != b or dk != d:
        raise ValueError("q, k and v must share B and D")
    if hkv == 0 or h % hkv != 0:
        raise ValueError(f"H={h} is not a multiple of Hkv={hkv}")
    block_q = min(block_q, sq)
    block_k = min(block_k, sk)
    if block_q <= 0 or block_k <= 0 or sq % block_q or sk % block_k:
        raise ValueError("sequence lengths must divide into blocks: "
                         f"{(sq, block_q, sk, block_k)}")
    for x in (k, v):
        if x.device != q.device:
            raise ValueError("q, k and v must be on one device")
    return b, h, hkv, sq, sk, d


def flash_attention_plain(q, k, v, causal: bool = True,
                          scale: Optional[float] = None) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch: ``q * scale`` in
    float32, scores against the kv head in place (a broadcast, no
    repeat), the -1e30 mask, ``exp(s - max)``, ``acc / max(l, 1e-30)``;
    the ``[Sq, Sk]`` scores are materialised."""
    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    g = h // hkv
    scale = scale if scale is not None else float(1.0 / (d ** 0.5))
    qf = (q.float() * scale).reshape(b, hkv, g, sq, d)
    s = torch.matmul(qf, k.float()[:, :, None].transpose(-1, -2))
    if causal:
        q_pos = torch.arange(sq, device=q.device)[:, None]
        k_pos = torch.arange(sk, device=q.device)[None, :]
        s = torch.where(q_pos >= k_pos, s, NEG_INF)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    acc = torch.matmul(p, v.float()[:, :, None])
    out = acc / p.sum(-1, keepdim=True).clamp_min(1e-30)
    return out.reshape(b, h, sq, d).to(q.dtype)


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """``x`` (contiguous), copied when a view's offset leaves its data
    off a 16-byte boundary."""
    return x if x.data_ptr() % 16 == 0 else x.clone()


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, scale: Optional[float] = None,
                    block_q: int = 512, block_k: int = 512) -> torch.Tensor:
    """q [B, H, Sq, D]; k, v [B, Hkv, Sk, D] with H % Hkv == 0."""
    b, h, hkv, sq, sk, d = _check_shapes(q, k, v, block_q, block_k)
    scale = scale if scale is not None else float(1.0 / math.sqrt(d))
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal, scale)
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: the CUDA kernel takes float32 or "
                        f"bfloat16 q, k and v of one dtype, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: the CUDA kernel takes D in "
                         f"{HEAD_DIMS}, got {d}")
    B.forward_only("flash_attention", q, k, v)
    # TMA and cp.async read 16-byte aligned rows
    q, k, v = (_aligned(x.contiguous()) for x in (q, k, v))
    out = torch.empty_like(q)
    if b == 0 or h == 0:
        return out
    B.launch("flash_attention", q.data_ptr(), k.data_ptr(), v.data_ptr(),
             out.data_ptr(), b, h, hkv, sq, sk, d, scale, int(bool(causal)),
             _DTYPES[q.dtype])
    LAUNCHES[launch_key(causal, q.dtype, d)] += 1
    return out
