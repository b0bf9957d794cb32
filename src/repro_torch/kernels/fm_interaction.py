"""The DeepFM second-order interaction on a Hopper kernel, with its plain
PyTorch version and launch counter.

    out[b] = 0.5 * sum_d ((sum_f emb[b,f,d])^2 - sum_f emb[b,f,d]^2)

``fm_interaction`` replaces the reference's Pallas ``fm_interaction``
(``kernels/fm_interaction.py``): ``emb [B, F, D]`` to ``[B]`` in
``emb``'s dtype, accumulated in float32. On a CUDA tensor it launches
``fm_kernel`` of ``csrc/fm_interaction.cu`` (a persistent grid whose CTAs
bring spans of whole rows into a ring of shared-memory stages with bulk
copies and reduce one span while the next ones load; one pass over
``emb``, so it is bound by the bytes of ``emb``) or raises; it never falls
back, and it is forward-only. On a CPU tensor it runs
``fm_interaction_plain``.
"""
from __future__ import annotations

import ctypes

import torch

from . import build as B

_DTYPES = {torch.float32: 2, torch.bfloat16: 3}

_TAGS = {torch.float32: "f32", torch.bfloat16: "bf16"}

# kernel launches, counted where the kernel is launched: one entry per
# dtype instance
LAUNCHES = {f"fm_interaction[{t}]": 0 for t in _TAGS.values()}

B.register({"fm_interaction": [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_void_p]})


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def fm_interaction_plain(emb: torch.Tensor) -> torch.Tensor:
    """``fm_interaction`` in plain PyTorch: float32 sums, out in
    ``emb``'s dtype."""
    e = emb.float()
    s = e.sum(1)
    s2 = (e * e).sum(1)
    return (0.5 * (s * s - s2).sum(-1)).to(emb.dtype)


def fm_interaction(emb: torch.Tensor) -> torch.Tensor:
    """emb [B, F, D] -> [B] second-order FM logit."""
    if emb.dim() != 3:
        raise ValueError(f"emb must be [B, F, D], got {tuple(emb.shape)}")
    b, f, d = emb.shape
    if emb.device.type == "cpu":
        return fm_interaction_plain(emb)
    if emb.dtype not in _DTYPES:
        raise TypeError(f"fm_interaction: the CUDA kernel takes float32 or "
                        f"bfloat16, got {emb.dtype}")
    B.forward_only("fm_interaction", emb)
    emb = emb.contiguous()
    out = torch.empty(b, dtype=emb.dtype, device=emb.device)
    if b == 0 or f == 0 or d == 0:
        return out.zero_()
    B.launch("fm_interaction", emb.data_ptr(), out.data_ptr(), b, f, d,
             _DTYPES[emb.dtype])
    LAUNCHES[f"fm_interaction[{_TAGS[emb.dtype]}]"] += 1
    return out
