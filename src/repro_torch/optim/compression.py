"""Gradient compression for cross-node links: int8 quantization with
error feedback (EF-SGD style), the reference's ``optim/compression.py``.

The reference sums the int8 payload with ``psum`` over a mesh axis; here
the sums are ``torch.distributed`` all-reduces over a process group
(``group=None``: the default group). The payload travels as int32, as
the reference sums it; the per-tensor scales are averaged.
"""
from __future__ import annotations

from typing import Dict, Mapping, Tuple

import torch
import torch.distributed as dist

Tensor = torch.Tensor


def compress_int8(g: Tensor) -> Tuple[Tensor, Tensor]:
    """Per-tensor symmetric int8 quantization. Returns (q, scale)."""
    g32 = g.float()
    scale = torch.max(torch.abs(g32)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress_int8(q: Tensor, scale: Tensor) -> Tensor:
    return q.float() * scale


def error_feedback_allreduce(grads: Mapping[str, Tensor],
                             residuals: Mapping[str, Tensor], group=None
                             ) -> Tuple[Dict[str, Tensor], Dict[str, Tensor]]:
    """Quantize (grad + residual), sum the int8 payload over ``group``,
    keep the quantization error as the next residual. Every rank of the
    group calls it with the same names in the same order.

    Returns (averaged_grads, new_residuals), name -> tensor."""
    world = dist.get_world_size(group)
    avg, new_res = {}, {}
    for name, g in grads.items():
        g32 = g.float() + residuals[name]
        q, scale = compress_int8(g32)
        new_res[name] = g32 - decompress_int8(q, scale)
        # int8 payload summed on the wire; scales are f32 scalars
        summed = q.to(torch.int32)
        dist.all_reduce(summed, group=group)
        scale_sum = scale.clone()
        dist.all_reduce(scale_sum, group=group)
        scale_sum = scale_sum / world
        avg[name] = (summed.float() * scale_sum / world).to(g.dtype)
    return avg, new_res
