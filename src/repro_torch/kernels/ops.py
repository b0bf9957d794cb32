"""Public wrappers for the ELL, attention and FM kernels: the port of the
reference's ``kernels/ops.py``, with its names and arguments minus
``interpret``.

Each op dispatches by its tensors' device: the plain PyTorch version on
the CPU, the hand-written Hopper kernel on a CUDA device (which raises
rather than fall back). Models take a ``use_pallas_*`` config flag, as
in the reference; their default paths stay in plain PyTorch.
"""
from __future__ import annotations

from .flash_attention import flash_attention
from .fm_interaction import fm_interaction
from .segment_ell import ell_aggregate, ell_stat


def ell_stat_op(nbrs, vals, self_vals, op="count_ge"):
    return ell_stat(nbrs, vals, self_vals, op=op)


def ell_aggregate_op(nbrs, feats, op="sum"):
    return ell_aggregate(nbrs, feats, op=op)


def flash_attention_op(q, k, v, causal=True, block_q=512, block_k=512):
    return flash_attention(q, k, v, causal=causal, block_q=block_q,
                           block_k=block_k)


def fm_interaction_op(emb):
    return fm_interaction(emb)
