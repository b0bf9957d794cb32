"""Plain-torch oracles for the ELL, attention and FM kernels: the port of
the reference's ``kernels/ref.py``, line for line.

These are the allclose targets the reference holds its Pallas kernels
to. Each kernel module here has its own plain version beside its
wrapper, which follows the kernel (output dtypes, sentinels, the float
attention scale); these follow the reference's oracles, quirks included:
``ell_stat_ref`` sums and counts in int64 like ``jnp.sum`` under x64, and
``mha_ref`` computes its scale in q's dtype.
"""
from __future__ import annotations

import torch


def _ext_take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x_ext[idx]`` over ``x`` with a zero row appended, as JAX's
    gather does it: an index in ``[-(n + 1), 0)`` wraps once, any other
    index is clamped to ``[0, n]``."""
    n = x.shape[0]
    ext = torch.cat([x, torch.zeros((1,) + tuple(x.shape[1:]), dtype=x.dtype,
                                    device=x.device)])
    idx = idx.long()
    idx = torch.where(idx < 0, idx + n + 1, idx).clamp(0, n)
    return ext[idx]


# -- segment_ell ------------------------------------------------------------
def ell_stat_ref(nbrs, vals, self_vals, op="count_ge"):
    n = nbrs.shape[0]
    if n == 0 or nbrs.shape[1] == 0:
        return torch.zeros((n,), dtype=vals.dtype, device=vals.device)
    gathered = _ext_take(vals, nbrs)  # [n, D]
    mask = nbrs < n
    acc = torch.int64 if not vals.dtype.is_floating_point else None
    if op == "count_ge":
        return (mask & (gathered >= self_vals[:, None])).to(
            vals.dtype).sum(1, dtype=acc)
    if op == "count_gt":
        return (mask & (gathered > self_vals[:, None])).to(
            vals.dtype).sum(1, dtype=acc)
    if op == "sum":
        return torch.where(mask, gathered, torch.zeros_like(gathered)).sum(
            1, dtype=acc)
    if op == "max":
        # empty-neighborhood identity is 0 (matches the kernel's post-
        # reduce sentinel mask); rows with neighbors take the true max
        neg = torch.full_like(gathered, -(2**30))
        raw = torch.where(mask, gathered, neg).amax(1)
        return torch.where(mask.any(1), raw, torch.zeros_like(raw))
    raise ValueError(op)


def ell_aggregate_ref(nbrs, feats, op="sum"):
    n = nbrs.shape[0]
    if n == 0 or nbrs.shape[1] == 0:
        return torch.zeros((n, feats.shape[1]), dtype=feats.dtype,
                           device=feats.device)
    gathered = _ext_take(feats, nbrs)  # [n, D, F]
    mask = (nbrs < n)[..., None]
    if op == "sum":
        # jnp.sum accumulates half-width floats in float32
        return torch.where(mask, gathered, 0.0).sum(
            1, dtype=torch.float32).to(feats.dtype)
    if op == "max":
        neg = torch.full_like(gathered, -1e30)
        raw = torch.where(mask, gathered, neg).amax(1)
        return torch.where(mask.any(1), raw, torch.zeros_like(raw))
    raise ValueError(op)


# -- flash attention ----------------------------------------------------------
def mha_ref(q, k, v, causal=True, scale=None):
    """q [B,H,S,D], k/v [B,Hkv,S,D]; GQA via head broadcast."""
    b, h, s, d = q.shape
    hkv = k.shape[1]
    g = h // hkv
    if scale is None:
        scale = 1.0 / torch.sqrt(torch.tensor(float(d))).to(q.dtype)
    kk = torch.repeat_interleave(k, g, dim=1)
    vv = torch.repeat_interleave(v, g, dim=1)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), kk.float()) * scale
    if causal:
        mask = torch.tril(torch.ones((s, s), dtype=torch.bool,
                                     device=q.device))
        logits = torch.where(mask[None, None], logits, -1e30)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", probs, vv.float()).to(q.dtype)


# -- FM interaction ---------------------------------------------------------
def fm_interaction_ref(emb):
    """DeepFM 2nd-order term: emb [B, F, D] -> [B].
    0.5 * sum_d ((sum_f v)^2 - sum_f v^2)."""
    s = emb.sum(1)  # [B, D]
    s2 = (emb * emb).sum(1)  # [B, D]
    return 0.5 * (s * s - s2).sum(-1)
