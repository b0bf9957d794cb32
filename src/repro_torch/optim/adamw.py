"""AdamW with float32 moments over (possibly bf16) parameters: the
reference's ``optim/adamw.py`` as plain functions over a mapping of name
to tensor (``optim.params.named``).

The reference's arithmetic, kept: float32 ``m`` / ``v`` and an int32
``count``; ``b2 = 0.95``; ``sqrt(v / c2) + eps``; ``p32 - lr * (step +
wd * p32)`` cast back to the parameter's dtype, with no float32 master
copy; weight decay on every leaf, norms and biases included. The clip
computes the global norm in float32 and returns each gradient in its
own dtype. ``adamw_update`` writes the parameters and moments in place
under ``torch.no_grad()`` (the reference donates them: ``donate_argnums=
(0, 1)``), so a step never holds two copies of the weights.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

from ..parallel.sharding import is_dtensor
from .params import ParamDict, named, tensors_from_reference

Tensor = torch.Tensor


def f32_zeros(t: Tensor) -> Tensor:
    """Float32 zeros shaped and placed like ``t`` (a DTensor's placements
    kept)."""
    if is_dtensor(t):
        return torch.zeros_like(t, dtype=torch.float32)
    return torch.zeros(t.shape, dtype=torch.float32, device=t.device)


def adamw_init(params) -> Dict[str, Any]:
    """``{"m", "v"}``: float32 zeros named like ``params`` (``ParamDict``s;
    a DTensor parameter's moments placed as it is), ``"count"``: a 0-d
    int32 zero, on the parameters' device."""
    p = named(params)
    dev = next(iter(p.values())).device if p else torch.device("cpu")
    return {"m": p.like(f32_zeros), "v": p.like(f32_zeros),
            "count": torch.zeros((), dtype=torch.int32, device=dev)}


def adamw_state_from_reference(state: Mapping[str, Any],
                               params) -> Dict[str, Any]:
    """The reference's optimizer state ``{"m", "v", "count"}`` (pytrees
    of arrays numpy can read) as the port's, laid out like ``params``."""
    f32 = torch.float32
    p = named(params)
    dev = next(iter(p.values())).device
    return {"m": tensors_from_reference(state["m"], p, f32),
            "v": tensors_from_reference(state["v"], p, f32),
            "count": torch.tensor(int(np.asarray(state["count"])),
                                  dtype=torch.int32, device=dev)}


def clip_by_global_norm(grads: Mapping[str, Tensor], max_norm: float
                        ) -> Tuple[Dict[str, Tensor], Tensor]:
    """``(clipped, norm)``: the global norm of ``grads`` in float32 (the
    leaves summed in the mapping's order) and each gradient scaled by
    ``min(1, max_norm / (norm + 1e-9))`` in float32, returned in its own
    dtype."""
    gn = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                        for g in grads.values()))
    scale = torch.clamp(max_norm / (gn + 1e-9), max=1.0)
    out = {k: (g.float() * scale).to(g.dtype) for k, g in grads.items()}
    if isinstance(grads, ParamDict):
        out = ParamDict(out, grads.paths)
    return out, gn


@torch.no_grad()
def adamw_update(params, grads: Mapping[str, Tensor], state: Dict[str, Any],
                 lr, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1):
    """One AdamW step, in place: ``params``' tensors and ``state``'s
    ``m`` / ``v`` are overwritten and ``state["count"]`` replaced by
    ``count + 1``. ``lr`` is a float or a 0-d float32 tensor. Returns
    ``(params, state)``, the objects passed in."""
    count = state["count"] + 1
    c1 = 1.0 - b1 ** count.float()
    c2 = 1.0 - b2 ** count.float()
    p_named = named(params)
    for name, p in p_named.items():
        g32 = grads[name].float()
        m, v = state["m"][name], state["v"][name]
        m.mul_(b1).add_((1 - b1) * g32)
        v.mul_(b2).add_((1 - b2) * g32 * g32)
        del g32
        step = (m / c1).div_(torch.sqrt(v / c2).add_(eps))
        p32 = p.float()
        p.copy_(p32 - lr * step.add_(weight_decay * p32))
    state["count"] = count
    return params, state
