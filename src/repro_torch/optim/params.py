"""Parameters as a mapping of name to tensor, and each name's path in the
reference's parameter pytree.

The port's optimizer and checkpoints work over ``named(params)``: an
``nn.Module``'s ``named_parameters()`` or a mapping of name to tensor
(the reference's toy tests train a dict). ``ParamDict`` is that mapping
with, for each name, the key the reference's ``train/checkpoint.py``
writes for the same leaf (``"/".join(str(p) for p in path)`` over jax's
key path: ``['layers']/['w_q']``, ``['layers']/[0]/['pre']/[0]/['w']``)
and whether the port holds the leaf transposed (``nn.Linear.weight`` is
``[out, in]``, the reference's ``w`` ``[in, out]``). The optimizer's
moments are ``ParamDict``s with the same paths, so a checkpoint of
``(params, opt_state)`` reads and writes the reference's keys.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch
from torch import nn

Path = Tuple[str, bool]  # (the reference's key path, transposed)


class ParamDict(dict):
    """name -> tensor, with ``paths``: name -> (reference key path,
    transposed)."""

    def __init__(self, items, paths: Mapping[str, Path]):
        super().__init__(items)
        self.paths = dict(paths)

    def like(self, fn) -> "ParamDict":
        """A ``ParamDict`` of ``fn(tensor)`` under the same names and
        paths."""
        return ParamDict({k: fn(t) for k, t in self.items()}, self.paths)


def _module_path(root: nn.Module, name: str) -> Path:
    """``name`` (``layers.0.pre.0.w``) as the reference's key path: an
    index into a ``ModuleList`` is ``[i]``, any other step ``['step']``;
    an ``nn.Linear``'s ``weight`` / ``bias`` are the reference's
    ``w`` (transposed) / ``b``."""
    parts, node = [], root
    steps = name.split(".")
    for i, step in enumerate(steps):
        last = i == len(steps) - 1
        if isinstance(node, (nn.ModuleList, nn.Sequential)):
            parts.append(f"[{int(step)}]")
        elif last and isinstance(node, nn.Linear):
            parts.append("['w']" if step == "weight" else "['b']")
            return "/".join(parts), step == "weight"
        else:
            parts.append(f"['{step}']")
        if not last:
            node = getattr(node, step)
    return "/".join(parts), False


def named(params: Any) -> ParamDict:
    """The parameters of ``params`` (an ``nn.Module``, a ``ParamDict`` or
    a mapping of name to tensor) as a ``ParamDict``."""
    if isinstance(params, ParamDict):
        return params
    if isinstance(params, nn.Module):
        items = dict(params.named_parameters())
        return ParamDict(items, {k: _module_path(params, k) for k in items})
    return ParamDict(params, {k: (f"['{k}']", False) for k in params})


def trainable(params: Any) -> ParamDict:
    """``named(params)`` with every tensor set to require grad (in
    place); the tensors must be leaves."""
    out = named(params)
    for t in out.values():
        t.requires_grad_(True)
    return out


def tensors_from_reference(tree: Any, params: Any,
                           dtype: torch.dtype = None) -> ParamDict:
    """The reference's pytree ``tree`` (nested dicts and lists of arrays
    numpy can read) laid out like ``params``: a ``ParamDict`` of new
    tensors on each parameter's device, in ``dtype`` (default: each
    parameter's own), transposed where the port holds the leaf
    transposed."""
    ref = named(params)
    out: Dict[str, torch.Tensor] = {}
    for name, p in ref.items():
        path, transposed = ref.paths[name]
        node = tree
        for part in path.split("/"):
            key = part[2:-2] if part.startswith("['") else int(part[1:-1])
            node = node[key]
        t = torch.from_numpy(np.array(node, dtype=np.float32))
        if transposed:
            t = t.t()
        if tuple(t.shape) != tuple(p.shape):
            raise ValueError(f"{name}: shape {tuple(t.shape)} != "
                             f"{tuple(p.shape)}")
        out[name] = t.to(device=p.device, dtype=dtype or p.dtype).contiguous()
    return ParamDict(out, ref.paths)
