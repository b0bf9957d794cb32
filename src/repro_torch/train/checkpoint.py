"""Fault-tolerant checkpointing: atomic writes, content hashing, latest-valid
auto-resume, per-host shard files. The reference's ``train/checkpoint.py``,
with its files and keys.

Write protocol: serialize to ``<dir>/tmp.<step>.<host>.npz``, fsync, then
atomically rename to ``step_<step>/shard_<host>.npz`` and finally write the
``COMMIT`` marker with a payload hash — a crash at any point leaves either
a complete committed step or garbage that restore() skips.

A state is any nesting of tuples, lists, mappings, ``nn.Module``s and
tensors; a leaf's key is the reference's (``"/".join(str(p) for p in
path)`` over jax's key path), so ``(params, opt_state)`` from the port
and the reference's ``(params, opt_state)`` pytree write the same keys,
and a float32 checkpoint of either restores in the other. A module's
parameters and the optimizer's moments take their keys from
``optim.params`` (``layers.w_q`` is ``['layers']/['w_q']``; an
``nn.Linear`` weight is written transposed, as the reference's ``w``).

bfloat16 leaves are written as the 2-byte ``|V2`` records the reference
writes (its ``np.asarray`` of a bfloat16 array) and read back through an
int16 view; the reference itself cannot restore them (its ``astype``
has no cast from ``|V2``). ``restore_checkpoint`` copies into the
tensors of ``like`` in place.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..optim.params import ParamDict, named

_CHUNK = 1 << 24


def _leaves(state: Any, prefix: str = ""
            ) -> Iterator[Tuple[str, torch.Tensor, bool]]:
    """(key, tensor, transposed) for every tensor of ``state``."""
    join = (lambda part: f"{prefix}/{part}" if prefix else part)
    if isinstance(state, torch.Tensor):
        yield prefix, state, False
    elif isinstance(state, (nn.Module, ParamDict)):
        p = named(state)
        for name, t in p.items():
            path, transposed = p.paths[name]
            yield join(path), t, transposed
    elif isinstance(state, dict):
        for k, v in state.items():
            yield from _leaves(v, join(f"['{k}']"))
    elif isinstance(state, (tuple, list)):
        for i, v in enumerate(state):
            yield from _leaves(v, join(f"[{i}]"))
    else:
        raise TypeError(f"checkpoint: cannot store {type(state).__name__} "
                        f"at {prefix or 'the root'}")


def _to_numpy(t: torch.Tensor, transposed: bool) -> np.ndarray:
    t = t.detach()
    if transposed:
        t = t.t()
    t = t.contiguous().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


def _to_tensor(arr: np.ndarray) -> torch.Tensor:
    arr = np.require(arr, requirements="C")  # keeps 0-d arrays 0-d
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _flatten(state) -> Dict[str, np.ndarray]:
    return {key: _to_numpy(t, tr) for key, t, tr in _leaves(state)}


@torch.no_grad()
def _unflatten_like(like, flat):
    for key, t, transposed in _leaves(like):
        src = _to_tensor(flat[key])
        if transposed:
            src = src.t()
        if tuple(src.shape) != tuple(t.shape):
            raise ValueError(f"checkpoint: {key} has shape "
                             f"{tuple(src.shape)}, the state "
                             f"{tuple(t.shape)}")
        t.copy_(src.to(t.dtype))
    return like


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(_CHUNK), b""):
            h.update(block)
    return h.hexdigest()


def save_checkpoint(
    ckpt_dir: str, step: int, state: Any, host_id: int = 0
) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    step_dir = os.path.join(ckpt_dir, f"step_{step:010d}")
    os.makedirs(step_dir, exist_ok=True)
    flat = _flatten(state)
    tmp = os.path.join(ckpt_dir, f"tmp.{step}.{host_id}.npz")
    with open(tmp, "wb") as f:
        np.savez(f, **flat)
        f.flush()
        os.fsync(f.fileno())
    del flat
    final = os.path.join(step_dir, f"shard_{host_id:05d}.npz")
    os.replace(tmp, final)  # atomic
    digest = _sha256(final)
    marker = os.path.join(step_dir, f"COMMIT_{host_id:05d}")
    with open(marker + ".tmp", "w") as f:
        json.dump({"step": step, "sha256": digest}, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(marker + ".tmp", marker)
    return final


def _is_committed(step_dir: str, host_id: int) -> bool:
    marker = os.path.join(step_dir, f"COMMIT_{host_id:05d}")
    shard = os.path.join(step_dir, f"shard_{host_id:05d}.npz")
    if not (os.path.exists(marker) and os.path.exists(shard)):
        return False
    try:
        with open(marker) as f:
            meta = json.load(f)
        return _sha256(shard) == meta["sha256"]
    except Exception:
        return False


def latest_step(ckpt_dir: str, host_id: int = 0) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_"):
            step = int(name.split("_")[1])
            if _is_committed(os.path.join(ckpt_dir, name), host_id):
                steps.append(step)
    return max(steps) if steps else None


def restore_checkpoint(
    ckpt_dir: str, like: Any, step: Optional[int] = None, host_id: int = 0
) -> Tuple[Optional[int], Any]:
    """Restore latest committed (or given) step into ``like``'s tensors,
    in place; returns (step, like)."""
    step = latest_step(ckpt_dir, host_id) if step is None else step
    if step is None:
        return None, like
    shard = os.path.join(
        ckpt_dir, f"step_{step:010d}", f"shard_{host_id:05d}.npz"
    )
    with np.load(shard) as z:  # one array in host memory at a time
        return step, _unflatten_like(like, z)


def prune_checkpoints(ckpt_dir: str, keep: int = 3) -> None:
    if not os.path.isdir(ckpt_dir):
        return
    steps = sorted(
        int(n.split("_")[1])
        for n in os.listdir(ckpt_dir)
        if n.startswith("step_")
    )
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:010d}"),
                      ignore_errors=True)
