"""Generic training loop: grad accumulation (microbatching), clipping,
schedule, AdamW, checkpoint/auto-resume, preemption + straggler hooks.
The reference's ``train/loop.py`` on PyTorch.

``make_train_step`` returns ``train_step(params, opt_state, step, *batch)
-> (params, opt_state, metrics)``. ``params`` is an ``nn.Module`` or a
mapping of name to tensor; the step makes its tensors require grad
(``optim.params.trainable``), takes the gradients with
``torch.autograd.grad`` and updates the parameters and the optimizer
state in place (the reference's ``donate_argnums=(0, 1)``). With
``micro_batches > 1`` the leading axis of every batch tensor (also
inside a tuple, list or dict passed as one argument) is split
into contiguous chunks (the reference's ``reshape((mb, B // mb) + ...)``)
and each chunk's gradients are accumulated into float32 buffers, not
into ``.grad`` (which would accumulate in the parameters' dtype), then
divided by ``mb``; with one micro-batch the gradients stay in the
parameters' dtype, as in the reference.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..optim.adamw import (adamw_init, adamw_update, clip_by_global_norm,
                           f32_zeros)
from ..optim.params import ParamDict, trainable
from ..optim.schedule import cosine_with_warmup
from ..parallel.sharding import is_dtensor, replicated_region
from . import checkpoint as ckpt
from .fault import PreemptionGuard, StragglerMonitor


@dataclasses.dataclass
class TrainConfig:
    lr: float = 3e-4
    warmup: int = 100
    total_steps: int = 1000
    clip_norm: float = 1.0
    weight_decay: float = 0.1
    micro_batches: int = 1
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 100
    keep_ckpts: int = 3


def _micro(x: Any, mb: int, i: int) -> Any:
    """Micro-batch ``i`` of ``mb`` of a batch argument: the ``i``-th
    contiguous chunk of the leading axis of every tensor in it, through
    tuples (named ones too), lists and dicts, each kept as its type; a
    ``None`` stays ``None`` (the reference's ``jax.tree.map`` over the
    batch's leaves)."""
    if isinstance(x, torch.Tensor):
        return x.reshape((mb, x.shape[0] // mb) + tuple(x.shape[1:]))[i]
    if x is None:
        return None
    if isinstance(x, dict):
        return type(x)((k, _micro(v, mb, i)) for k, v in x.items())
    if isinstance(x, (tuple, list)):
        parts = [_micro(v, mb, i) for v in x]
        return type(x)(*parts) if hasattr(x, "_fields") else type(x)(parts)
    raise TypeError("micro_batches > 1 splits tensors and tuples, lists "
                    f"and dicts of them, got {type(x).__name__}")


def _grad(loss: torch.Tensor, leaves) -> Tuple[torch.Tensor, ...]:
    """d loss / d leaves; a leaf the loss does not use gets zeros, as
    ``jax.grad`` gives it."""
    return torch.autograd.grad(loss, leaves, allow_unused=True,
                               materialize_grads=True)


def make_train_step(loss_fn: Callable[..., torch.Tensor], tc: TrainConfig):
    """loss_fn(params, *batch) -> scalar. Batch tensors' leading axis is
    split into ``micro_batches`` chunks for gradient accumulation."""

    def train_step(params, opt_state, step, *batch):
        named = trainable(params)
        # DTensor parameters: plain tensors beside them replicated
        sharded = any(is_dtensor(t) for t in named.values())
        with (replicated_region() if sharded else contextlib.nullcontext()):
            return _step(named, params, opt_state, step, batch)

    def _step(named, params, opt_state, step, batch):
        names, leaves = list(named), list(named.values())
        mb = tc.micro_batches
        with torch.enable_grad():
            if mb == 1:
                loss = loss_fn(params, *batch)
                grads = list(_grad(loss, leaves))
                loss = loss.detach()
            else:
                grads = [f32_zeros(p) for p in leaves]
                loss = torch.zeros((), dtype=torch.float32,
                                   device=leaves[0].device)
                for i in range(mb):
                    part = loss_fn(params, *(_micro(x, mb, i) for x in batch))
                    for acc, g in zip(grads, _grad(part, leaves)):
                        acc.add_(g)
                    loss = loss + part.detach()
                    del part
                loss = loss / mb
                for acc in grads:
                    acc.div_(mb)
        grads, gnorm = clip_by_global_norm(
            ParamDict(zip(names, grads), named.paths), tc.clip_norm)
        lr = cosine_with_warmup(step, tc.lr, tc.warmup, tc.total_steps)
        adamw_update(named, grads, opt_state, lr,
                     weight_decay=tc.weight_decay)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm,
                                   "lr": lr}

    return train_step


def run_training(
    params,
    loss_fn,
    batches,
    tc: TrainConfig,
    log_every: int = 10,
    on_step: Optional[Callable[[int, Dict[str, Any]], None]] = None,
) -> Tuple[Any, Dict[str, Any]]:
    """The host loop: auto-resume, checkpoint cadence, preemption-safe.
    ``params`` is trained in place and returned; the report holds the
    reference's ``history``, ``final_step`` and ``stragglers``, and the
    optimizer state the run ended with (``opt_state``)."""
    opt_state = adamw_init(params)
    step0 = 0
    if tc.ckpt_dir:
        restored_step, _ = ckpt.restore_checkpoint(
            tc.ckpt_dir, (params, opt_state)
        )
        if restored_step is not None:
            step0 = restored_step + 1
    train_step = make_train_step(loss_fn, tc)
    guard = PreemptionGuard()
    monitor = StragglerMonitor()
    history = []
    step = step0
    guard.install()
    try:
        for step, batch in enumerate(batches, start=step0):
            if step >= tc.total_steps:
                break
            monitor.step_start(step)
            params, opt_state, metrics = train_step(
                params, opt_state, step, *batch
            )
            metrics = {k: float(v) for k, v in metrics.items()}
            monitor.step_end()
            history.append(metrics)
            if on_step:
                on_step(step, metrics)
            if tc.ckpt_dir and (
                step % tc.ckpt_every == 0 or guard.requested
            ):
                ckpt.save_checkpoint(tc.ckpt_dir, step, (params, opt_state))
                ckpt.prune_checkpoints(tc.ckpt_dir, tc.keep_ckpts)
            if guard.requested:
                break
    finally:
        guard.uninstall()
    return params, {
        "history": history,
        "final_step": step,
        "stragglers": monitor.straggler_steps,
        "opt_state": opt_state,
    }
