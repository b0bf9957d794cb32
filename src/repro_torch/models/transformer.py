"""Unified decoder-only LM covering every assigned transformer arch, on
PyTorch.

The port of the reference's ``models/transformer.py``, function for
function and with its names:
  * attention: GQA (llama/yi/qwen) or MLA (DeepSeek-V2 latent KV
    compression, absorbed form)
  * optional qk-norm (qwen3), optional QKV bias (qwen2)
  * FFN: dense SwiGLU or DeepSeek-MoE (shared + routed experts, top-k,
    sort-based capacity dispatch, GShard aux loss)
  * parameters stacked over layers (``[L, ...]``), as the reference's
    pytree; its ``lax.scan`` over layers is a Python loop over views of
    the stacked tensors
  * KV-cache prefill/decode; MLA caches the 512+64-dim latent per token.

Explicit dtypes as in the reference: bf16 activations and parameters by
default, float32 norms, rope, softmax, logits and loss, float32 router.

The kernel route. ``forward``, ``loss_fn`` and ``prefill`` take
``kernel_backend`` (``None``, ``"torch"`` or ``"cuda"``), resolved once
a call by ``resolve_kernel_backend``: ``None`` is ``"cuda"`` on a CUDA
device when the attention is GQA with ``d_head`` in
``kernels.flash_attention.HEAD_DIMS`` and ``dtype`` bfloat16 or float32,
else ``"torch"``. Under ``"cuda"`` every causal ``_attend`` from the
first position (``q_offset=0``) launches the hand-written Hopper kernel
of ``csrc/flash_attention.cu`` (``kernels/flash_attention.py``, which
replaces the reference's Pallas ``flash_attention``: the reference's
``_attend_chunked`` docstring names it the TPU-native form of the same
recurrence); it raises if the kernel cannot build or launch, and never
gives way to the plain path. ``"torch"`` is the reference's arithmetic
(float32 einsums, ``/ sqrt(dq)``, the -1e30 mask, softmax, cast).
Kernel h runs its own streaming softmax, so under ``"cuda"`` it takes a
layer's causal prefill whatever ``attn_chunk``; ``_attend_chunked``
(``attn_chunk > 0`` on ``"torch"``), MLA's absorbed attention and every
decode step are the reference's XLA einsums, not Pallas kernels, and
stay plain PyTorch on every backend.

The KV cache is updated in place: ``decode_step`` writes the new K/V (or
latent) row into the caller's cache tensors with ``index_copy_`` at a
device index (no host sync) and returns the same dict with ``length``
advanced; a copy of the old cache, where one is needed, is the caller's
to take. Like the reference's ``dynamic_update_slice``, a write past the
cache's end lands on its last slot.

Sharding. Parameters placed as DTensors (``parallel.sharding.
shard_params`` by ``lm_param_specs``) make every entry point SPMD over
their mesh: the activations are DTensors; the positions, masks and
indices a backward reads are made replicated DTensors where they are
built (``replicate_like``), and any other plain tensor beside a DTensor
is taken as replicated (``replicated_region``); ``batch_axes`` /
``tp_axis`` (the reference's activation-sharding pins) redistribute the
activations where the reference's ``_pin`` constrains them (``_pin``;
the port pins ``prefill`` as it pins ``forward``). Five blocks run as
explicit per-rank regions (``local_map``): every projection, on each
rank's block with the weight's FSDP split gathered (``_local_contract``:
DTensor refuses to unflatten heads from a split ``h * k`` axis or to
merge a split batch of 1); kernel h, on each rank's ``[B/d, H', S, D]``
block (``_attend_kernel``); MLA's absorbed attention, on each rank's
batch and head block (``_mla_local``); the MoE dispatch, on tokens and
experts replicated on every rank, since its sort, capacity and scatter
need the global token list (``_moe_ffn``; the reference leaves it to
GSPMD). The decode cache write is a masked select over the possibly
length-sharded cache (``_write_slot``). With plain tensors the pins are
no-ops. ``scan_unroll`` changes no value and is kept as a field.

Training. Parameters are built with ``requires_grad=False`` (serving
takes no graph); the training loop (``train/loop.py``) makes them
trainable with ``requires_grad_`` and differentiates ``loss_fn`` with
``torch.autograd.grad``. ``remat="full"`` recomputes each layer in the
backward (``torch.utils.checkpoint``, a layer at a time: the reference's
``jax.checkpoint(..., nothing_saveable)``); it changes no value. The
training entry points (``launch/train.py``, ``launch/steps.py``, the
training examples) call ``loss_fn(..., kernel_backend="torch")``: the
reference trains through XLA and never calls its Pallas attention, and
kernel h, like every kernel of the port, is forward-only, so
``kernel_backend="cuda"`` on trainable parameters raises (``forward_only``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from ..device import resolve_backend, resolve_device
from ..kernels import flash_attention as FA
from ..parallel.sharding import (P, is_dtensor, redistribute,
                                 replicate_like, replicated_region)
from .gnn import _from_reference, _generator

Tensor = torch.Tensor
NEG_INF = -1e30


# ---------------------------------------------------------------------------
# configuration
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_routed: int
    n_shared: int
    top_k: int
    d_expert: int
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    kv_lora: int = 512
    q_lora: int = 0          # 0 = dense q projection
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab: int
    attention: str = "gqa"           # "gqa" | "mla"
    qk_norm: bool = False
    qkv_bias: bool = False
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    dtype: Any = torch.bfloat16
    remat: str = "none"              # "none" | "full"
    scan_unroll: int = 1
    batch_axes: Any = None           # activation-sharding pins (_pin)
    tp_axis: Any = None
    attn_chunk: int = 0              # >0: streaming-softmax KV chunking

    @property
    def n_params(self) -> int:
        """Total parameter count (embedding + layers)."""
        d, ff, v = self.d_model, self.d_ff, self.vocab
        if self.attention == "mla":
            m = self.mla or MLAConfig()
            qk_head = m.nope_head_dim + m.rope_head_dim
            q_in = m.q_lora if m.q_lora else d
            attn = (
                (d * m.q_lora if m.q_lora else 0)
                + q_in * self.n_heads * qk_head
                + d * (m.kv_lora + m.rope_head_dim)
                + m.kv_lora * self.n_heads * (m.nope_head_dim + m.v_head_dim)
                + self.n_heads * m.v_head_dim * d
            )
        else:
            attn = (
                d * self.n_heads * self.d_head
                + 2 * d * self.n_kv_heads * self.d_head
                + self.n_heads * self.d_head * d
            )
        if self.moe:
            ffn = (
                d * self.moe.n_routed  # router
                + (self.moe.n_routed + self.moe.n_shared)
                * 3 * d * self.moe.d_expert
            )
        else:
            ffn = 3 * d * ff
        per_layer = attn + ffn + 2 * d
        return v * d * 2 + self.n_layers * per_layer + d

    @property
    def n_active_params(self) -> int:
        """Active params per token (MoE: top_k + shared experts only)."""
        if not self.moe:
            return self.n_params
        d = self.d_model
        inactive = (
            (self.moe.n_routed - self.moe.top_k)
            * 3 * d * self.moe.d_expert
        ) * self.n_layers
        return self.n_params - inactive


def kernel_takes(cfg: LMConfig) -> bool:
    """Whether kernel h computes this config's attention: GQA with
    ``d_head`` in ``HEAD_DIMS`` and a bfloat16 or float32 ``dtype``."""
    return (cfg.attention == "gqa" and cfg.d_head in FA.HEAD_DIMS
            and cfg.dtype in (torch.bfloat16, torch.float32))


def resolve_kernel_backend(cfg: LMConfig, device,
                           kernel_backend: Optional[str] = None) -> str:
    """``device.resolve_backend`` with the kernel's fit: ``None`` means
    ``"cuda"`` on a CUDA device when ``kernel_takes(cfg)``; ``"cuda"`` on a
    config the kernel does not take raises ``ValueError`` too."""
    backend = resolve_backend(kernel_backend, torch.device(device),
                              kernel_takes(cfg))
    if backend == "cuda" and not kernel_takes(cfg):
        raise ValueError(
            f"kernel_backend='cuda': the attention kernel takes GQA with "
            f"d_head in {FA.HEAD_DIMS} in bfloat16 or float32; "
            f"{cfg.name} has attention={cfg.attention!r}, "
            f"d_head={cfg.d_head}, dtype={cfg.dtype}")
    return backend


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------
def _pin(cfg, x, *rest):
    """``x`` redistributed to ``P(batch_axes, *rest)`` when the config pins
    and ``x`` is a DTensor (the reference's ``with_sharding_constraint``);
    else ``x``."""
    if cfg.batch_axes is None:
        return x
    return redistribute(x, P(cfg.batch_axes, *rest))


def _local_map(fn, out_placements, in_placements, mesh):
    """``local_map`` over ``mesh``, the inputs redistributed to
    ``in_placements`` first."""
    from torch.distributed.tensor.experimental import local_map

    return local_map(fn, out_placements=out_placements,
                     in_placements=in_placements, device_mesh=mesh,
                     redistribute_inputs=True)


def rms_norm(x: Tensor, scale: Tensor, eps: float) -> Tensor:
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * scale


def rope(x: Tensor, positions: Tensor, theta: float) -> Tensor:
    """x [..., S, H, D]; positions [..., S]. ``x * cos`` promotes to
    float32, as ``bf16 * f32`` does in the reference; cast at the end."""
    d = x.shape[-1]
    half = d // 2
    freqs = torch.exp(
        -math.log(theta)
        * torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    angles = positions[..., None].float() * freqs  # [..., S, half]
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# parameters (stacked over layers)
# ---------------------------------------------------------------------------
def _shapes(cfg: LMConfig) -> Dict[str, Tuple[tuple, int, str]]:
    """The reference's ``init_params`` layout: layer entry name ->
    (shape, fan_in, law), law ``"normal"`` (normal / sqrt(fan_in)),
    ``"ones"`` or ``"zeros"``; float32 for the router, else ``cfg.dtype``."""
    d, L = cfg.d_model, cfg.n_layers
    out: Dict[str, Tuple[tuple, int, str]] = {
        "ln_attn": ((L, d), 0, "ones"),
        "ln_ffn": ((L, d), 0, "ones"),
    }
    if cfg.attention == "mla":
        m = cfg.mla or MLAConfig()
        qk_head = m.nope_head_dim + m.rope_head_dim
        q_in = m.q_lora if m.q_lora else d
        if m.q_lora:
            out["w_dq"] = ((L, d, m.q_lora), d, "normal")
            out["q_ln"] = ((L, m.q_lora), 0, "ones")
        out["w_uq"] = ((L, q_in, cfg.n_heads, qk_head), q_in, "normal")
        out["w_dkv"] = ((L, d, m.kv_lora + m.rope_head_dim), d, "normal")
        out["kv_ln"] = ((L, m.kv_lora), 0, "ones")
        out["w_uk"] = ((L, m.kv_lora, cfg.n_heads, m.nope_head_dim),
                       m.kv_lora, "normal")
        out["w_uv"] = ((L, m.kv_lora, cfg.n_heads, m.v_head_dim),
                       m.kv_lora, "normal")
        out["w_o"] = ((L, cfg.n_heads, m.v_head_dim, d),
                      cfg.n_heads * m.v_head_dim, "normal")
    else:
        out["w_q"] = ((L, d, cfg.n_heads, cfg.d_head), d, "normal")
        out["w_k"] = ((L, d, cfg.n_kv_heads, cfg.d_head), d, "normal")
        out["w_v"] = ((L, d, cfg.n_kv_heads, cfg.d_head), d, "normal")
        out["w_o"] = ((L, cfg.n_heads, cfg.d_head, d),
                      cfg.n_heads * cfg.d_head, "normal")
        if cfg.qkv_bias:
            out["b_q"] = ((L, cfg.n_heads, cfg.d_head), 0, "zeros")
            out["b_k"] = ((L, cfg.n_kv_heads, cfg.d_head), 0, "zeros")
            out["b_v"] = ((L, cfg.n_kv_heads, cfg.d_head), 0, "zeros")
        if cfg.qk_norm:
            out["q_norm"] = ((L, cfg.d_head), 0, "ones")
            out["k_norm"] = ((L, cfg.d_head), 0, "ones")
    if cfg.moe:
        mo = cfg.moe
        out["router"] = ((L, d, mo.n_routed), d, "normal")
        out["w_gate"] = ((L, mo.n_routed, d, mo.d_expert), d, "normal")
        out["w_up"] = ((L, mo.n_routed, d, mo.d_expert), d, "normal")
        out["w_down"] = ((L, mo.n_routed, mo.d_expert, d), mo.d_expert,
                         "normal")
        if mo.n_shared:
            sh_ff = mo.d_expert * mo.n_shared
            out["ws_gate"] = ((L, d, sh_ff), d, "normal")
            out["ws_up"] = ((L, d, sh_ff), d, "normal")
            out["ws_down"] = ((L, sh_ff, d), sh_ff, "normal")
    else:
        out["w_gate"] = ((L, d, cfg.d_ff), d, "normal")
        out["w_up"] = ((L, d, cfg.d_ff), d, "normal")
        out["w_down"] = ((L, cfg.d_ff, d), cfg.d_ff, "normal")
    return out


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


class _Layers(nn.Module):
    """The stacked layer tensors, by the reference's names."""


class LM(nn.Module):
    """The LM's parameters: ``embed`` ``[vocab, d]``, ``unembed``
    ``[d, vocab]``, ``final_norm`` and ``layers``, whose attributes are
    the reference's stacked ``[L, ...]`` tensors by name. ``forward``
    is the reference's ``forward`` (logits and aux loss), ``prefill``
    and ``decode_step`` its serving functions; each resolves
    ``kernel_backend`` against the module's current device at the call.
    Left uninitialised: build one with ``init_params`` or
    ``lm_params_from_reference``. ``device`` ``None`` means the card."""

    def __init__(self, cfg: LMConfig, device=None,
                 kernel_backend: Optional[str] = None):
        super().__init__()
        self.cfg = cfg
        self.requested_backend = kernel_backend
        dev = resolve_device(device)
        d, dt = cfg.d_model, cfg.dtype
        self.embed = _param((cfg.vocab, d), dt, dev)
        self.unembed = _param((d, cfg.vocab), dt, dev)
        self.final_norm = _param((d,), dt, dev)
        self.layers = _Layers()
        for name, (shape, _, _) in _shapes(cfg).items():
            ldt = torch.float32 if name == "router" else dt
            setattr(self.layers, name, _param(shape, ldt, dev))

    @property
    def kernel_backend(self) -> str:
        return resolve_kernel_backend(self.cfg, self.embed.device,
                                      self.requested_backend)

    def forward(self, tokens: Tensor) -> Tuple[Tensor, Tensor]:
        return forward(self.cfg, self, tokens, self.requested_backend)

    def prefill(self, tokens: Tensor):
        return prefill(self.cfg, self, tokens, self.requested_backend)

    def decode_step(self, cache, token: Tensor):
        return decode_step(self.cfg, self, cache, token)

    def converted(self, dtype=None, device=None,
                  n_layers: Optional[int] = None) -> "LM":
        """A new module holding copies of this one's tensors in ``dtype``
        (the router stays float32) on ``device`` (``None``: where they
        are), cut to the first ``n_layers`` layers; its config's
        ``dtype`` and ``n_layers`` follow."""
        dt = self.cfg.dtype if dtype is None else dtype
        dev = self.embed.device if device is None else torch.device(device)
        n = self.cfg.n_layers if n_layers is None else n_layers
        cfg = dataclasses.replace(self.cfg, dtype=dt, n_layers=n)
        out = LM(cfg, "meta", self.requested_backend)
        for mod_src, mod_dst in ((self, out), (self.layers, out.layers)):
            for name, p in mod_src.named_parameters(recurse=False):
                t = p[:n] if mod_src is self.layers else p
                t = t.to(device=dev, dtype=torch.float32
                         if name == "router" else dt, copy=True)
                setattr(mod_dst, name, nn.Parameter(t, requires_grad=False))
        return out


def _normal_(p: Tensor, gen: torch.Generator, fan_in: int,
             stacked: bool = True) -> None:
    """``p`` <- standard normal / sqrt(fan_in), drawn in float32 on the
    generator's device and cast; a stacked tensor one layer at a time
    (so no float32 copy of a whole stack is made)."""
    div = math.sqrt(max(1, fan_in))
    for r in (p if stacked else p[None]):
        draw = torch.empty(r.shape, dtype=torch.float32, device=gen.device)
        r.copy_(draw.normal_(generator=gen).div_(div))


def init_params(cfg: LMConfig, generator: Optional[torch.Generator] = None,
                device=None, kernel_backend: Optional[str] = None) -> LM:
    """The reference's init laws: normal / sqrt(fan_in) in float32, then
    cast to ``cfg.dtype`` (the router stays float32); ones for the
    norms, zeros for the biases. Draws come from ``generator`` (default:
    a CPU generator seeded 0) in the reference's key order; the numbers
    differ from ``jax.random``'s."""
    model = LM(cfg, device, kernel_backend)
    gen = _generator(generator)
    _normal_(model.embed, gen, cfg.d_model, stacked=False)
    _normal_(model.unembed, gen, cfg.d_model, stacked=False)
    model.final_norm.fill_(1.0)
    for name, (_, fan_in, law) in _shapes(cfg).items():
        p = getattr(model.layers, name)
        if law == "normal":
            _normal_(p, gen, fan_in)
        else:
            p.fill_(1.0 if law == "ones" else 0.0)
    return model


def lm_params_from_reference(params: Mapping[str, Any], cfg: LMConfig,
                             device=None,
                             kernel_backend: Optional[str] = None) -> LM:
    """The reference's parameter pytree (``embed``, ``unembed``,
    ``final_norm``, ``layers``: arrays) carried into an ``LM`` by name."""
    return _from_reference(LM(cfg, device, kernel_backend), params)


def _layer(params: LM, i: int) -> Dict[str, Tensor]:
    """Layer ``i``'s tensors by the reference's names (views)."""
    return {name: p[i]
            for name, p in params.layers.named_parameters(recurse=False)}


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------
def _group_heads(q: Tensor, hkv: int) -> Tensor:
    """``q [B, S, H, D]`` as ``[B, S, Hkv, H / Hkv, D]``; a DTensor's split
    of the heads over a mesh dimension that does not divide ``Hkv`` is
    gathered first (DTensor cannot unflatten it)."""
    if is_dtensor(q):
        from torch.distributed.tensor import Replicate

        mesh = q.device_mesh
        pl = [Replicate() if p.is_shard(2) and hkv % mesh.size(m) else p
              for m, p in enumerate(q.placements)]
        if pl != list(q.placements):
            q = q.redistribute(mesh, pl)
    b, s, h, d = q.shape
    return q.reshape(b, s, hkv, h // hkv, d)


def _fill_dead(logits: Tensor, dead: Tensor) -> Tensor:
    """``logits`` with the ``dead`` entries at -1e30: in place, or out of
    place on a DTensor (whose partial sums cannot be written in place;
    the mask replicated)."""
    if is_dtensor(logits):
        return logits.masked_fill(replicate_like(dead, logits), NEG_INF)
    return logits.masked_fill_(dead, NEG_INF)


def _attend_chunked(q: Tensor, k: Tensor, v: Tensor, causal: bool,
                    chunk: int) -> Tensor:
    """Streaming-softmax attention: a loop over KV chunks with running
    max/normalizer, so the [S, T] score matrix never materializes (the
    reference's ``lax.scan`` form, plain PyTorch on every backend)."""
    b, s, h, dq = q.shape
    t, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    n_chunks = t // chunk
    qg = _group_heads(q, hkv).float() / math.sqrt(dq)
    q_pos = torch.arange(s, device=q.device)
    dv = v.shape[-1]
    acc = replicate_like(torch.zeros((b, hkv, g, s, dv), dtype=torch.float32,
                                     device=q.device), q)
    m = replicate_like(torch.full((b, hkv, g, s), NEG_INF,
                                  dtype=torch.float32, device=q.device), q)
    l = replicate_like(torch.zeros((b, hkv, g, s), dtype=torch.float32,
                                   device=q.device), q)
    for idx in range(n_chunks):
        k_i = k[:, idx * chunk:(idx + 1) * chunk]
        v_i = v[:, idx * chunk:(idx + 1) * chunk]
        logits = torch.einsum("bshgd,bthd->bhgst", qg, k_i.float())
        if causal:
            k_pos = idx * chunk + torch.arange(chunk, device=q.device)
            logits = _fill_dead(logits, ~(q_pos[:, None] >= k_pos[None, :]))
        m_new = torch.maximum(m, logits.amax(dim=-1))
        # amax saved ``logits`` for its backward: subtract out of place
        # when a graph is being recorded
        shifted = (logits - m_new[..., None]
                   if logits.requires_grad or is_dtensor(logits)
                   else logits.sub_(m_new[..., None]))
        p = torch.exp(shifted)
        del shifted
        del logits
        alpha = torch.exp(m - m_new)
        l = alpha * l + p.sum(dim=-1)
        acc = alpha[..., None] * acc + torch.einsum(
            "bhgst,bthd->bhgsd", p, v_i.float())
        m = m_new
        del p
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, h, dv).to(q.dtype)


def _kernel_placements(q: Tensor, k: Tensor) -> list:
    """The placements kernel h runs under on q's mesh: q's split of the
    batch (dim 0), and of the heads (dim 2) where the query and the
    key/value heads both divide that mesh dimension (then each rank's
    query heads use its own key/value heads); every other dimension
    whole."""
    from torch.distributed.tensor import Replicate, Shard

    mesh, out = q.device_mesh, []
    for m, pl in enumerate(q.placements):
        size = mesh.size(m)
        if pl == Shard(0) or (pl == Shard(2) and q.shape[2] % size == 0
                              and k.shape[2] % size == 0):
            out.append(pl)
        else:
            out.append(Replicate())
    return out


def _attend_kernel(q: Tensor, k: Tensor, v: Tensor) -> Tensor:
    """Causal attention from the first position on kernel h: q/k/v
    transposed to ``[B, H, S, D]``, one ``flash_attention`` call with the
    whole lengths as blocks (the CUDA kernel picks its own tile, so any
    S), transposed back. On CPU tensors the wrapper runs its plain
    version. On DTensors each rank launches the kernel once on its own
    block (``local_map``; ``_kernel_placements``)."""
    if is_dtensor(q):
        pl = _kernel_placements(q, k)
        return _local_map(_attend_kernel, pl, (pl, pl, pl),
                          q.device_mesh)(q, k, v)
    s, t = q.shape[1], k.shape[1]
    out = FA.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                             v.transpose(1, 2), causal=True, block_q=s,
                             block_k=t)
    return out.transpose(1, 2)


def _attend(q: Tensor, k: Tensor, v: Tensor, causal: bool,
            q_offset=0, kernel_backend: str = "torch") -> Tensor:
    """q [B,S,H,Dq], k/v [B,T,Hkv,D*]; returns [B,S,H,Dv]. fp32 softmax.
    ``kernel_backend="cuda"`` takes only the kernel's case (causal,
    ``q_offset`` 0) and launches kernel h."""
    if kernel_backend == "cuda":
        if not causal or not (isinstance(q_offset, int) and q_offset == 0):
            raise ValueError("kernel_backend='cuda': kernel h computes "
                             "causal attention from position 0 only")
        return _attend_kernel(q, k, v)
    b, s, h, dq = q.shape
    t, hkv = k.shape[1], k.shape[2]
    qg = _group_heads(q, hkv)
    logits = torch.einsum("bshgd,bthd->bhgst", qg.float(),
                          k.float()).div_(math.sqrt(dq))
    if causal:
        q_pos = q_offset + torch.arange(s, device=q.device)[:, None]
        k_pos = torch.arange(t, device=q.device)[None, :]
        logits = _fill_dead(logits, ~(q_pos >= k_pos))
    probs = torch.softmax(logits, dim=-1)
    del logits
    out = torch.einsum("bhgst,bthd->bshgd", probs, v.float())
    return out.reshape(b, s, h, v.shape[-1]).to(q.dtype)


def _proj(x: Tensor, w: Tensor) -> Tensor:
    """``einsum("bsd,dhk->bshk", x, w)`` as one matmul (``w`` of any rank
    from 2; ``_local_contract`` on a DTensor weight)."""
    if is_dtensor(w):
        return _local_contract(x, w, 1)
    return (x @ w.reshape(w.shape[0], -1)).reshape(
        x.shape[:-1] + tuple(w.shape[1:]))


def _local_contract(x: Tensor, w: Tensor, c: int) -> Tensor:
    """``x``'s last ``c`` dimensions contracted with ``w``'s first ``c``
    (``tensordot``), on each rank's block (``local_map``), so no split
    dimension is ever flattened or unflattened (DTensor refuses to merge
    a split dimension of size 1, or to unflatten ``h * k`` split
    unevenly). Per mesh dimension: ``x``'s split of a leading dimension
    is kept; ``w``'s split of a contracted dimension is kept where ``x``
    splits the same one (a partial sum: tensor parallelism), else
    all-gathered (FSDP); ``w``'s split of an output dimension (heads) is
    kept unless ``x`` is split there too. The gradients' placements
    follow (a partial sum where the other operand's split made it
    one)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    x = replicate_like(x, w)
    mesh = w.device_mesh
    lead = x.dim() - c
    x_pl, w_pl, out_pl, xg_pl, wg_pl = [], [], [], [], []
    for m in range(mesh.ndim):
        px, pw = x.placements[m], w.placements[m]
        xd = px.dim if px.is_shard() else None
        wd = pw.is_shard() and pw.dim
        if xd is not None and xd < lead:                  # batch split
            x_pl.append(px), w_pl.append(Replicate())
            out_pl.append(Shard(xd)), xg_pl.append(px)
            wg_pl.append(Partial())
        elif (xd is not None and pw.is_shard() and wd < c
              and xd == lead + wd):                        # contraction
            x_pl.append(px), w_pl.append(pw)
            out_pl.append(Partial()), xg_pl.append(px), wg_pl.append(pw)
        elif pw.is_shard() and wd >= c:                    # output split
            x_pl.append(Replicate()), w_pl.append(pw)
            out_pl.append(Shard(lead + wd - c)), xg_pl.append(Partial())
            wg_pl.append(pw)
        else:
            x_pl.append(Replicate()), w_pl.append(Replicate())
            out_pl.append(Replicate()), xg_pl.append(Replicate())
            wg_pl.append(Replicate())

    def local(x_, w_):
        k = math.prod(w_.shape[:c])
        return (x_.reshape(x_.shape[:lead] + (k,))
                @ w_.reshape(k, -1)).reshape(
                    x_.shape[:lead] + tuple(w_.shape[c:]))

    return local_map(local, out_placements=out_pl,
                     in_placements=(x_pl, w_pl),
                     in_grad_placements=(xg_pl, wg_pl), device_mesh=mesh,
                     redistribute_inputs=True)(x, w)


def _gqa_qkv(cfg, lp, x, positions):
    q = _proj(x, lp["w_q"])
    k = _proj(x, lp["w_k"])
    v = _proj(x, lp["w_v"])
    if cfg.qkv_bias:
        q = q + lp["b_q"]
        k = k + lp["b_k"]
        v = v + lp["b_v"]
    if cfg.qk_norm:
        q = rms_norm(q, lp["q_norm"], cfg.norm_eps)
        k = rms_norm(k, lp["k_norm"], cfg.norm_eps)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def _mla_q(cfg, lp, x, positions):
    m = cfg.mla or MLAConfig()
    if m.q_lora:
        cq = rms_norm(_proj(x, lp["w_dq"]), lp["q_ln"], cfg.norm_eps)
    else:
        cq = x
    q = _proj(cq, lp["w_uq"])
    q_nope = q[..., : m.nope_head_dim]
    q_rope = rope(q[..., m.nope_head_dim:], positions, cfg.rope_theta)
    return torch.cat([q_nope, q_rope], dim=-1)


def _mla_latent(cfg, lp, x, positions):
    """Returns the per-token latent cache entry: c_kv [B,S,R], k_rope
    [B,S,1,Dr]."""
    m = cfg.mla or MLAConfig()
    dkv = _proj(x, lp["w_dkv"])
    c_kv = rms_norm(dkv[..., : m.kv_lora], lp["kv_ln"], cfg.norm_eps)
    k_rope = rope(dkv[..., m.kv_lora:][:, :, None, :], positions,
                  cfg.rope_theta)
    return c_kv, k_rope


def _mla_scores(cfg, lp, q, c_kv, k_rope):
    """Absorbed MLA logits ``[B, H, S, T]`` (float32), scaled."""
    m = cfg.mla or MLAConfig()
    q_nope = q[..., : m.nope_head_dim]
    q_rope = q[..., m.nope_head_dim:]
    q_lat = torch.einsum("bshk,rhk->bshr", q_nope, lp["w_uk"])
    logits = torch.einsum("bshr,btr->bhst", q_lat.float(), c_kv.float())
    logits = logits + torch.einsum("bshk,btk->bhst", q_rope.float(),
                           k_rope[:, :, 0].float())
    return logits.div_(math.sqrt(m.nope_head_dim + m.rope_head_dim))


def _mla_values(lp, probs, c_kv, dtype):
    """Value in latent space, then up-project: ``o = (probs @ c_kv) @
    w_uv``, ``o_lat`` cast to q's dtype first."""
    o_lat = torch.einsum("bhst,btr->bshr", probs, c_kv.float())
    return torch.einsum("bshr,rhk->bshk", o_lat.to(dtype), lp["w_uv"])


def _mla_attend(cfg, lp, q, c_kv, k_rope, causal, q_offset=0):
    """MLA attention against the latent cache (absorbed form).

    q [B,S,H,nope+rope]; c_kv [B,T,R]; k_rope [B,T,1,Dr].
    k_nope[h] = c_kv @ w_uk[h]; score = q_nope.k_nope + q_rope.k_rope.
    The nope part is computed in the latent space by absorbing w_uk into
    q (q_lat = q_nope @ w_uk^T), so per-token decode work is O(R).
    On DTensors, each rank's batch and head block (``_mla_local``).
    """
    if is_dtensor(q):
        return _mla_local(cfg, lp, q, c_kv, k_rope, causal, q_offset)
    logits = _mla_scores(cfg, lp, q, c_kv, k_rope)
    s, t = q.shape[1], c_kv.shape[1]
    if causal:
        q_pos = q_offset + torch.arange(s, device=q.device)[:, None]
        k_pos = torch.arange(t, device=q.device)[None, :]
        logits = _fill_dead(logits, ~(q_pos >= k_pos))
    probs = torch.softmax(logits, dim=-1)
    del logits
    return _mla_values(lp, probs, c_kv, q.dtype)


def _mla_local(cfg, lp, q, c_kv, k_rope, causal, q_offset):
    """``_mla_attend`` on each rank's block (``local_map``): per mesh
    dimension, a batch split of ``q`` keeps the latents' batch split and
    gathers ``w_uk`` / ``w_uv``; a head split keeps the weights' head
    split and gathers the latents (every head reads all of them); any
    other split of ``q`` is gathered. The gradients of what was gathered
    are partial sums."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = q.device_mesh
    q_pl, kv_pl, w_pl, kv_g, w_g = [], [], [], [], []
    for p in q.placements:
        batch, heads = p == Shard(0), p == Shard(2)
        q_pl.append(p if batch or heads else Replicate())
        kv_pl.append(Shard(0) if batch else Replicate())
        w_pl.append(Shard(1) if heads else Replicate())
        kv_g.append(Shard(0) if batch else Partial() if heads
                    else Replicate())
        w_g.append(Shard(1) if heads else Partial() if batch
                   else Replicate())

    def local(q_, c_, r_, uk, uv):
        return _mla_attend(cfg, {"w_uk": uk, "w_uv": uv}, q_, c_, r_,
                           causal, q_offset)

    c_kv, k_rope = replicate_like(c_kv, q), replicate_like(k_rope, q)
    return local_map(local, out_placements=q_pl,
                     in_placements=(q_pl, kv_pl, kv_pl, w_pl, w_pl),
                     in_grad_placements=(q_pl, kv_g, kv_g, w_g, w_g),
                     device_mesh=mesh, redistribute_inputs=True)(
                         q, c_kv, k_rope, lp["w_uk"], lp["w_uv"])


# ---------------------------------------------------------------------------
# FFN / MoE
# ---------------------------------------------------------------------------
def _dense_ffn(lp, x):
    gate = F.silu(_proj(x, lp["w_gate"]))
    up = _proj(x, lp["w_up"])
    return _proj(gate * up, lp["w_down"])


def _top_k(x: Tensor, k: int) -> Tuple[Tensor, Tensor]:
    """``lax.top_k``: the k largest along the last axis, the lower index
    first among equal values (a stable descending sort)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _moe_ffn(cfg: LMConfig, lp, x):
    """Sort-based capacity MoE (shared experts always-on). Returns the
    output and the GShard load-balancing aux loss (float32).

    On DTensors the whole block runs on each rank on the replicated
    tokens and experts (``local_map``): the capacity, the stable sort
    and the drop depend on the global token list, so each rank
    computes all of it and the output is pinned back to the batch split
    (the reference's ``_pin``). The expert weights are all-gathered a
    layer; an expert-parallel dispatch is not ported."""
    if is_dtensor(x):
        from torch.distributed.tensor import Replicate

        mesh = x.device_mesh
        rep = [Replicate()] * mesh.ndim
        names = ["router", "w_gate", "w_up", "w_down"]
        if cfg.moe.n_shared:
            names += ["ws_gate", "ws_up", "ws_down"]

        def local(x_, *ws):
            return _moe_ffn(cfg, dict(zip(names, ws)), x_)

        out, aux = _local_map(local, (rep, rep), (rep,) * (1 + len(names)),
                              mesh)(x, *(lp[n] for n in names))
        return _pin(cfg, out, None, None), aux
    mo = cfg.moe
    b, s, d = x.shape
    t = b * s
    xt = x.reshape(t, d)
    logits = xt.float() @ lp["router"]
    gates = torch.softmax(logits, dim=-1)
    topw, topi = _top_k(gates, mo.top_k)  # [t, k]
    topw = (topw / topw.sum(dim=-1, keepdim=True)).to(x.dtype)

    # capacity dispatch: group assignments by expert
    cap = int(mo.capacity_factor * mo.top_k * t / mo.n_routed) + 1
    n_slots = mo.n_routed * cap
    dev = x.device
    flat_e = topi.reshape(-1)  # [t*k]
    flat_t = torch.arange(t, device=dev).repeat_interleave(mo.top_k)
    flat_w = topw.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    se, st_, sw = flat_e[order], flat_t[order], flat_w[order]
    # position of each assignment within its expert group
    pos_in_e = torch.arange(t * mo.top_k, device=dev) - torch.searchsorted(
        se, se, side="left")
    keep = pos_in_e < cap
    # dropped assignments go to the spare slot n_slots, cut off after (the
    # reference's out-of-bounds scatter with mode="drop")
    slot = torch.where(keep, se * cap + pos_in_e, n_slots)
    buf_tok = torch.zeros(n_slots + 1, dtype=torch.int64, device=dev)
    buf_tok[slot] = st_
    buf_use = torch.zeros(n_slots + 1, dtype=torch.bool, device=dev)
    buf_use[slot] = keep
    buf_w = torch.zeros(n_slots + 1, dtype=x.dtype, device=dev)
    buf_w[slot] = sw
    buf_tok, buf_use, buf_w = buf_tok[:n_slots], buf_use[:n_slots], \
        buf_w[:n_slots]
    xe = xt[buf_tok].reshape(mo.n_routed, cap, d)
    xe = xe * buf_use.reshape(mo.n_routed, cap, 1).to(x.dtype)
    gate = F.silu(torch.bmm(xe, lp["w_gate"]))
    up = torch.bmm(xe, lp["w_up"])
    ye = torch.bmm(gate * up, lp["w_down"])
    ye = ye * buf_w.reshape(mo.n_routed, cap, 1)
    out = torch.zeros((t, d), dtype=x.dtype, device=dev).index_add_(
        0, buf_tok, ye.reshape(n_slots, d))
    # router aux loss (load balancing, GShard style)
    me = gates.mean(dim=0)
    ce = F.one_hot(topi, mo.n_routed).float().sum(dim=1).mean(dim=0)
    aux = (me * ce).sum() * mo.n_routed
    if mo.n_shared:
        sh_gate = F.silu(xt @ lp["ws_gate"])
        sh_up = xt @ lp["ws_up"]
        out = out + (sh_gate * sh_up) @ lp["ws_down"]
    return out.reshape(b, s, d), aux


def _ffn(cfg, lp, h):
    if cfg.moe:
        return _moe_ffn(cfg, lp, h)
    return _dense_ffn(lp, h), None


def _out_proj(attn: Tensor, w_o: Tensor) -> Tensor:
    """``einsum("bshk,hkd->bsd", attn, w_o)`` as one matmul."""
    if is_dtensor(w_o):
        return _local_contract(attn, w_o, 2)
    return attn.reshape(attn.shape[:2] + (-1,)) @ w_o.reshape(-1,
                                                              w_o.shape[-1])


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------
def _gqa_attention(cfg, q, k, v, kernel_backend):
    """A layer's causal attention: kernel h under ``"cuda"`` (a streaming
    softmax of its own, whatever ``attn_chunk``), else the reference's
    streaming form where ``attn_chunk`` divides S, else ``_attend``."""
    if (kernel_backend != "cuda" and cfg.attn_chunk
            and q.shape[1] % cfg.attn_chunk == 0):
        return _attend_chunked(q, k, v, causal=True, chunk=cfg.attn_chunk)
    return _attend(q, k, v, causal=True, kernel_backend=kernel_backend)


def _block(cfg: LMConfig, lp, x, positions, kernel_backend):
    """One layer: ``(x_out, aux or None, this layer's cache entries)``,
    with the reference's ``_layer_fwd`` pins (no-ops unless sharded)."""
    x = _pin(cfg, x, None, None)
    h = rms_norm(x, lp["ln_attn"], cfg.norm_eps)
    if cfg.attention == "mla":
        q = _pin(cfg, _mla_q(cfg, lp, h, positions), None, cfg.tp_axis,
                 None)
        c_kv, k_rope = _mla_latent(cfg, lp, h, positions)
        attn = _mla_attend(cfg, lp, q, c_kv, k_rope, causal=True)
        lc = {"c_kv": c_kv, "k_rope": k_rope}
    else:
        q, k, v = _gqa_qkv(cfg, lp, h, positions)
        q = _pin(cfg, q, None, None, None)
        attn = _gqa_attention(cfg, q, k, v, kernel_backend)
        lc = {"k": k, "v": v}
    del h, q
    attn = _pin(cfg, attn, None, None, None)
    x = _pin(cfg, x + _out_proj(attn, lp["w_o"]), None, None)
    del attn
    h = rms_norm(x, lp["ln_ffn"], cfg.norm_eps)
    y, aux = _ffn(cfg, lp, h)
    return x + _pin(cfg, y, None, None), aux, lc


def _layer_fwd(cfg: LMConfig, lp, x, positions, kernel_backend="torch"):
    x, aux, _ = _block(cfg, lp, x, positions, kernel_backend)
    if aux is None:
        aux = replicate_like(torch.zeros((), dtype=torch.float32,
                                         device=x.device), x)
    return x, aux


def _layer_remat(cfg: LMConfig, lp, x, positions, kernel_backend):
    """``_layer_fwd`` under ``remat="full"`` while a graph is recorded:
    nothing of the layer is saved but its inputs, and the backward runs
    the layer again."""
    if cfg.remat == "full" and torch.is_grad_enabled():
        return torch.utils.checkpoint.checkpoint(
            _layer_fwd, cfg, lp, x, positions, kernel_backend,
            use_reentrant=False)
    return _layer_fwd(cfg, lp, x, positions, kernel_backend)


def _logits(cfg, params, x):
    x = rms_norm(x, params.final_norm, cfg.norm_eps)
    return _proj(x.float(), params.unembed.float())


def _region(params):
    """The context a call on ``params`` runs in: ``replicated_region``
    when they are DTensors, else none."""
    if is_dtensor(params.embed):
        return replicated_region()
    return contextlib.nullcontext()


def _embed(params, tokens: Tensor) -> Tensor:
    """The token rows of ``embed`` (``F.embedding``: DTensor has its
    vocab-parallel rule, whose partial rows are summed here)."""
    x = F.embedding(replicate_like(tokens.long(), params.embed),
                    params.embed)
    if is_dtensor(x) and any(p.is_partial() for p in x.placements):
        from torch.distributed.tensor import Replicate

        x = x.redistribute(x.device_mesh, [
            Replicate() if p.is_partial() else p for p in x.placements])
    return x


def forward(cfg: LMConfig, params: LM, tokens: Tensor,
            kernel_backend: Optional[str] = None) -> Tuple[Tensor, Tensor]:
    """tokens [B, S] -> (logits [B, S, vocab] f32, aux loss)."""
    backend = resolve_kernel_backend(cfg, params.embed.device,
                                     kernel_backend)
    with _region(params):
        x = _pin(cfg, _embed(params, tokens), None, None)
        positions = replicate_like(
            torch.arange(tokens.shape[1], device=x.device)[None, :], x)
        aux = replicate_like(torch.zeros((), dtype=torch.float32,
                                         device=x.device), x)
        for i in range(cfg.n_layers):
            x, a = _layer_remat(cfg, _layer(params, i), x, positions,
                                backend)
            aux = aux + a
        logits = _pin(cfg, _logits(cfg, params, x), None, cfg.tp_axis)
        return logits, aux / cfg.n_layers


def loss_fn(cfg: LMConfig, params: LM, tokens, targets,
            kernel_backend: Optional[str] = None) -> Tensor:
    """Mean next-token NLL plus 0.01 x the MoE aux loss (float32).
    Differentiable on the plain path; the training entry points pass
    ``kernel_backend="torch"`` (the module docstring says why)."""
    logits, aux = forward(cfg, params, tokens, kernel_backend)
    with _region(params):
        logp = torch.log_softmax(logits, dim=-1)
        idx = replicate_like(targets.long()[..., None], logp)
        nll = -torch.gather(logp, -1, idx)[..., 0]
        return nll.mean() + 0.01 * aux


# ---------------------------------------------------------------------------
# serving: prefill + decode with KV cache
# ---------------------------------------------------------------------------
def _cache_shapes(cfg: LMConfig, batch: int, seq: int) -> Dict[str, tuple]:
    if cfg.attention == "mla":
        m = cfg.mla or MLAConfig()
        return {"c_kv": (cfg.n_layers, batch, seq, m.kv_lora),
                "k_rope": (cfg.n_layers, batch, seq, 1, m.rope_head_dim)}
    kv = (cfg.n_layers, batch, seq, cfg.n_kv_heads, cfg.d_head)
    return {"k": kv, "v": kv}


def init_cache(cfg: LMConfig, batch: int, max_seq: int,
               device=None) -> Dict[str, Tensor]:
    """Zero caches ``[L, B, max_seq, ...]`` in ``cfg.dtype`` and
    ``length`` a 0-d int32 tensor, on ``device`` (``None``: the card)."""
    dev = resolve_device(device)
    cache = {name: torch.zeros(shape, dtype=cfg.dtype, device=dev)
             for name, shape in _cache_shapes(cfg, batch, max_seq).items()}
    cache["length"] = torch.zeros((), dtype=torch.int32, device=dev)
    return cache


def widen_cache(cache: Dict[str, Tensor], max_seq: int) -> Dict[str, Tensor]:
    """The cache's sequence axis (2) zero-padded to ``max_seq`` slots, as
    the reference's ``launch/serve.py`` widens a prefill's cache for
    generation; a new dict of new tensors, ``length`` kept."""
    out = {}
    for name, x in cache.items():
        if name == "length":
            out[name] = x
            continue
        shape = list(x.shape)
        shape[2] = max_seq
        out[name] = x.new_zeros(shape)
        out[name][:, :, : x.shape[2]] = x
    return out


def _write_slot(buf: Tensor, new: Tensor, pos: Tensor) -> None:
    """``dynamic_update_slice(buf, new, (0, pos, 0...))`` in place: the
    one-slot update ``new`` [B, 1, ...] at sequence slot ``pos`` (a 0-d
    device tensor), the start clamped to ``[0, T - 1]`` as XLA clamps it
    (a write past the end lands on the last slot). On a DTensor cache,
    whose length may be split, each rank writes its own block
    (``local_map``): the row lands where the clamped slot falls in the
    block, and a rank whose block does not hold it writes its own row
    back."""
    t = buf.shape[1]
    if is_dtensor(buf):
        _write_slot_local(buf, new, pos)
        return
    idx = pos.clamp(0, t - 1).reshape(1).long()
    buf.index_copy_(1, idx, new.to(buf.dtype))


def _write_slot_local(buf: Tensor, new: Tensor, pos: Tensor) -> None:
    """``_write_slot`` on each rank's block of DTensor ``buf``: ``new`` is
    split as ``buf`` is but along the length, which it holds whole."""
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    from torch.distributed.tensor.experimental import local_map

    mesh, t = buf.device_mesh, buf.shape[1]
    _, offset = compute_local_shape_and_global_offset(buf.shape, mesh,
                                                      buf.placements)
    buf_pl = list(buf.placements)
    new_pl = [Replicate() if p.is_shard(1) else p for p in buf_pl]
    rep = [Replicate()] * mesh.ndim

    def local(b, n, p):
        at = p.clamp(0, t - 1) - offset[1]
        inside = (at >= 0) & (at < b.shape[1])
        idx = at.clamp(0, b.shape[1] - 1).reshape(1).long()
        row = torch.where(inside, n.to(b.dtype), b.index_select(1, idx))
        b.index_copy_(1, idx, row)
        return b

    local_map(local, out_placements=buf_pl,
              in_placements=(buf_pl, new_pl, rep), device_mesh=mesh,
              redistribute_inputs=True)(
                  buf, replicate_like(new, buf), replicate_like(pos, buf))


def _decode_layer(cfg, lp, x, layer_cache, pos):
    """x [B, 1, d]; ``layer_cache`` holds this layer's K/V (or latent)
    slices, written in place at ``pos``."""
    h = rms_norm(x, lp["ln_attn"], cfg.norm_eps)
    positions = pos.reshape(1, 1)
    key = "c_kv" if cfg.attention == "mla" else "k"
    t = layer_cache[key].shape[1]
    kv_mask = (torch.arange(t, device=x.device) <= pos)[None, :]
    if cfg.attention == "mla":
        q = _mla_q(cfg, lp, h, positions)
        c_kv_new, k_rope_new = _mla_latent(cfg, lp, h, positions)
        _write_slot(layer_cache["c_kv"], c_kv_new, pos)
        _write_slot(layer_cache["k_rope"], k_rope_new, pos)
        c_kv = layer_cache["c_kv"]
        logits = _mla_scores(cfg, lp, q, c_kv, layer_cache["k_rope"])
        logits = _fill_dead(logits, ~kv_mask[None, None])
        probs = torch.softmax(logits, dim=-1)
        del logits
        attn = _mla_values(lp, probs, c_kv, x.dtype)
    else:
        q, k_new, v_new = _gqa_qkv(cfg, lp, h, positions)
        _write_slot(layer_cache["k"], k_new, pos)
        _write_slot(layer_cache["v"], v_new, pos)
        k, v = layer_cache["k"], layer_cache["v"]
        b, s, hh, dq = q.shape
        hkv = k.shape[2]
        qg = _group_heads(q, hkv)
        logits = torch.einsum("bshgd,bthd->bhgst", qg.float(),
                              k.float()).div_(math.sqrt(dq))
        logits = _fill_dead(logits, ~kv_mask[None, None, None])
        probs = torch.softmax(logits, dim=-1)
        del logits
        attn = torch.einsum("bhgst,bthd->bshgd", probs, v.float()).reshape(
            b, s, hh, dq).to(x.dtype)
    x = x + _out_proj(attn, lp["w_o"])
    h = rms_norm(x, lp["ln_ffn"], cfg.norm_eps)
    y, _ = _ffn(cfg, lp, h)
    return x + y


def decode_step(cfg: LMConfig, params: LM, cache: Dict[str, Tensor],
                token: Tensor):
    """token [B] -> (logits [B, vocab], cache). One decode position.

    The cache is updated in place: the new K/V (or latent) row is
    written into ``cache``'s tensors at slot ``length`` and the same
    dict is returned with ``length`` advanced by one (a new 0-d tensor).
    Plain PyTorch on every backend (the reference's float32 einsums)."""
    with _region(params):
        x = _embed(params, token)[:, None, :]  # [B,1,d]
        pos = cache["length"]
        names = [k for k in cache if k != "length"]
        for i in range(cfg.n_layers):
            x = _decode_layer(cfg, _layer(params, i), x,
                              {k: cache[k][i] for k in names}, pos)
        logits = _logits(cfg, params, x)[:, 0]
        cache["length"] = pos + 1
        return logits, cache


def prefill(cfg: LMConfig, params: LM, tokens: Tensor,
            kernel_backend: Optional[str] = None):
    """tokens [B, S] -> (last logits [B, vocab], cache filled to S)."""
    backend = resolve_kernel_backend(cfg, params.embed.device,
                                     kernel_backend)
    b, s = tokens.shape
    sharded = is_dtensor(params.embed)
    with _region(params):
        x = _pin(cfg, _embed(params, tokens), None, None)
        positions = replicate_like(
            torch.arange(s, device=x.device)[None, :], x)
        if sharded:  # each layer's entries, stacked at the end
            cache = {name: [] for name in _cache_shapes(cfg, b, s)}
        else:
            cache = {name: torch.empty(shape, dtype=cfg.dtype,
                                       device=x.device)
                     for name, shape in _cache_shapes(cfg, b, s).items()}
        for i in range(cfg.n_layers):
            x, _, lc = _block(cfg, _layer(params, i), x, positions, backend)
            for name, val in lc.items():
                if sharded:
                    cache[name].append(val)
                else:
                    cache[name][i] = val
            del lc
        if sharded:
            cache = {name: torch.stack(vals) for name, vals in cache.items()}
        logits = _logits(cfg, params, x[:, -1:])[:, 0]
        cache["length"] = torch.tensor(s, dtype=torch.int32,
                                       device=x.device)
        return logits, cache
