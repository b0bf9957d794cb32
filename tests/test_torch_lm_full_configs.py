"""The LM configs at ``full()`` on the CPU, with nothing allocated, and
the ``qk_norm`` branch at ``d_head`` = 128.

* The port's ``full()`` parameter count, for each of the five LM
  configs, counted on the meta device, equals the reference's, counted
  with ``jax.eval_shape`` of its ``init_params`` (``n_params``, the
  closed form both configs share, leaves out the norm scales and
  biases).
* The counts and bfloat16 bytes ``chip_smoke.py`` phase 10 checks on the
  card (``LM_FULL_PARAMS``) are the port's own: the bytes are the count
  times 2 (no float32 router in a GQA config).
* qwen3-8b's ``qk_norm`` (two RMSNorms over ``d_head`` between the
  projections and RoPE) at ``d_head`` = 128, the full config's, on 2
  layers at a narrow ``d_model`` and a small vocab, float32: ``forward``'s
  logits, ``prefill``'s last logits and cache and four teacher-forced
  ``decode_step``s against the reference's at rtol/atol 1e-4, with the
  norm scales moved off 1 by seeded noise so a misplaced one shows; and
  layer 0's q, k, v and the kernel route on them (``_attend_kernel`` on
  CPU tensors: kernel h's plain version) against the reference's
  ``_gqa_qkv`` and ``_attend`` at the same tolerance.
"""
import dataclasses
import importlib.util
import math
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as ref_configs  # noqa: E402
from repro.models import transformer as J  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
LM_ARCHS = ["qwen2-7b", "qwen3-8b", "yi-34b", "deepseek-v2-lite-16b",
            "deepseek-v2-236b"]
TOL = dict(rtol=1e-4, atol=1e-4)
B, S, S0 = 2, 12, 8  # batch, tokens, prefill length (then S - S0 decodes)


def _smoke_module():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _port_count(cfg):
    model = T.LM(cfg, "meta")
    return (sum(p.numel() for p in model.parameters()),
            sum(p.numel() * p.element_size() for p in model.parameters()))


@pytest.mark.parametrize("name", LM_ARCHS)
def test_full_parameter_count_matches_the_reference(name):
    cfg = configs.get_arch(name).full()
    rcfg = ref_configs.get_arch(name).full()
    shapes = jax.eval_shape(lambda k: J.init_params(rcfg, k),
                            jax.random.PRNGKey(0))
    ref = sum(math.prod(x.shape) for x in jax.tree_util.tree_leaves(shapes))
    count, _ = _port_count(cfg)
    assert count == ref
    # the configs' closed form (no norm scales or biases) is the same too
    assert cfg.n_params == rcfg.n_params <= count


@pytest.mark.parametrize("name", ["qwen2-7b", "qwen3-8b", "yi-34b"])
def test_phase10_counts_and_bf16_bytes_are_the_ports(name):
    cfg = configs.get_arch(name).full()
    assert cfg.dtype == torch.bfloat16 and cfg.moe is None
    count, nbytes = _port_count(cfg)
    assert _smoke_module().LM_FULL_PARAMS[name] == count
    assert nbytes == 2 * count


# -- qk_norm at d_head = 128 -------------------------------------------------
@pytest.fixture(scope="module")
def qk128():
    """qwen3-8b's ``smoke()`` at ``d_head`` = 128 in float32: the
    reference's init with its norm scales moved by ``0.1 * normal``, the
    tokens, and the reference's forward, prefill and decode."""
    rcfg = dataclasses.replace(ref_configs.get_arch("qwen3-8b").smoke(),
                               d_head=128, dtype=jnp.float32)
    cfg = dataclasses.replace(configs.get_arch("qwen3-8b").smoke(),
                              d_head=128, dtype=torch.float32)
    assert cfg.qk_norm and rcfg.qk_norm
    rng = np.random.default_rng(0)

    def move(path, x):
        x = np.array(x, dtype=np.float32)
        if "norm" in jax.tree_util.keystr(path) or "ln" in \
                jax.tree_util.keystr(path):
            x = x + 0.1 * rng.standard_normal(x.shape).astype(np.float32)
        return x
    tree = jax.tree_util.tree_map_with_path(
        move, J.init_params(rcfg, jax.random.PRNGKey(0)))
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (B, S)).astype(
        np.int32)
    logits, _ = J.forward(rcfg, params, jnp.asarray(toks))
    last, cache = J.prefill(rcfg, params, jnp.asarray(toks[:, :S0]))
    pre = {k: np.array(v) for k, v in cache.items() if k != "length"}
    for k in pre:
        cache[k] = jnp.pad(cache[k], [(0, 0)] * 2 + [(0, S - S0)]
                           + [(0, 0)] * (cache[k].ndim - 3))
    dec = []
    for i in range(S0, S):
        lg, cache = J.decode_step(rcfg, params, cache, jnp.asarray(toks[:, i]))
        dec.append(np.array(lg))
    model = T.lm_params_from_reference(tree, cfg, "cpu")
    assert model.layers.q_norm.shape == (cfg.n_layers, 128)
    return dict(cfg=cfg, rcfg=rcfg, tree=tree, model=model,
                toks=torch.from_numpy(toks),
                logits=np.array(logits), last=np.array(last), pre=pre,
                dec=np.stack(dec, 1))


def test_qk_norm_d128_forward_and_prefill_match_the_reference(qk128):
    cfg, model, t = qk128["cfg"], qk128["model"], qk128["toks"]
    with torch.no_grad():
        logits, _ = T.forward(cfg, model, t)
        last, cache = T.prefill(cfg, model, t[:, :S0])
        pre = {k: v.numpy() for k, v in cache.items() if k != "length"}
        cache = T.widen_cache(cache, S)
        dec = []
        for i in range(S0, S):
            lg, cache = T.decode_step(cfg, model, cache, t[:, i])
            dec.append(lg.numpy())
    np.testing.assert_allclose(logits.numpy(), qk128["logits"], **TOL)
    np.testing.assert_allclose(last.numpy(), qk128["last"], **TOL)
    assert pre.keys() == qk128["pre"].keys() == {"k", "v"}
    for k in pre:
        assert pre[k].shape[-1] == 128
        np.testing.assert_allclose(pre[k], qk128["pre"][k], **TOL,
                                   err_msg=k)
    np.testing.assert_allclose(np.stack(dec, 1), qk128["dec"], **TOL)


def test_qk_norm_d128_kernel_route_matches_the_reference(qk128):
    """Layer 0's q, k and v (projected, qk-normed, RoPE'd) against the
    reference's ``_gqa_qkv``, and the kernel route on them
    (``_attend_kernel`` on CPU tensors: kernel h's plain version) against
    the reference's ``_attend``."""
    cfg, rcfg, model = qk128["cfg"], qk128["rcfg"], qk128["model"]
    rlp = {k: jnp.asarray(v[0]) for k, v in qk128["tree"]["layers"].items()}
    x = np.random.default_rng(2).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)
    want = J._gqa_qkv(rcfg, rlp, jnp.asarray(x), jnp.arange(S)[None])
    with torch.no_grad():
        got = T._gqa_qkv(cfg, T._layer(model, 0), torch.from_numpy(x),
                         torch.arange(S)[None])
        out = T._attend_kernel(*got)
    for g, w, name in zip(got, want, "qkv"):
        assert g.shape[-1] == 128
        np.testing.assert_allclose(g.numpy(), np.array(w), **TOL,
                                   err_msg=name)
    np.testing.assert_allclose(out.numpy(), np.array(J._attend(*want, True)),
                               **TOL)
