"""The LM stack in bfloat16: the port against the reference on the CPU at
``smoke()`` width, with the parameters of ``test_torch_lm_models.py``
rounded to bfloat16 (the router float32).

The yardstick is the reference's float32 run on those same rounded
parameters, so only the arithmetic's precision differs. The tolerance:
the port's relative L2 error against it is at most 2x the reference's
own bfloat16 run's.

GQA configs (qwen2, qwen3, yi) are held whole: ``forward``'s logits at
every position, ``prefill``'s last logits and cache, and four
teacher-forced ``decode_step``s. The MLA + MoE configs are held layer
by layer on identical inputs (the reference's own bfloat16 layer
inputs): the attention half (``x + attn @ w_o``), then the MoE FFN on
the reference's post-attention state. In bfloat16 a rounding difference
upstream can flip a token's top-k experts, and one flipped token moves
the whole model's output past any elementwise bound; the float32
whole-model parity of those configs is in ``test_torch_lm_models.py``.
"""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.models import transformer as J  # noqa: E402
from test_torch_lm_models import (  # noqa: E402
    _bf16_tree,
    _cfgs,
    _noisy_tree,
    _np,
    _ref_params,
    _rel,
    _run_port,
    _run_ref,
    _t,
    _tokens,
)

from repro_torch.models import transformer as T  # noqa: E402

GQA_ARCHS = ["qwen2-7b", "qwen3-8b", "yi-34b"]
MOE_ARCHS = ["deepseek-v2-lite-16b", "deepseek-v2-236b"]


def _trees(name):
    r32, _ = _cfgs(name, "float32")
    return _bf16_tree(_noisy_tree(r32)), _tokens(r32.vocab)


@pytest.fixture(scope="module")
def whole():
    """Per GQA arch: the rounded tree, the tokens, the reference's bf16
    run and its float32 run on the rounded parameters."""
    out = {}
    for name in GQA_ARCHS:
        r32, _ = _cfgs(name, "float32")
        r16, _ = _cfgs(name, "bfloat16")
        tree, toks = _trees(name)
        out[name] = dict(tree=tree, toks=toks,
                         bf16=_run_ref(r16, _ref_params(tree, r16), toks),
                         truth=_run_ref(r32, _ref_params(tree, r32), toks))
    return out


def _within_twice(got, ref, truth):
    ref_err = _rel(ref, truth)
    assert 0 < ref_err < 0.1
    assert _rel(got, truth) <= 2 * ref_err, (_rel(got, truth), ref_err)


@pytest.mark.parametrize("name", GQA_ARCHS)
def test_bfloat16_within_twice_the_reference_error(whole, name):
    truth, ref = whole[name]["truth"], whole[name]["bf16"]
    _, cfg = _cfgs(name, "bfloat16")
    model = T.lm_params_from_reference(whole[name]["tree"], cfg, "cpu")
    assert model.embed.dtype == model.layers.ln_attn.dtype == torch.bfloat16
    got = _run_port(cfg, model, whole[name]["toks"])
    for key in ("logits", "last", "dec"):
        _within_twice(got[key], ref[key], truth[key])
    for key in truth["pre"]:
        _within_twice(got["pre"][key], ref["pre"][key], truth["pre"][key])


def _ref_halves(cfg, lp, x, positions):
    """The reference's layer in two halves: the post-attention state, and
    the MoE FFN of a given post-attention state."""
    h = J.rms_norm(x, lp["ln_attn"], cfg.norm_eps)
    q = J._mla_q(cfg, lp, h, positions)
    c_kv, k_rope = J._mla_latent(cfg, lp, h, positions)
    attn = J._mla_attend(cfg, lp, q, c_kv, k_rope, causal=True)
    return x + jnp.einsum("bshk,hkd->bsd", attn, lp["w_o"])


def _ref_ffn(cfg, lp, mid):
    return J._moe_ffn(cfg, lp, J.rms_norm(mid, lp["ln_ffn"], cfg.norm_eps))


def _port_halves(cfg, lp, x, positions):
    h = T.rms_norm(x, lp["ln_attn"], cfg.norm_eps)
    q = T._mla_q(cfg, lp, h, positions)
    c_kv, k_rope = T._mla_latent(cfg, lp, h, positions)
    attn = T._mla_attend(cfg, lp, q, c_kv, k_rope, causal=True)
    return x + T._out_proj(attn, lp["w_o"])


def _port_ffn(cfg, lp, mid):
    return T._moe_ffn(cfg, lp, T.rms_norm(mid, lp["ln_ffn"], cfg.norm_eps))


@pytest.mark.parametrize("name", MOE_ARCHS)
def test_mla_moe_layers_within_twice_the_reference_error(name):
    r32, _ = _cfgs(name, "float32")
    r16, cfg = _cfgs(name, "bfloat16")
    tree, toks = _trees(name)
    p16, p32 = _ref_params(tree, r16), _ref_params(tree, r32)
    model = T.lm_params_from_reference(tree, cfg, "cpu")
    positions = jnp.arange(toks.shape[1])[None, :]
    tpos = torch.arange(toks.shape[1])[None, :]
    x = p16["embed"][jnp.asarray(toks)]
    for i in range(r16.n_layers):
        lp16 = jax.tree_util.tree_map(lambda a: a[i], p16["layers"])
        lp32 = jax.tree_util.tree_map(lambda a: a[i], p32["layers"])
        lp = T._layer(model, i)
        with torch.no_grad():
            mid = _ref_halves(r16, lp16, x, positions)
            _within_twice(
                _t(_port_halves(cfg, lp, torch.from_numpy(_np(x)).to(
                    cfg.dtype), tpos)),
                _np(mid), _np(_ref_halves(r32, lp32, x.astype(jnp.float32),
                                          positions)))
            y, aux = _ref_ffn(r16, lp16, mid)
            ty, taux = _port_ffn(cfg, lp, torch.from_numpy(_np(mid)).to(
                cfg.dtype))
            y32, _ = _ref_ffn(r32, lp32, mid.astype(jnp.float32))
            _within_twice(_t(ty), _np(y), _np(y32))
            np.testing.assert_allclose(float(taux), float(aux), rtol=1e-4,
                                       atol=1e-4)
        x, _ = J._layer_fwd(r16, lp16, x, positions)  # the next input


def test_bfloat16_cache_and_logit_dtypes():
    """bf16 parameters give bf16 caches and float32 logits, as in the
    reference."""
    name = "qwen2-7b"
    _, cfg = _cfgs(name, "bfloat16")
    tree, toks = _trees(name)
    model = T.lm_params_from_reference(tree, cfg, "cpu")
    with torch.no_grad():
        last, cache = T.prefill(cfg, model, torch.from_numpy(toks))
        logits, aux = T.forward(cfg, model, torch.from_numpy(toks))
    assert last.dtype == logits.dtype == aux.dtype == torch.float32
    assert cache["k"].dtype == cache["v"].dtype == torch.bfloat16
    assert dataclasses.replace(cfg).dtype == torch.bfloat16
