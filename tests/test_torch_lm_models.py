"""The LM stack: the port (``repro_torch.models.transformer``) against the
reference on the CPU, at ``smoke()`` width, for every LM config (GQA with
QKV bias, GQA with qk-norm, plain GQA, MLA + MoE without and with
``q_lora``).

Parameters come from the reference's ``init_params`` with every leaf the
init leaves constant (the norms' ones, the biases' zeros) moved by seeded
noise, so a misplaced one shows; they are carried over by
``lm_params_from_reference``. Tokens are drawn with numpy from a seed.
The reference runs eagerly in its own package.

Tolerances. Float32: rtol/atol 1e-4 on ``forward``'s logits and aux
loss, ``prefill``'s last logits and cache, four teacher-forced
``decode_step``s (logits and the cache after them) and ``loss_fn``; the
attention functions, MLA with and without ``q_lora``, and ``_moe_ffn`` on
identical inputs at a capacity that drops assignments, at the same
tolerance (``_moe_ffn`` in bfloat16: within 2x the reference's own error
against its float32 run). Bfloat16 whole-model parity is in
``test_torch_lm_bf16.py``. The reference runs jitted, function by
function, in its own package.
"""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as ref_configs  # noqa: E402
from repro.kernels.flash_attention import \
    flash_attention as ref_flash  # noqa: E402
from repro.models import transformer as J  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
LM_ARCHS = ["qwen2-7b", "qwen3-8b", "yi-34b", "deepseek-v2-lite-16b",
            "deepseek-v2-236b"]
B, S, S0 = 2, 12, 8  # batch, tokens, prefill length (then S - S0 decodes)
_DT = {"float32": (jnp.float32, torch.float32),
       "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _cfgs(name, dtype):
    jdt, tdt = _DT[dtype]
    ref = dataclasses.replace(ref_configs.get_arch(name).smoke(), dtype=jdt)
    port = dataclasses.replace(configs.get_arch(name).smoke(), dtype=tdt)
    return ref, port


def _noisy_tree(cfg, seed=0):
    """The reference's init as float32 numpy, its constant leaves (norm
    scales 1, biases 0) moved by ``0.1 * normal`` noise."""
    rng = np.random.default_rng(seed)
    tree = jax.tree_util.tree_map(
        lambda x: np.array(x, dtype=np.float32),
        J.init_params(cfg, jax.random.PRNGKey(0)))

    def move(path, x):
        name = jax.tree_util.keystr(path)
        if any(t in name for t in ("ln", "norm", "b_q", "b_k", "b_v")):
            return x + 0.1 * rng.standard_normal(x.shape).astype(np.float32)
        return x
    return jax.tree_util.tree_map_with_path(move, tree)


def _ref_params(tree, cfg):
    """The numpy tree as the reference's params in its dtypes (the router
    float32)."""
    def cast(path, x):
        name = jax.tree_util.keystr(path)
        return jnp.asarray(x, jnp.float32 if "router" in name else cfg.dtype)
    return jax.tree_util.tree_map_with_path(cast, tree)


def _tokens(vocab, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(
        np.int32)


def _np(x):
    return np.array(jnp.asarray(x, jnp.float32))


def _t(x):
    return x.detach().float().numpy()


def _widen_ref(cache, max_seq):
    out = dict(cache)
    for k in cache:
        if k == "length":
            continue
        widths = [(0, 0)] * cache[k].ndim
        widths[2] = (0, max_seq - cache[k].shape[2])
        out[k] = jnp.pad(cache[k], widths)
    return out


def _run_ref(cfg, params, toks):
    """forward, loss, prefill + teacher-forced decode of the reference
    (each function jitted, as the reference's launchers run them)."""
    fwd = jax.jit(lambda p, t: J.forward(cfg, p, t))
    loss_fn = jax.jit(lambda p, t, y: J.loss_fn(cfg, p, t, y))
    pre_fn = jax.jit(lambda p, t: J.prefill(cfg, p, t))
    step = jax.jit(lambda p, c, t: J.decode_step(cfg, p, c, t))
    logits, aux = fwd(params, jnp.asarray(toks))
    loss = loss_fn(params, jnp.asarray(toks[:, :-1]),
                   jnp.asarray(toks[:, 1:]))
    last, cache = pre_fn(params, jnp.asarray(toks[:, :S0]))
    pre = {k: _np(v) for k, v in cache.items() if k != "length"}
    cache = _widen_ref(cache, S)
    dec = []
    for i in range(S0, S):
        lg, cache = step(params, cache, jnp.asarray(toks[:, i]))
        dec.append(_np(lg))
    return dict(logits=_np(logits), aux=float(aux), loss=float(loss),
                last=_np(last), pre=pre, dec=np.stack(dec, 1),
                cache={k: _np(v) for k, v in cache.items() if k != "length"},
                length=int(cache["length"]))


def _run_port(cfg, model, toks):
    t = torch.from_numpy(toks)
    with torch.no_grad():
        logits, aux = T.forward(cfg, model, t)
        loss = T.loss_fn(cfg, model, t[:, :-1], t[:, 1:])
        last, cache = T.prefill(cfg, model, t[:, :S0])
        pre = {k: _t(v) for k, v in cache.items() if k != "length"}
        cache = T.widen_cache(cache, S)
        dec = []
        for i in range(S0, S):
            lg, cache = T.decode_step(cfg, model, cache, t[:, i])
            dec.append(_t(lg))
    return dict(logits=_t(logits), aux=float(aux), loss=float(loss),
                last=_t(last), pre=pre, dec=np.stack(dec, 1),
                cache={k: _t(v) for k, v in cache.items() if k != "length"},
                length=int(cache["length"]))


@pytest.fixture(scope="module")
def runs():
    """Per arch: the (noisy) reference parameters as numpy, the tokens and
    the reference's float32 run."""
    out = {}
    for name in LM_ARCHS:
        r32, _ = _cfgs(name, "float32")
        tree = _noisy_tree(r32)
        toks = _tokens(r32.vocab)
        out[name] = dict(tree=tree, toks=toks,
                         f32=_run_ref(r32, _ref_params(tree, r32), toks))
    return out


def _bf16_tree(tree):
    """``tree`` rounded to bfloat16 (the router kept float32), as float32
    numpy."""
    def rnd(path, x):
        if "router" in jax.tree_util.keystr(path):
            return x
        return np.array(jnp.asarray(x, jnp.bfloat16), np.float32)
    return jax.tree_util.tree_map_with_path(rnd, tree)


def _rel(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.mark.parametrize("name", LM_ARCHS)
def test_float32_matches_reference(runs, name):
    ref = runs[name]["f32"]
    _, cfg = _cfgs(name, "float32")
    model = T.lm_params_from_reference(runs[name]["tree"], cfg, "cpu")
    got = _run_port(cfg, model, runs[name]["toks"])
    for key in ("logits", "last", "dec"):
        np.testing.assert_allclose(got[key], ref[key], **TOL, err_msg=key)
    for key in ("aux", "loss"):
        np.testing.assert_allclose(got[key], ref[key], **TOL, err_msg=key)
    assert (cfg.moe is not None) == (ref["aux"] > 0)
    for part in ("pre", "cache"):
        assert got[part].keys() == ref[part].keys()
        for k in ref[part]:
            np.testing.assert_allclose(got[part][k], ref[part][k], **TOL,
                                       err_msg=f"{part}.{k}")
    assert got["length"] == ref["length"] == S


def test_loaded_parameters_keep_names_shapes_and_values(runs):
    tree = runs["deepseek-v2-236b"]["tree"]
    _, cfg = _cfgs("deepseek-v2-236b", "float32")
    model = T.lm_params_from_reference(tree, cfg, "cpu")
    names = {n for n, _ in model.layers.named_parameters()}
    assert names == set(tree["layers"])
    assert {"w_dq", "q_ln"} <= names  # q_lora
    for n, p in model.layers.named_parameters():
        np.testing.assert_array_equal(_t(p), tree["layers"][n])
    assert model.layers.router.dtype == torch.float32
    with pytest.raises(ValueError, match="shape"):
        bad = dict(tree, embed=tree["embed"][:-1])
        T.lm_params_from_reference(bad, cfg, "cpu")


def test_init_params_laws():
    """The reference's laws: normal / sqrt(fan_in) (std checked), ones
    for the norms, zeros for the biases, float32 router, stacked
    ``[L, ...]`` with the reference's shapes."""
    for name in LM_ARCHS:
        rcfg, cfg = _cfgs(name, "float32")
        ref = J.init_params(rcfg, jax.random.PRNGKey(0))
        model = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        for n, p in model.layers.named_parameters():
            assert tuple(p.shape) == tuple(ref["layers"][n].shape), n
        assert tuple(model.embed.shape) == ref["embed"].shape
        assert sum(p.numel() for p in model.parameters()) == sum(
            x.size for x in jax.tree_util.tree_leaves(ref))
    cfg = dataclasses.replace(configs.get_arch("qwen2-7b").smoke(),
                              d_model=256, d_ff=512)
    model = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert model.layers.w_q.dtype == torch.bfloat16
    w = model.layers.w_gate.float()
    assert abs(float(w.std()) * 256 ** 0.5 - 1) < 0.02
    assert bool((model.layers.ln_attn == 1).all())
    assert bool((model.layers.b_q == 0).all())
    again = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert torch.equal(again.layers.w_q, model.layers.w_q)


# -- attention -----------------------------------------------------------------

def _qkv(b=2, s=64, h=8, hkv=2, d=32, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, s, n, d)).astype(np.float32)
            for n in (h, hkv, hkv)]


@pytest.mark.parametrize("causal", [True, False])
def test_attend_chunked_matches_reference(causal):
    q, k, v = _qkv()
    want = _np(J._attend_chunked(*map(jnp.asarray, (q, k, v)), causal,
                                 chunk=16))
    got = T._attend_chunked(*map(torch.from_numpy, (q, k, v)), causal,
                            chunk=16)
    np.testing.assert_allclose(_t(got), want, **TOL)
    dense = T._attend(*map(torch.from_numpy, (q, k, v)), causal)
    np.testing.assert_allclose(_t(dense), want, rtol=2e-5, atol=2e-5)


def test_attend_with_offset_matches_reference():
    q, k, v = _qkv(s=16)
    kk, vv = _qkv(s=40, seed=1)[1:]
    want = _np(J._attend(jnp.asarray(q), jnp.asarray(kk), jnp.asarray(vv),
                         True, q_offset=24))
    got = T._attend(torch.from_numpy(q), torch.from_numpy(kk),
                    torch.from_numpy(vv), True, q_offset=24)
    np.testing.assert_allclose(_t(got), want, **TOL)


@pytest.mark.parametrize("d", [64, 128])
def test_kernel_route_on_cpu_tensors(d):
    """The kernel route (``_attend_kernel``: ``flash_attention`` on
    ``[B, H, S, D]``, here its plain version) against the reference's
    ``_attend`` and its Pallas ``flash_attention`` in interpret mode,
    float32 at rtol/atol 1e-4 and bfloat16 at 2e-2."""
    q, k, v = _qkv(b=1, s=64, h=4, hkv=2, d=d)
    for jdt, tdt, tol in ((jnp.float32, torch.float32, 1e-4),
                          (jnp.bfloat16, torch.bfloat16, 2e-2)):
        jq, jk, jv = (jnp.asarray(x, jdt) for x in (q, k, v))
        want = _np(J._attend(jq, jk, jv, True))
        pallas = _np(ref_flash(*(x.transpose(0, 2, 1, 3) for x in
                                 (jq, jk, jv)), causal=True, block_q=32,
                               block_k=32, interpret=True)
                     .transpose(0, 2, 1, 3))
        tq, tk, tv = (torch.from_numpy(x).to(tdt) for x in (q, k, v))
        got = T._attend_kernel(tq, tk, tv)
        assert got.shape == tq.shape and got.dtype == tdt
        np.testing.assert_allclose(_t(got), want, rtol=tol, atol=tol)
        np.testing.assert_allclose(_t(got), pallas, rtol=tol, atol=tol)


def test_attend_refuses_what_the_kernel_does_not_compute():
    q, k, v = map(torch.from_numpy, _qkv(s=8))
    with pytest.raises(ValueError, match="causal attention from position 0"):
        T._attend(q, k, v, causal=False, kernel_backend="cuda")
    with pytest.raises(ValueError, match="causal attention from position 0"):
        T._attend(q, k, v, causal=True, q_offset=3, kernel_backend="cuda")


# -- MLA and MoE layers ----------------------------------------------------------

@pytest.mark.parametrize("name", ["deepseek-v2-lite-16b", "deepseek-v2-236b"])
def test_mla_attention_matches_reference(runs, name):
    """``_mla_q`` / ``_mla_latent`` / ``_mla_attend`` on layer 0, with and
    without ``q_lora``, float32 at 1e-4, and at an offset."""
    rcfg, cfg = _cfgs(name, "float32")
    tree = runs[name]["tree"]
    rlp = {k: jnp.asarray(v[0]) for k, v in tree["layers"].items()}
    model = T.lm_params_from_reference(tree, cfg, "cpu")
    lp = T._layer(model, 0)
    x = np.random.default_rng(3).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)
    pos = np.arange(S)[None] + 5
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    jq = J._mla_q(rcfg, rlp, jx, jnp.asarray(pos))
    jc, jr = J._mla_latent(rcfg, rlp, jx, jnp.asarray(pos))
    tq = T._mla_q(cfg, lp, tx, torch.from_numpy(pos))
    tc, tr = T._mla_latent(cfg, lp, tx, torch.from_numpy(pos))
    for g, w in ((tq, jq), (tc, jc), (tr, jr)):
        np.testing.assert_allclose(_t(g), _np(w), **TOL)
    for off in (0, 4):
        want = J._mla_attend(rcfg, rlp, jq[:, off:], jc, jr, True, off)
        got = T._mla_attend(cfg, lp, tq[:, off:], tc, tr, True, off)
        np.testing.assert_allclose(_t(got), _np(want), **TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("capacity_factor", [0.5, 1.25])
def test_moe_ffn_matches_reference(runs, dtype, capacity_factor):
    """``_moe_ffn`` on layer 0 of the lite config on identical inputs, at
    a capacity that drops assignments (0.5) and the config's own: float32
    at rtol/atol 1e-4, bfloat16 within 2x the reference's own bf16 error
    against its float32 run; the aux loss at 1e-4 either way (its gates
    are float32)."""
    name = "deepseek-v2-lite-16b"
    rcfg, cfg = _cfgs(name, dtype)
    moe = dataclasses.replace(cfg.moe, capacity_factor=capacity_factor)
    rcfg = dataclasses.replace(rcfg, moe=dataclasses.replace(
        rcfg.moe, capacity_factor=capacity_factor))
    cfg = dataclasses.replace(cfg, moe=moe)
    tree = _bf16_tree(runs[name]["tree"])
    rlp = _ref_params({k: v[0] for k, v in tree["layers"].items()}, rcfg)
    rlp32 = _ref_params({k: v[0] for k, v in tree["layers"].items()},
                        dataclasses.replace(rcfg, dtype=jnp.float32))
    model = T.lm_params_from_reference(tree, cfg, "cpu")
    x = np.random.default_rng(4).standard_normal(
        (B, 32, cfg.d_model)).astype(np.float32)
    jx = jnp.asarray(x, rcfg.dtype)
    x32 = _np(jx)
    want, want_aux = J._moe_ffn(rcfg, rlp, jx)
    got, got_aux = T._moe_ffn(cfg, T._layer(model, 0),
                              torch.from_numpy(x32).to(cfg.dtype))
    t = B * 32
    cap = int(capacity_factor * moe.top_k * t / moe.n_routed) + 1
    if capacity_factor < 1:
        assert cap * moe.n_routed < t * moe.top_k  # assignments dropped
    np.testing.assert_allclose(float(got_aux), float(want_aux), **TOL)
    if dtype == "float32":
        np.testing.assert_allclose(_t(got), _np(want), **TOL)
    else:
        truth, _ = J._moe_ffn(dataclasses.replace(rcfg, dtype=jnp.float32),
                              rlp32, jnp.asarray(x32))
        ref_err = _rel(_np(want), _np(truth))
        assert 0 < ref_err < 0.1
        assert _rel(_t(got), _np(truth)) <= 2 * ref_err


def test_top_k_takes_the_lower_index_on_ties():
    x = torch.tensor([[0.1, 0.3, 0.3, 0.2, 0.3]])
    vals, idx = T._top_k(x, 3)
    jv, ji = jax.lax.top_k(jnp.asarray(x.numpy()), 3)
    assert idx.tolist() == np.asarray(ji).tolist() == [[1, 2, 4]]
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))


# -- the KV cache ----------------------------------------------------------------

@pytest.mark.parametrize("name", ["qwen2-7b", "deepseek-v2-lite-16b"])
def test_decode_past_the_cache_end_clamps_like_the_reference(runs, name):
    """A decode at ``length`` = the cache's size writes the last slot (XLA
    clamps ``dynamic_update_slice``'s start), with every key visible:
    logits and cache as the reference's."""
    rcfg, cfg = _cfgs(name, "float32")
    tree, toks = runs[name]["tree"], runs[name]["toks"]
    rp = _ref_params(tree, rcfg)
    model = T.lm_params_from_reference(tree, cfg, "cpu")
    _, rc = J.prefill(rcfg, rp, jnp.asarray(toks[:, :S0]))
    with torch.no_grad():
        _, tc = T.prefill(cfg, model, torch.from_numpy(toks[:, :S0]))
        for _ in range(2):
            rl, rc = J.decode_step(rcfg, rp, rc, jnp.asarray(toks[:, S0]))
            tl, tc = T.decode_step(cfg, model, tc, torch.from_numpy(
                toks[:, S0]))
            np.testing.assert_allclose(_t(tl), _np(rl), **TOL)
    assert int(tc["length"]) == int(rc["length"]) == S0 + 2
    for k in rc:
        if k != "length":
            np.testing.assert_allclose(_t(tc[k]), _np(rc[k]), **TOL)


def test_decode_writes_the_cache_in_place():
    _, cfg = _cfgs("qwen2-7b", "float32")
    model = T.init_params(cfg, device="cpu")
    cache = T.init_cache(cfg, 1, 4, device="cpu")
    k0 = cache["k"]
    assert cache["length"].dtype == torch.int32 and cache["length"].dim() == 0
    with torch.no_grad():
        _, out = T.decode_step(cfg, model, cache, torch.tensor([3]))
    assert out is cache and out["k"] is k0
    assert int(out["length"]) == 1
    assert bool(k0[:, :, 0].abs().sum(-1).gt(0).all())
    assert bool((k0[:, :, 1:] == 0).all())


# -- kernel_backend resolution ---------------------------------------------------

def test_kernel_backend_resolution():
    full = configs.get_arch("qwen2-7b").full()
    smoke = configs.get_arch("qwen2-7b").smoke()
    mla = configs.get_arch("deepseek-v2-lite-16b").full()
    assert T.kernel_takes(full)
    assert T.kernel_takes(dataclasses.replace(full, dtype=torch.float32))
    assert not T.kernel_takes(dataclasses.replace(full, dtype=torch.float16))
    assert not T.kernel_takes(smoke)  # d_head 16
    assert not T.kernel_takes(mla)  # MLA's absorbed attention
    for cfg in (full, smoke, mla):
        assert T.resolve_kernel_backend(cfg, "cpu") == "torch"
        assert T.resolve_kernel_backend(cfg, "cpu", "torch") == "torch"
        with pytest.raises(ValueError, match="needs a CUDA device"):
            T.resolve_kernel_backend(cfg, "cpu", "cuda")
    assert T.resolve_kernel_backend(full, "cuda") == "cuda"
    assert T.resolve_kernel_backend(smoke, "cuda") == "torch"
    assert T.resolve_kernel_backend(mla, "cuda") == "torch"
    for cfg in (smoke, mla):
        with pytest.raises(ValueError, match="attention kernel takes GQA"):
            T.resolve_kernel_backend(cfg, "cuda", "cuda")
    with pytest.raises(ValueError, match="unknown kernel_backend"):
        T.resolve_kernel_backend(full, "cpu", "pallas")


def test_cuda_backend_on_the_cpu_raises_at_every_entry_point():
    _, cfg = _cfgs("qwen2-7b", "float32")
    model = T.init_params(cfg, device="cpu", kernel_backend="cuda")
    toks = torch.zeros((1, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="needs a CUDA device"):
        model(toks)
    for fn in (T.forward, T.prefill):
        with pytest.raises(ValueError, match="needs a CUDA device"):
            fn(cfg, model, toks, "cuda")
    with pytest.raises(ValueError, match="needs a CUDA device"):
        T.loss_fn(cfg, model, toks, toks, "cuda")
    assert T.init_params(cfg, device="cpu").kernel_backend == "torch"


def test_sharding_pins_raise():
    """The pins are accepted and change nothing on plain tensors; on
    DTensor parameters a pin naming an axis the mesh lacks raises. The
    sharded paths' values: 4 gloo ranks in
    ``tests/test_torch_sharded_models_ranks.py``."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel.sharding import lm_param_specs, shard_params

    cfg = dataclasses.replace(configs.get_arch("qwen2-7b").smoke(),
                              dtype=torch.float32)
    pinned = dataclasses.replace(cfg, batch_axes="data", tp_axis="model")
    model = T.init_params(cfg, device="cpu")
    toks = torch.arange(8, dtype=torch.int32).reshape(2, 4)
    want, _ = T.forward(cfg, model, toks, "torch")
    got, _ = T.forward(pinned, model, toks, "torch")
    assert torch.equal(got, want)
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=4)
    try:
        mesh = make_mesh((2, 2), ("data", "model"))
        sharded = shard_params(model.converted(), lm_param_specs(cfg), mesh)
        with pytest.raises(ValueError, match="no axis 'pod'"):
            T.forward(dataclasses.replace(pinned, batch_axes=("pod", "data")),
                      sharded, toks, "torch")
    finally:
        dist.destroy_process_group()


def test_converted_copies_and_cuts_layers():
    _, cfg = _cfgs("deepseek-v2-lite-16b", "float32")
    model = T.init_params(cfg, device="cpu")
    cut = model.converted(dtype=torch.bfloat16, n_layers=1)
    assert cut.cfg.n_layers == 1 and cut.cfg.dtype == torch.bfloat16
    assert cut.layers.w_uk.shape[0] == 1
    assert cut.layers.router.dtype == torch.float32
    assert torch.equal(cut.layers.w_uk[0], model.layers.w_uk[0].bfloat16())
    assert cut.embed.data_ptr() != model.embed.data_ptr()
