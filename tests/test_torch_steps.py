"""The port's cell programs (``repro_torch.launch.steps``) against the
reference's (``repro.launch.steps``) on the CPU.

* Every arch x smoke shape, as ``tests/test_smoke_archs.py`` runs them
  (40 cases): the meta ``abstract_inputs`` hold the concrete inputs'
  shapes and dtypes, one run of ``fn``, finite outputs.
* One training step held against the reference for each family: the
  reference's own concrete inputs, one reference step taken from them
  (so the optimizer state is non-zero and ``count`` is 1), then the
  weights and state after it carried into the port
  (``tensors_from_reference``, ``adamw_state_from_reference``) and the
  second step taken by both. The GNN batches, labels and DeepFM ids are
  the port's own draws, checked equal to the reference's first.
* The coremaint cells: the port's inputs equal the reference's, and the
  outputs (table, cores, labels) bit for bit.

Tolerances. Float32: loss and grad norm at rtol 1e-4; the moments ``m``
and ``v`` at a relative L2 error of 1e-3 a tensor; the update ``p_new -
p`` elementwise at atol ``1e-3 * lr`` (PNA: ``1e-2 * lr``) where the
reference's gradient is at least 1e-6 in magnitude, and within ``2 *
lr`` everywhere. PNA's float32 output is ill-conditioned at in-degree 0
and 1 (``pna_conditioned_rows``), and its gradients carry that: its
moments read up to 1.1e-4 and its updates up to 3e-3 lr (the others
3.7e-4 lr, the float32 rounding of ``p`` itself). AdamW's direction is
``m_hat / (sqrt(v_hat) + 1e-8)``: where the gradient is ~1e-8 its sign
and size decide the step, and there the two packages' float32 gradients
differ (XLA fuses and orders the reductions differently; the port's
clip sums the leaves in its own order), so that is a different number
of operations, not a wider bound. qwen2-7b in its own bfloat16: each of
those quantities within 2x the reference's own bfloat16 error against
the reference's float32 step from the same (bf16-valued) weights and
state (plus 1e-6 relative, for quantities the reference gets exactly).
deepseek-v2-lite (MLA + MoE) in float32: bf16 MoE flips routes (ROADMAP
watch list).
"""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import arch_names as ref_arch_names  # noqa: E402
from repro.launch import steps as JS  # noqa: E402

from repro_torch.configs import arch_names, get_arch  # noqa: E402
from repro_torch.launch import steps as PS  # noqa: E402
from repro_torch.launch.steps import build_cell, cell_names  # noqa: E402
from repro_torch.optim.adamw import adamw_state_from_reference  # noqa: E402
from repro_torch.optim.params import named, tensors_from_reference  # noqa

ALL = [(a, s) for a in arch_names() for s in cell_names(a, smoke=True)]


def tree_leaves(tree):
    """The tensors of a cell's inputs or outputs, in order: a module's
    parameters, a mapping's values, a dataclass's fields (``GraphBatch``),
    sequences (the maintainers' stats are named tuples); other leaves are
    skipped."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, torch.nn.Module):
        yield from tree.parameters()
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from tree_leaves(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from tree_leaves(v)
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from tree_leaves(getattr(tree, f.name))


def test_registry_matches_reference():
    assert arch_names() == ref_arch_names()
    for a in arch_names(include_coremaint=True):
        assert cell_names(a, smoke=True) == JS.cell_names(a, smoke=True)
        assert cell_names(a) == JS.cell_names(a)
    assert len(ALL) == 40


@pytest.mark.parametrize("arch,shape", ALL)
def test_smoke(arch, shape):
    prog = build_cell(arch, shape, smoke=True, device="cpu")
    inputs = prog.concrete_inputs(0)
    abs_flat = list(tree_leaves(prog.abstract_inputs))
    conc_flat = list(tree_leaves(inputs))
    assert len(abs_flat) == len(conc_flat)
    for a, c in zip(abs_flat, conc_flat):
        assert a.device.type == "meta" and c.device.type == "cpu"
        assert tuple(a.shape) == tuple(c.shape), (prog.name, a.shape,
                                                   c.shape)
        assert a.dtype == c.dtype, (prog.name, a.dtype, c.dtype)
    out = prog.fn(*inputs)
    leaves = list(tree_leaves(out))
    assert leaves
    for leaf in leaves:
        if leaf.is_floating_point():
            assert torch.isfinite(leaf.float()).all(), prog.name


def test_multi_pod_and_the_card_default_raise():
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 E"):
        build_cell("qwen2-7b", "train_4k", smoke=True, multi_pod=True,
                   device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build_cell("pna", "molecule", smoke=True)


def test_full_lm_cells_take_the_streaming_pin(monkeypatch):
    """Non-smoke LM cells run ``attn_chunk=2048`` (meta inputs only: no
    concrete full-size inputs are made here); ``REPRO_NO_PIN`` drops it,
    as in the reference."""
    prog = build_cell("qwen2-7b", "train_4k", device="cpu")
    p_abs = prog.abstract_inputs[0]
    assert p_abs.cfg.attn_chunk == 2048 and p_abs.embed.device.type == "meta"
    assert tuple(prog.abstract_inputs[2].shape) == (256, 4096)
    monkeypatch.setenv("REPRO_NO_PIN", "1")
    prog = build_cell("qwen2-7b", "train_4k", device="cpu")
    assert prog.abstract_inputs[0].cfg.attn_chunk == 0


# ---------------------------------------------------------------------------
# one training step against the reference
# ---------------------------------------------------------------------------
def _np(tree):
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x) if np.asarray(x).dtype.kind in "iub"
        else np.array(jnp.asarray(x, jnp.float32)), tree)


def _carry(ref_params, ref_opt, params):
    """The reference's weights and optimizer state, as numpy, into the
    port's ``params`` (in place) and a new port state."""
    carried = tensors_from_reference(ref_params, params)
    with torch.no_grad():
        for k, t in named(params).items():
            t.copy_(carried[k])
    return adamw_state_from_reference(ref_opt, params)


def _as_port(tree, params):
    return tensors_from_reference(tree, params, torch.float32)


def _rel(got, want):
    den = float(want.norm())
    return float((got - want).norm()) / den if den else float(
        (got - want).norm())


def _lm_cfgs(arch, dtype):
    """The reference's and the port's smoke config of ``arch`` in
    ``dtype``."""
    from repro import configs as ref_configs
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    return (dataclasses.replace(ref_configs.get_arch(arch).smoke(), dtype=jdt),
            dataclasses.replace(get_arch(arch).smoke(), dtype=tdt))


def _first_ref_step(arch, shape):
    """The reference cell's concrete inputs, its first step from them
    ``(params1, opt1)`` and its jitted step."""
    prog = JS.build_cell(arch, shape, smoke=True)
    inputs = prog.concrete_inputs(jax.random.PRNGKey(0))
    step = jax.jit(prog.fn)
    p1, o1, _ = step(*inputs)
    return inputs, (p1, o1), step


def _port_inputs(arch, shape, ref_inputs, lm_cfg=None):
    """The port's cell inputs, the batch held equal to the reference's
    draws (the LM tokens carried: the reference draws them with
    ``jax.random``)."""
    prog = build_cell(arch, shape, smoke=True, device="cpu")
    if lm_cfg is not None:
        from repro_torch.models import transformer as T
        params = T.init_params(lm_cfg, device="cpu")
        toks = [torch.from_numpy(np.array(x)) for x in ref_inputs[2:]]
        return [params, None] + toks
    inputs = list(prog.concrete_inputs(0))
    ref_batch = jax.tree_util.tree_leaves(ref_inputs[2:])
    port_batch = list(tree_leaves(inputs[2:]))
    assert len(ref_batch) == len(port_batch)
    for r, p in zip(ref_batch, port_batch):
        np.testing.assert_array_equal(np.asarray(r), p.numpy())
    return inputs


def _check_f32(step_out, ref_out, ref_in_params, params, lr, grads_ref,
               upd_tol=1e-3):
    _, opt, met = step_out
    rp, ro, rm = ref_out
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(met[k]), float(rm[k]), rtol=1e-4,
                                   atol=1e-6)
    assert int(opt["count"]) == int(ro["count"]) == 2
    m_ref, v_ref = _as_port(ro["m"], params), _as_port(ro["v"], params)
    p_ref, p_old = _as_port(rp, params), _as_port(ref_in_params, params)
    for k, t in named(params).items():
        assert _rel(opt["m"][k], m_ref[k]) <= 1e-3, k
        assert _rel(opt["v"][k], v_ref[k]) <= 1e-3, k
        upd, upd_ref = t.detach().float() - p_old[k], p_ref[k] - p_old[k]
        big = grads_ref[k].abs() >= 1e-6
        np.testing.assert_allclose(upd[big].numpy(), upd_ref[big].numpy(),
                                   rtol=0, atol=upd_tol * lr, err_msg=k)
        assert float((upd - upd_ref).abs().max()) <= 2 * lr, k


def _grads_from_moments(o_before, o_after, params, b1=0.9):
    """The reference's second-step gradient, recovered from its moments:
    ``m2 = b1 m1 + (1 - b1) g``."""
    m1, m2 = _as_port(o_before["m"], params), _as_port(o_after["m"], params)
    return {k: (m2[k] - b1 * m1[k]) / (1 - b1) for k in m1}


GNN_CELLS = [(a, s) for a in ("pna", "gin-tu", "dimenet", "nequip")
             for s in cell_names(a, smoke=True)]


@pytest.mark.parametrize("arch,shape", GNN_CELLS + [("deepfm",
                                                     "train_batch")])
def test_train_step_matches_reference(arch, shape):
    inputs, (p1, o1), step = _first_ref_step(arch, shape)
    ref_out = step(p1, o1, *inputs[2:])
    port = _port_inputs(arch, shape, inputs)
    params = port[0]
    port[1] = _carry(_np(p1), _np(o1), params)
    prog = build_cell(arch, shape, smoke=True, device="cpu")
    out = prog.fn(*port)
    assert out[0] is params  # updated in place
    lr = 1e-3
    grads = _grads_from_moments(_np(o1), _np(ref_out[1]), params)
    _check_f32(out, _np(ref_out), _np(p1), params, lr, grads,
               upd_tol=1e-2 if arch == "pna" else 1e-3)


@pytest.mark.parametrize("arch", ["qwen2-7b", "deepseek-v2-lite-16b"])
def test_lm_train_step_matches_reference_float32(arch):
    jcfg, tcfg = _lm_cfgs(arch, "float32")
    inputs = JS.build_cell(arch, "train_4k", smoke=True).concrete_inputs(
        jax.random.PRNGKey(0))
    p0 = jax.tree_util.tree_map(lambda x: x.astype(jnp.float32), inputs[0])
    step = jax.jit(JS._lm_train_step(jcfg))
    p1, o1, _ = step(p0, inputs[1], *inputs[2:])
    ref_out = step(p1, o1, *inputs[2:])
    port = _port_inputs(arch, "train_4k", inputs, lm_cfg=tcfg)
    params = port[0]
    port[1] = _carry(_np(p1), _np(o1), params)
    out = PS._lm_train_step(tcfg)(*port)
    grads = _grads_from_moments(_np(o1), _np(ref_out[1]), params)
    _check_f32(out, _np(ref_out), _np(p1), params, 1e-4, grads)


def test_lm_train_step_matches_reference_bfloat16():
    """qwen2-7b's smoke config in its own bfloat16, against 2x the
    reference's own error (module docstring)."""
    arch = "qwen2-7b"
    jcfg32, _ = _lm_cfgs(arch, "float32")
    inputs, (p1, o1), step = _first_ref_step(arch, "train_4k")
    ref_out = step(p1, o1, *inputs[2:])  # the reference in bfloat16
    step32 = jax.jit(JS._lm_train_step(jcfg32))
    p1_32 = jax.tree_util.tree_map(lambda x: x.astype(jnp.float32), p1)
    truth = _np(step32(p1_32, o1, *inputs[2:]))
    prog = build_cell(arch, "train_4k", smoke=True, device="cpu")
    port = _port_inputs(arch, "train_4k", inputs,
                        lm_cfg=prog.abstract_inputs[0].cfg)
    params = port[0]
    assert params.embed.dtype == torch.bfloat16
    port[1] = _carry(_np(p1), _np(o1), params)
    _, opt, met = prog.fn(*port)
    ref = _np(ref_out)

    def within(port_err, ref_err, what):
        assert port_err <= 2 * ref_err + 1e-6, (what, port_err, ref_err)

    for k in ("loss", "grad_norm"):
        t = float(truth[2][k])
        within(abs(float(met[k]) - t) / abs(t),
               abs(float(ref[2][k]) - t) / abs(t), k)
    tp, tm, tv = (_as_port(truth[0], params), _as_port(truth[1]["m"], params),
                  _as_port(truth[1]["v"], params))
    rp, rm, rv = (_as_port(ref[0], params), _as_port(ref[1]["m"], params),
                  _as_port(ref[1]["v"], params))
    for k, t in named(params).items():
        within(_rel(t.detach().float(), tp[k]), _rel(rp[k], tp[k]), k)
        within(_rel(opt["m"][k], tm[k]), _rel(rm[k], tm[k]), f"m {k}")
        within(_rel(opt["v"][k], tv[k]), _rel(rv[k], tv[k]), f"v {k}")


@pytest.mark.parametrize("shape", cell_names("coremaint", smoke=True))
def test_coremaint_cells_bit_for_bit(shape):
    ref = JS.build_cell("coremaint", shape, smoke=True)
    ref_in = ref.concrete_inputs(jax.random.PRNGKey(0))
    prog = build_cell("coremaint", shape, smoke=True, device="cpu")
    port_in = prog.concrete_inputs(0)
    assert len(ref_in) == len(port_in)
    for r, p in zip(ref_in, port_in):
        np.testing.assert_array_equal(np.asarray(r), p.numpy())
    want = jax.jit(ref.fn)(*ref_in)
    got = prog.fn(*port_in)
    for r, p in zip(want[:-1], got[:-1]):  # the table, cores, labels
        np.testing.assert_array_equal(np.asarray(r), p.numpy())
    assert want[-1]._fields == got[-1]._fields  # the stats
    for name in got[-1]._fields:
        assert int(getattr(want[-1], name)) == int(getattr(got[-1], name)), \
            name


# ---------------------------------------------------------------------------
# the plain attention and PNA under autograd
# ---------------------------------------------------------------------------
def _attend_out_of_place(q, k, v):
    """The plain attention's arithmetic with no in-place op."""
    import math
    b, s, h, d = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, s, hkv, h // hkv, d).float()
    logits = torch.einsum("bshgd,bthd->bhgst", qg, k.float()) / math.sqrt(d)
    mask = torch.arange(s)[:, None] >= torch.arange(k.shape[1])[None, :]
    probs = torch.softmax(logits.masked_fill(~mask, -1e30), dim=-1)
    out = torch.einsum("bhgst,bthd->bshgd", probs, v.float())
    return out.reshape(b, s, h, v.shape[-1]).to(q.dtype)


@pytest.mark.parametrize("chunk", [0, 4])
def test_plain_attention_gradients_under_autograd(chunk):
    """``_attend`` (``div_`` / ``masked_fill_`` on its scores) and
    ``_attend_chunked`` (its shift copied under a graph) give the
    gradients of the same arithmetic written without an in-place op:
    bit for bit for ``_attend``, at rtol 1e-5 for the streaming form
    (another order of operations)."""
    from repro_torch.models import transformer as T

    g = torch.Generator().manual_seed(0)
    q = torch.randn((2, 8, 4, 16), generator=g)
    k, v = (torch.randn((2, 8, 2, 16), generator=g) for _ in range(2))
    w = torch.randn((2, 8, 4, 16), generator=g)

    def grads(fn):
        ins = [x.clone().requires_grad_(True) for x in (q, k, v)]
        out = fn(*ins)
        return [out.detach()] + list(torch.autograd.grad((out * w).sum(),
                                                         ins))

    if chunk:
        got = grads(lambda a, b, c: T._attend_chunked(a, b, c, True, chunk))
    else:
        got = grads(lambda a, b, c: T._attend(a, b, c, causal=True))
    want = grads(_attend_out_of_place)
    for x, y in zip(got, want):
        if chunk:
            np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=1e-5,
                                       atol=1e-6)
        else:
            assert torch.equal(x, y)


def test_pna_gradients_under_autograd():
    """PNA's max / min fills copy under a graph: its gradient against
    finite differences in float64 on a small batch (degree-0 and -1
    nodes included)."""
    from repro_torch.models import gnn as G

    cfg = G.PNAConfig(n_layers=2, d_hidden=3, d_in=2, n_classes=2)
    model = G.pna_init(cfg, device="cpu").double()
    rng = np.random.default_rng(0)
    n, e = 6, 10
    snd = rng.integers(0, n, e)
    rcv = rng.integers(0, n, e)
    batch = G.GraphBatch.from_numpy(
        1, node_feat=rng.normal(size=(n, 2)), senders=snd, receivers=rcv,
        edge_mask=snd != rcv, node_mask=np.ones(n, bool),
        graph_id=np.zeros(n, np.int64)).to("cpu")
    w = model.layers[0].pre[0].w
    w0 = w.detach().clone()
    out = G.pna_forward(cfg, model.requires_grad_(True), batch)
    (gw,) = torch.autograd.grad(out.sum(), [w])
    eps = 1e-6
    num = torch.zeros_like(w0)
    with torch.no_grad():
        for i in range(w0.numel()):
            d = torch.zeros_like(w0).reshape(-1)
            d[i] = eps
            d = d.reshape(w0.shape)
            w.copy_(w0 + d)
            hi = G.pna_forward(cfg, model, batch).sum()
            w.copy_(w0 - d)
            lo = G.pna_forward(cfg, model, batch).sum()
            num.reshape(-1)[i] = (hi - lo) / (2 * eps)
        w.copy_(w0)
    np.testing.assert_allclose(gw.numpy(), num.numpy(), rtol=1e-5,
                               atol=1e-7)


def test_remat_full_changes_no_value():
    """``remat="full"`` (each layer recomputed in the backward,
    ``torch.utils.checkpoint``) gives the same loss and gradients, bit
    for bit, as the stored forward."""
    from repro_torch.models import transformer as T
    from repro_torch.optim.params import trainable

    cfg = dataclasses.replace(get_arch("qwen2-7b").smoke(),
                              dtype=torch.float32)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 17)).astype(np.int32))
    out = []
    for remat in ("none", "full"):
        c = dataclasses.replace(cfg, remat=remat)
        model = T.init_params(c, device="cpu")
        params = trainable(model)
        loss = T.loss_fn(c, model, toks[:, :-1], toks[:, 1:],
                         kernel_backend="torch")
        out.append([loss.detach()] + list(torch.autograd.grad(
            loss, list(params.values()))))
    for a, b in zip(*out):
        assert torch.equal(a, b)
