"""Training on the card: one step of the port's training loop on a CUDA
device against the same step on the CPU, from the same weights and
batch, TF32 off.

* qwen2-7b's ``smoke()`` config in float32 (2 micro-batches: the float32
  accumulation buffers on the card) and PNA's ``smoke()`` cell: loss at
  rtol 1e-5 (PNA 1e-4), grad norm at 1e-4, the moments at rtol 1e-4 /
  atol 1e-6, the update elementwise at ``1e-3 * lr`` where the CPU's
  gradient is at least 1e-6 and within ``2 * lr`` everywhere: AdamW's
  first step is ``g / (|g| + 1e-8)``, so a gradient near 1e-8 takes its
  direction from its last bits, which differ between cuBLAS and the
  CPU's GEMMs (``tests/test_torch_steps.py`` holds the port to the
  reference the same way).
* Training never launches kernel h: ``flash_attention.LAUNCHES`` is
  unchanged by an LM training step, though ``None`` resolves to the
  kernel for serving the same config on the card.
* ``loss_fn(kernel_backend="cuda")`` on trainable parameters raises
  (the kernel is forward-only); under ``torch.no_grad()`` it launches.

Every test carries the ``gpu`` marker and skips without a CUDA device;
the module imports neither jax nor the reference package."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.kernels import flash_attention as FA
from repro_torch.launch.steps import _lm_train_step, build_cell
from repro_torch.models import transformer as T
from repro_torch.optim.adamw import adamw_init
from repro_torch.optim.params import named
from repro_torch.train.loop import TrainConfig, make_train_step

pytestmark = pytest.mark.gpu
TOL = dict(rtol=1e-4, atol=1e-6)


@pytest.fixture(autouse=True)
def _card_no_tf32():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: training on the card is the test")
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = old


def _cfg(dtype=torch.float32, d_head=None):
    cfg = configs.get_arch("qwen2-7b").smoke()
    upd = dict(dtype=dtype)
    if d_head:
        upd.update(d_head=d_head)
    return dataclasses.replace(cfg, **upd)


def _close(a, b, what):
    np.testing.assert_allclose(a.detach().float().cpu().numpy(),
                               b.detach().float().cpu().numpy(), **TOL,
                               err_msg=what)


def _lm_step(cfg, device, tokens):
    """One step from ``init_params``' CPU draws, on ``device``."""
    model = T.init_params(cfg, device="cpu").converted(device=device)
    state = adamw_init(model)

    def lf(p, t, y):
        return T.loss_fn(cfg, p, t, y, kernel_backend="torch")

    step = make_train_step(lf, TrainConfig(lr=1e-2, warmup=0,
                                           micro_batches=2))
    t = tokens.to(device)
    _, _, met = step(model, state, 0, t[:, :-1], t[:, 1:])
    return model, state, met


def test_lm_train_step_card_matches_cpu():
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (4, 33)).astype(np.int32))
    cfg = _cfg()
    old = {k: t.detach().clone()
           for k, t in named(T.init_params(cfg, device="cpu")).items()}
    gm, gs, gmet = _lm_step(cfg, "cuda", toks)
    cm, cs, cmet = _lm_step(cfg, "cpu", toks)
    assert gm.embed.device.type == "cuda"
    for k in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(gmet[k]), float(cmet[k]),
                                   rtol=1e-5)
    lr = float(cmet["lr"])
    for k, t in named(gm).items():
        _close(gs["m"][k], cs["m"][k], f"m {k}")
        _close(gs["v"][k], cs["v"][k], f"v {k}")
        upd = t.detach().cpu() - old[k]
        upd_cpu = named(cm)[k].detach() - old[k]
        big = (cs["m"][k] / 0.1).abs() >= 1e-6  # m = (1 - b1) g, step 1
        np.testing.assert_allclose(upd[big].numpy(), upd_cpu[big].numpy(),
                                   rtol=0, atol=1e-3 * lr, err_msg=k)
        assert float((upd - upd_cpu).abs().max()) <= 2 * lr, k


def test_pna_train_cell_card_matches_cpu():
    outs = {}
    for dev in ("cuda", "cpu"):
        prog = build_cell("pna", "full_graph_sm", smoke=True, device=dev)
        inputs = prog.concrete_inputs(0)
        if dev == "cuda":  # the CPU's weights, so only the device differs
            ref = build_cell("pna", "full_graph_sm", smoke=True,
                             device="cpu").concrete_inputs(0)[0]
            with torch.no_grad():
                for k, t in named(inputs[0]).items():
                    t.copy_(named(ref)[k])
        outs[dev] = prog.fn(*inputs)
    (gp, gs, gmet), (cp, cs, cmet) = outs["cuda"], outs["cpu"]
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(gmet[k]), float(cmet[k]),
                                   rtol=1e-4)
    for k, t in named(gp).items():
        _close(gs["m"][k], cs["m"][k], f"m {k}")


def test_training_never_launches_the_attention_kernel():
    cfg = _cfg(torch.bfloat16, d_head=128)
    model = T.init_params(cfg, torch.Generator("cuda").manual_seed(0),
                          device="cuda")
    assert model.kernel_backend == "cuda"  # serving would take kernel h
    before = dict(FA.LAUNCHES)
    toks = torch.randint(0, cfg.vocab, (2, 65), device="cuda",
                         dtype=torch.int32)
    # the train cell's step (launch/steps.py) at this config
    _, _, met = _lm_train_step(cfg)(model, adamw_init(model), toks[:, :-1],
                                    toks[:, 1:])
    assert np.isfinite(float(met["loss"])) and float(met["grad_norm"]) > 0
    assert FA.LAUNCHES == before
    with torch.no_grad():  # the serving path still takes the kernel
        model.requires_grad_(False)
        T.forward(cfg, model, toks)
    assert sum(FA.LAUNCHES.values()) == sum(before.values()) + cfg.n_layers


def test_kernel_backend_cuda_on_trainable_parameters_raises():
    cfg = _cfg(torch.bfloat16, d_head=128)
    model = T.init_params(cfg, torch.Generator("cuda").manual_seed(0),
                          device="cuda")
    model.requires_grad_(True)
    toks = torch.randint(0, cfg.vocab, (1, 64), device="cuda",
                         dtype=torch.int32)
    with pytest.raises(RuntimeError, match="forward-only"):
        T.loss_fn(cfg, model, toks, toks, kernel_backend="cuda")
    with torch.no_grad():
        loss = T.loss_fn(cfg, model, toks, toks, kernel_backend="cuda")
    assert torch.isfinite(loss)
