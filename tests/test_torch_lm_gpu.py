"""The LM stack on the card: qwen2-7b and qwen3-8b (its ``qk_norm``
scales at ``d_head`` = 128) at ``full()`` width cut to 2 layers, random
weights drawn on the card (seed 0), a 1 x 256 prompt.

* The kernel path (``kernel_backend="cuda"``) launches
  ``flash_attention[causal,bf16,d128]`` once a layer a prefill or
  forward, the plain path (``"torch"``) and every decode step none, and
  ``None`` resolves to the kernel path.
* bfloat16: the kernel path's relative L2 error against the plain path
  on a float32 copy (last logits, each layer's K and V) is at most 1.5x
  the plain bf16 path's.
* float32 (the f32 kernel): the card's kernel path against the same
  module's plain path on the CPU, relative L2 at most 1e-4 (TF32 off).
* teacher-forced decode after a kernel prefill: 4 ``decode_step``s
  against ``forward``'s logits at those positions, within 3x the bf16
  forward's own error against float32.

Every test carries the ``gpu`` marker and skips without a CUDA device;
the module imports neither jax nor the reference package."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.kernels import flash_attention as FA
from repro_torch.models import transformer as T

pytestmark = pytest.mark.gpu

LAYERS, PROMPT, STEPS = 2, 256, 4
KEY = FA.launch_key(True, torch.bfloat16, 128)
KEY32 = FA.launch_key(True, torch.float32, 128)


@pytest.fixture(autouse=True)
def _card_no_tf32():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the card's kernel path is the test")
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = old


@pytest.fixture(scope="module", params=["qwen2-7b", "qwen3-8b"])
def model(request):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the card's kernel path is the test")
    cfg = dataclasses.replace(configs.get_arch(request.param).full(),
                              n_layers=LAYERS)
    with torch.no_grad():
        return T.init_params(cfg, torch.Generator("cuda").manual_seed(0),
                             device="cuda")


@pytest.fixture(scope="module")
def toks():
    rng = np.random.default_rng(0)
    t = rng.integers(0, 151936, (1, PROMPT + STEPS)).astype(np.int32)
    return torch.from_numpy(t)


def _rel(got, want):
    g, w = got.double(), want.to(got.device).double()
    return float((g - w).norm() / w.norm())


def _errors(out, want):
    (last, cache), (last_w, cache_w) = out, want
    errs = [_rel(last, last_w)]
    for i in range(cache_w["k"].shape[0]):
        errs.append(_rel(torch.cat([cache["k"][i], cache["v"][i]]),
                         torch.cat([cache_w["k"][i], cache_w["v"][i]])))
    return errs


def test_kernel_launches_once_a_layer(model, toks):
    assert model.kernel_backend == "cuda"
    p = toks[:, :PROMPT].cuda()
    with torch.no_grad():
        FA.reset_launches()
        model.prefill(p)
        assert FA.LAUNCHES[KEY] == LAYERS
        T.forward(model.cfg, model, p, "cuda")
        assert FA.LAUNCHES[KEY] == 2 * LAYERS
        _, cache = T.prefill(model.cfg, model, p, "torch")
        T.forward(model.cfg, model, p, "torch")
        cache = T.widen_cache(cache, PROMPT + 1)
        T.decode_step(model.cfg, model, cache, p[:, -1])
    assert FA.LAUNCHES[KEY] == 2 * LAYERS
    assert sum(FA.LAUNCHES.values()) == 2 * LAYERS


def test_bf16_kernel_path_within_the_plain_path_error(model, toks):
    p = toks[:, :PROMPT].cuda()
    with torch.no_grad():
        kern = T.prefill(model.cfg, model, p, "cuda")
        plain = T.prefill(model.cfg, model, p, "torch")
        m32 = model.converted(torch.float32)
        want = T.prefill(m32.cfg, m32, p, "torch")
    ek, ep = _errors(kern, want), _errors(plain, want)
    assert all(0 < e < 0.1 for e in ep)
    for e, y in zip(ek, ep):
        assert e <= 1.5 * y, (ek, ep)


def test_float32_card_matches_the_cpu(model, toks):
    p = toks[:, :PROMPT]
    with torch.no_grad():
        m32 = model.converted(torch.float32)
        assert m32.kernel_backend == "cuda"
        FA.reset_launches()
        card = m32.prefill(p.cuda())
        assert FA.LAUNCHES[KEY32] == LAYERS
        cpu = m32.converted(device="cpu")
        assert cpu.kernel_backend == "torch"
        want = cpu.prefill(p)
    assert max(_errors(card, want)) <= 1e-4


def test_teacher_forced_decode_after_the_kernel_prefill(model, toks):
    t = toks.cuda()
    with torch.no_grad():
        _, cache = T.prefill(model.cfg, model, t[:, :PROMPT], "cuda")
        fwd, _ = T.forward(model.cfg, model, t, "cuda")
        m32 = model.converted(torch.float32)
        want, _ = T.forward(m32.cfg, m32, t, "torch")
        cache = T.widen_cache(cache, PROMPT + STEPS)
        dec = []
        for i in range(STEPS):
            lg, cache = T.decode_step(model.cfg, model, cache,
                                      t[:, PROMPT + i])
            dec.append(lg[0])
    dec = torch.stack(dec)
    fwd, want = fwd[0, PROMPT:], want[0, PROMPT:]
    assert int(cache["length"]) == PROMPT + STEPS
    assert _rel(dec, fwd) <= 3 * _rel(fwd, want)
