"""The LM stack's data and configs: ``repro_torch.data.lm`` against the
reference's ``data/lm.py`` bit for bit, and the five LM configs against
the reference's field for field (``dtype`` compared by name), with
``n_params`` / ``n_active_params`` equal at ``full()`` and ``smoke()``,
and the registry listing them in the reference's order."""
import dataclasses
import itertools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as ref_configs  # noqa: E402
from repro.data.lm import synthetic_lm_batches as ref_batches  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.data import synthetic_lm_batches  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

LM_ARCHS = ["deepseek-v2-236b", "deepseek-v2-lite-16b", "yi-34b",
            "qwen3-8b", "qwen2-7b"]
# the reference's n_params at full(), as its dry-run reports them
N_PARAMS = {"qwen2-7b": 7_615_487_488}


@pytest.mark.parametrize("vocab,batch,seq,seed,host_id,n_hosts", [
    (256, 2, 64, 0, 0, 1),
    (1000, 4, 17, 3, 1, 2),
    (152064, 8, 32, 7, 3, 4),
])
def test_synthetic_lm_batches_bit_for_bit(vocab, batch, seq, seed, host_id,
                                          n_hosts):
    a = synthetic_lm_batches(vocab, batch, seq, seed, host_id, n_hosts)
    b = ref_batches(vocab, batch, seq, seed, host_id, n_hosts)
    for (ta, ya), (tb, yb) in itertools.islice(zip(a, b), 3):
        assert ta.dtype == tb.dtype == np.int32
        assert ta.shape == (batch // n_hosts, seq)
        np.testing.assert_array_equal(ta, tb)
        np.testing.assert_array_equal(ya, yb)
        np.testing.assert_array_equal(ta[:, 1:], ya[:, :-1])


def test_synthetic_lm_batches_refuses_an_uneven_split():
    with pytest.raises(AssertionError):
        next(synthetic_lm_batches(16, 3, 4, n_hosts=2))


def _dtype_name(dt):
    return {jnp.float32: "float32", torch.float32: "float32",
            jnp.bfloat16: "bfloat16", torch.bfloat16: "bfloat16"}[dt]


def _fields(cfg):
    out = dataclasses.asdict(cfg)
    out["dtype"] = _dtype_name(out["dtype"])
    return out


@pytest.mark.parametrize("size", ["full", "smoke"])
@pytest.mark.parametrize("name", LM_ARCHS)
def test_lm_configs_equal_reference(name, size):
    a, b = configs.get_arch(name), ref_configs.get_arch(name)
    assert a.FAMILY == b.FAMILY == "lm"
    for cells in ("SHAPES", "SHAPES_SMOKE"):
        assert [dataclasses.astuple(c) for c in getattr(a, cells)] == [
            dataclasses.astuple(c) for c in getattr(b, cells)]
    ca, cb = getattr(a, size)(), getattr(b, size)()
    assert type(ca).__module__ == "repro_torch.models.transformer"
    assert _fields(ca) == _fields(cb)
    assert ca.dtype == torch.bfloat16
    assert ca.n_params == cb.n_params
    assert ca.n_active_params == cb.n_active_params
    if name in N_PARAMS and size == "full":
        assert ca.n_params == N_PARAMS[name]


def test_config_classes_keep_the_reference_defaults():
    from repro.models import transformer as J
    for ours, ref in ((T.MoEConfig, J.MoEConfig),
                      (T.MLAConfig, J.MLAConfig),
                      (T.LMConfig, J.LMConfig)):
        fa = {f.name: f.default for f in dataclasses.fields(ours)}
        fb = {f.name: f.default for f in dataclasses.fields(ref)}
        assert fa.keys() == fb.keys()
        for k in fa:
            if k == "dtype":
                assert _dtype_name(fa[k]) == _dtype_name(fb[k])
            else:
                assert fa[k] == fb[k], k


def test_lm_shape_cells_equal_reference():
    from repro.configs import common as ref_common

    from repro_torch.configs import common
    for cells in ("LM_SHAPES", "LM_SHAPES_SMOKE"):
        assert [dataclasses.astuple(c) for c in getattr(common, cells)] == [
            dataclasses.astuple(c) for c in getattr(ref_common, cells)]


def test_registry_lists_the_lm_archs_in_the_reference_order():
    assert configs.arch_names()[:5] == LM_ARCHS
    assert configs.arch_names(True) == ref_configs.arch_names(True)
    for name in LM_ARCHS:
        assert configs.get_arch(name).__name__ == (
            "repro_torch.configs." + name.replace("-", "_"))
