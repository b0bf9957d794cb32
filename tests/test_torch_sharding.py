"""The port's sharding rules (``repro_torch.parallel.sharding``) and cell
specs (``launch/steps.py``'s ``in_specs`` / ``out_specs``) against the
reference's, leaf by leaf, and ``to_placements``.

* ``lm_param_specs`` / ``opt_state_specs`` for the five LM configs at
  ``full()`` and ``smoke()``, at the default model axis of 16 and at 2;
  ``lm_cache_specs`` at the ``decode_32k`` and ``long_500k`` batches
  (full and smoke) for both ``multi_pod`` values; ``lm_batch_spec``,
  ``gnn_specs`` and ``recsys_specs`` for both.
* Every full cell's ``in_specs`` / ``out_specs`` from ``build_cell`` at
  both ``multi_pod`` values (the reference's cells through
  ``jax.eval_shape``), the coremaint cells included.
* ``to_placements`` on single and tuple axes, the mesh's order, a
  missing axis and an axis named twice.

A spec tree is compared as the list of ``(path, spec)`` leaves jax
flattens the reference's into (dict keys sorted, a ``GraphBatch`` by
its flattened children), the port's ``P`` against ``tuple(spec)``.
"""
import dataclasses
import types

import pytest

jax = pytest.importorskip("jax")
from jax.sharding import PartitionSpec  # noqa: E402
from jax.tree_util import keystr, tree_flatten_with_path  # noqa: E402

from repro.configs import get_arch as ref_get_arch  # noqa: E402
from repro.launch import steps as JS  # noqa: E402
from repro.parallel import sharding as JR  # noqa: E402

from repro_torch.configs import arch_names, get_arch  # noqa: E402
from repro_torch.launch.steps import build_cell, cell_names  # noqa: E402
from repro_torch.models.gnn import GraphBatch  # noqa: E402
from repro_torch.parallel import sharding as R  # noqa: E402
from repro_torch.parallel.sharding import P  # noqa: E402

LM_ARCHS = [a for a in arch_names() if get_arch(a).FAMILY == "lm"]
FULL_CELLS = [(a, s) for a in arch_names(include_coremaint=True)
              for s in cell_names(a)]
GRAPH_FIELDS = ("node_feat", "senders", "receivers", "edge_mask",
                "node_mask", "graph_id", "positions", "species")


def ref_leaves(tree):
    flat, _ = tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, PartitionSpec))
    return [(keystr(path), tuple(spec)) for path, spec in flat]


def port_leaves(tree, path=""):
    """The port's spec tree flattened as jax flattens the reference's."""
    if isinstance(tree, P):
        return [(path, tuple(tree))]
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree)
                for leaf in port_leaves(tree[k], f"{path}[{k!r}]")]
    if isinstance(tree, (list, tuple)):
        return [leaf for i, v in enumerate(tree)
                for leaf in port_leaves(v, f"{path}[{i}]")]
    if isinstance(tree, GraphBatch):
        return [leaf for i, f in enumerate(GRAPH_FIELDS)
                for leaf in port_leaves(getattr(tree, f),
                                        f"{path}[<flat index {i}>]")]
    raise TypeError(f"{path}: {type(tree).__name__} in a spec tree")


def assert_same(port, ref):
    got, want = port_leaves(port), ref_leaves(ref)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        assert g == w, path


def configs(arch):
    return [(size, get_arch(arch).__dict__[size](),
             ref_get_arch(arch).__dict__[size]())
            for size in ("full", "smoke")]


@pytest.mark.parametrize("arch", LM_ARCHS)
@pytest.mark.parametrize("model_size", [16, 2])
def test_lm_param_and_opt_specs_match_reference(arch, model_size):
    for _, cfg, ref_cfg in configs(arch):
        specs = R.lm_param_specs(cfg, model_size=model_size)
        want = JR.lm_param_specs(ref_cfg, model_size=model_size)
        assert_same(specs, want)
        assert_same(R.opt_state_specs(specs), JR.opt_state_specs(want))


@pytest.mark.parametrize("arch", LM_ARCHS)
@pytest.mark.parametrize("multi_pod", [False, True])
def test_lm_cache_specs_match_reference(arch, multi_pod):
    for size, cfg, ref_cfg in configs(arch):
        shapes = get_arch(arch).SHAPES if size == "full" else \
            get_arch(arch).SHAPES_SMOKE
        batches = {c.params["batch"] for c in shapes
                   if c.name in ("decode_32k", "long_500k")}
        assert len(batches) == 2
        for b in sorted(batches) + [0]:
            for data_size, model_size in ((16, 16), (2, 2)):
                assert_same(
                    R.lm_cache_specs(cfg, multi_pod, batch=b,
                                     data_size=data_size,
                                     model_size=model_size),
                    JR.lm_cache_specs(ref_cfg, multi_pod, batch=b,
                                      data_size=data_size,
                                      model_size=model_size))


@pytest.mark.parametrize("multi_pod", [False, True])
def test_batch_gnn_recsys_specs_match_reference(multi_pod):
    assert tuple(R.lm_batch_spec(multi_pod)) == tuple(
        JR.lm_batch_spec(multi_pod))
    assert_same(R.gnn_specs(multi_pod), JR.gnn_specs(multi_pod))
    assert_same(R.recsys_specs(multi_pod), JR.recsys_specs(multi_pod))


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch,shape", FULL_CELLS)
def test_cell_specs_match_reference(arch, shape, multi_pod):
    prog = build_cell(arch, shape, multi_pod=multi_pod, device="cpu")
    ref = JS.build_cell(arch, shape, multi_pod=multi_pod)
    assert prog.name == ref.name
    assert_same(prog.in_specs, ref.in_specs)
    if ref.out_specs is None:
        assert prog.out_specs is None
    else:
        assert_same(prog.out_specs, ref.out_specs)


def test_full_cells_take_the_pins_and_smoke_cells_do_not(monkeypatch):
    monkeypatch.delenv("REPRO_NO_PIN", raising=False)
    lm = build_cell("qwen2-7b", "train_4k", multi_pod=True, device="cpu")
    cfg = lm.abstract_inputs[0].cfg
    assert (cfg.batch_axes, cfg.tp_axis, cfg.attn_chunk) == (
        ("pod", "data"), "model", 2048)
    dim = build_cell("dimenet", "molecule", device="cpu")
    cfg = dim.abstract_inputs[0].cfg
    assert cfg.shard_axes == ("data", "model")
    assert cfg.msg_dtype == R.torch.bfloat16
    smoke = build_cell("pna", "full_graph_sm", smoke=True, device="cpu")
    assert smoke.abstract_inputs[0].cfg.shard_axes is None
    monkeypatch.setenv("REPRO_NO_PIN", "1")
    cfg = build_cell("qwen2-7b", "train_4k", device="cpu"
                     ).abstract_inputs[0].cfg
    assert (cfg.batch_axes, cfg.tp_axis, cfg.attn_chunk) == (None, None, 0)
    cfg = build_cell("dimenet", "molecule", device="cpu"
                     ).abstract_inputs[0].cfg
    assert cfg.shard_axes is None and cfg.msg_dtype == R.torch.float32


MESH = types.SimpleNamespace(mesh_dim_names=("pod", "data", "model"))


@pytest.mark.parametrize("spec,want", [
    (P(), ["R", "R", "R"]),
    (P("data", None), ["R", "S0", "R"]),
    (P(None, "model"), ["R", "R", "S1"]),
    (P(("pod", "data"), None), ["S0", "S0", "R"]),
    (P(("pod", "data", "model")), ["S0", "S0", "S0"]),
    (P(None, ("data", "model"), None), ["R", "S1", "S1"]),
    (P("model", "data"), ["R", "S1", "S0"]),
])
def test_to_placements(spec, want):
    def name(p):
        return f"S{p.dim}" if p.is_shard() else "R"
    assert [name(p) for p in R.to_placements(spec, MESH)] == want


@pytest.mark.parametrize("spec,match", [
    (P("expert"), "no axis 'expert'"),
    (P(("pod", "nope")), "no axis 'nope'"),
    (P("data", "data"), "named twice"),
    (P(("model", "data")), "mesh's order"),
])
def test_to_placements_refuses(spec, match):
    with pytest.raises(ValueError, match=match):
        R.to_placements(spec, MESH)


def test_spec_at_walks_the_reference_names():
    from repro_torch.models.recsys import DeepFM

    cfg = dataclasses.replace(get_arch("deepfm").smoke())
    model = DeepFM(cfg, device="meta")
    tree = R.param_tree(model, lambda name, _: name)
    assert tree["mlp"][0] == {"w": "mlp.0.weight", "b": "mlp.0.bias"}
    specs = {"embed": P("data", None), "w1": P("data"), "bias": P(),
             "mlp": R.param_tree(model.mlp, lambda *_: P(None))}
    for name, _ in model.named_parameters():
        assert R.spec_at(specs, name) == (
            P(None) if name.startswith("mlp.") else specs[name])
    with pytest.raises(KeyError):
        R.spec_at(specs, "nope")
