"""The port's pod dry-run (``repro_torch.launch.dryrun``) against the
reference's (``repro.launch.dryrun``).

* ``collective_bytes`` on synthetic records against the reference's
  ``collective_bytes`` on the equivalent HLO op lines (every kind, a
  tuple result, bf16, two group sizes): the same wire bytes and
  ``op_counts``.
* ``model_flops`` equal to the reference's for every arch x shape.
* ``run_cell`` in a child process on a fake ``(2, 4)`` world for the
  four cells of ``tests/test_dryrun_small.py`` at ``smoke()``: the
  reference's result keys, finite terms, matmul FLOPs counted, and each
  cell's ``in_specs`` equal to the reference's. The port's ``dot_flops``
  for ``qwen2-7b:train_4k`` there is held to the reference's compiled
  ``dot_flops`` on the same mesh (a second child, 8 forced host devices,
  the layer scan unrolled so XLA counts every layer). The smoke cell is
  unpinned, and the two packages split it differently: XLA computes the
  whole step on every device (its count is exactly 128 tokens x 638,976
  FLOPs, the step's forward and backward matmuls and attention a
  token), the port keeps the batch split over "data" and the FFN and
  logits split over "model" as the parameter specs place them. The
  port's count is held to 0.25-0.40x the reference's (measured
  0.3077x).
* The CLI refuses nothing it should run: ``--cells`` over a fake 16x16
  world, one cell.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

jax = pytest.importorskip("jax")
from jax.sharding import PartitionSpec  # noqa: E402
from jax.tree_util import keystr, tree_flatten_with_path  # noqa: E402

from repro.configs import arch_names as ref_arch_names  # noqa: E402
from repro.launch import steps as JS  # noqa: E402

from repro_torch.configs import arch_names  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch.steps import build_cell, cell_names  # noqa: E402
from repro_torch.models.gnn import GraphBatch  # noqa: E402
from repro_torch.parallel.sharding import P  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT = 300
SMALL_CELLS = (("qwen2-7b", "train_4k"), ("deepseek-v2-lite-16b",
                                          "decode_32k"),
               ("pna", "full_graph_sm"), ("deepfm", "retrieval_cand"))
RESULT_KEYS = {"arch", "shape", "mesh", "n_devices", "lower_s", "compile_s",
               "flops", "dot_flops", "bytes_accessed", "collective_bytes",
               "mem", "roofline", "model_flops_global", "model_vs_hlo"}
GRAPH_FIELDS = ("node_feat", "senders", "receivers", "edge_mask",
                "node_mask", "graph_id", "positions", "species")


def _ref_dryrun():
    """``repro.launch.dryrun``, imported with the ``XLA_FLAGS`` it sets at
    import put back (this process's devices are already fixed)."""
    before = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun
    finally:
        if before is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = before
    return dryrun


# (kind, HLO result type, group size): one line and one record each
OPS = [
    ("all-gather", "f32[1024,64]{1,0}", 16),
    ("all-gather", "bf16[4096,128]{1,0}", 256),
    ("all-reduce", "f32[512]{0}", 16),
    ("all-reduce", "(f32[64,8]{1,0}, bf16[32]{0})", 8),
    ("reduce-scatter", "f32[64,64]{1,0}", 16),
    ("all-to-all", "bf16[16,16,16]{2,1,0}", 4),
    ("collective-permute", "s32[100]{0}", 2),
]
_SIZES = {"f32": 4, "bf16": 2, "s32": 4}


def _bytes(result: str) -> int:
    import re
    total = 0
    for dt, dims in re.findall(r"\b(f32|bf16|s32)\[([\d,]*)\]", result):
        n = 1
        for d in dims.split(","):
            n *= int(d)
        total += n * _SIZES[dt]
    return total


def test_collective_bytes_match_reference_ring_model():
    ref = _ref_dryrun()
    lines = [f"  %x{i} = {res} {kind}(f32[8]{{0}} %p), "
             f"replica_groups=[{1024 // p},{p}]<=[1024], dimensions={{0}}"
             for i, (kind, res, p) in enumerate(OPS)]
    records = [{"kind": kind, "bytes": _bytes(res), "group_size": p,
                "intra_node": p <= 8} for kind, res, p in OPS]
    want = ref.collective_bytes("\n".join(lines))
    got = D.collective_bytes(records)
    assert got["op_counts"] == want["op_counts"]
    assert set(got) == set(want)
    for kind in D.KINDS:
        assert got[kind] == pytest.approx(want[kind], rel=1e-12), kind
    assert all(v > 0 for k, v in got.items() if k != "op_counts")


def test_collective_seconds_split_by_node():
    rec = [{"kind": "all-reduce", "bytes": 1000, "group_size": 8,
            "intra_node": True},
           {"kind": "all-reduce", "bytes": 1000, "group_size": 16,
            "intra_node": False}]
    hw = D.HW
    want = (2 * 1000 * 7 / 8 / (hw["ici_bw_per_link"] * hw["ici_links"])
            + 2 * 1000 * 15 / 16 / hw["ib_bw_per_gpu"])
    assert D.collective_seconds(rec) == pytest.approx(want)
    assert hw["name"] == "NVIDIA H100 80GB HBM3"
    assert "TPU" not in json.dumps(hw)


def test_model_flops_match_reference():
    ref = _ref_dryrun()
    assert arch_names(include_coremaint=True) == ref_arch_names(
        include_coremaint=True)
    for arch in arch_names(include_coremaint=True):
        for shape in cell_names(arch):
            assert D.model_flops(arch, shape) == ref.model_flops(
                arch, shape), (arch, shape)


def _leaves(tree, path=""):
    """A spec tree's ``(path, spec)`` leaves, jax's order and paths."""
    if isinstance(tree, PartitionSpec):
        return [(path, tuple(tree))]
    if isinstance(tree, P):
        return [(path, tuple(tree))]
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k],
                                                         f"{path}[{k!r}]")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in _leaves(v, f"{path}[{i}]")]
    if isinstance(tree, GraphBatch):
        return [x for i, f in enumerate(GRAPH_FIELDS)
                for x in _leaves(getattr(tree, f),
                                 f"{path}[<flat index {i}>]")]
    raise TypeError(type(tree))


@pytest.mark.parametrize("arch,shape", SMALL_CELLS)
def test_small_cells_in_specs_match_reference(arch, shape):
    prog = build_cell(arch, shape, smoke=True, device="cpu")
    ref = JS.build_cell(arch, shape, smoke=True)
    flat, _ = tree_flatten_with_path(
        ref.in_specs, is_leaf=lambda x: isinstance(x, PartitionSpec))
    assert _leaves(prog.in_specs) == [(keystr(p), tuple(s))
                                      for p, s in flat]


_PORT = textwrap.dedent('''
    import json, sys
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import make_mesh
    D.init_fake_world(8)
    mesh = make_mesh((2, 4), ("data", "model"))
    out = [D.run_cell(a, s, False, verbose=False, smoke=True, mesh=mesh)
           for a, s in {cells}]
    json.dump(out, open(sys.argv[1], "w"))
    import torch.distributed as dist
    dist.destroy_process_group()
''')

_REFERENCE = textwrap.dedent('''
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax
    assert len(jax.devices()) == 8
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.compat import set_mesh
    from repro.launch import dryrun
    from repro.launch.steps import build_cell
    mesh = jax.make_mesh((2, 4), ("data", "model"))
    set_mesh(mesh)
    prog = build_cell("qwen2-7b", "train_4k", smoke=True, unroll=True)
    in_sh = jax.tree.map(lambda s: NamedSharding(mesh, s), prog.in_specs,
                         is_leaf=lambda x: isinstance(x, P))
    with mesh:
        compiled = jax.jit(prog.fn, in_shardings=in_sh).lower(
            *prog.abstract_inputs).compile()
    json.dump({"dot_flops": dryrun.dot_flops(compiled.as_text())},
              open(sys.argv[1], "w"))
''')


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    """The port's four cells on a fake (2, 4) world and the reference's
    compiled qwen2-7b train_4k, two children at once."""
    out = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    (out / "port.py").write_text(_PORT.format(cells=repr(SMALL_CELLS)))
    (out / "ref.py").write_text(_REFERENCE)
    procs = [subprocess.Popen([sys.executable, str(out / f"{who}.py"),
                               str(out / f"{who}.json")], env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for who in ("port", "ref")]
    logs = []
    try:
        for p in procs:
            o, e = p.communicate(timeout=TIMEOUT)
            logs.append((p.returncode, o, e))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for who, (rc, o, e) in zip(("port", "reference"), logs):
        assert rc == 0, f"{who} failed:\n{o}\n{e[-4000:]}"
    return (json.loads((out / "port.json").read_text()),
            json.loads((out / "ref.json").read_text()))


def test_run_cell_on_a_fake_world(small):
    results, _ = small
    assert [(r["arch"], r["shape"]) for r in results] == list(SMALL_CELLS)
    for r in results:
        assert set(r) == RESULT_KEYS, r["arch"]
        assert r["mesh"] == "2x4" and r["n_devices"] == 8
        assert r["dot_flops"] > 0 and r["bytes_accessed"] > 0
        assert r["mem"]["argument_bytes"] > 0
        assert r["mem"]["output_bytes"] > 0
        # MemTracker refuses only cells that call a module without grad
        # (DeepFM's serving MLP); retrieval_cand calls none
        assert r["mem"]["peak_bytes"] >= r["mem"]["argument_bytes"]
        assert r["mem"]["temp_bytes"] == (r["mem"]["peak_bytes"]
                                          - r["mem"]["argument_bytes"])
        assert set(r["collective_bytes"]) == set(D.KINDS) | {"op_counts"}
        assert r["roofline"]["dominant"] in ("t_compute_s", "t_memory_s",
                                             "t_collective_s")
        for k in ("t_compute_s", "t_memory_s", "t_collective_s",
                  "t_memory_xla_upper_s"):
            assert r["roofline"][k] >= 0
    # train steps move their gradients: collectives of some kind
    assert sum(results[0]["collective_bytes"]["op_counts"].values()) > 0


def test_dot_flops_match_reference_compiled(small):
    results, ref = small
    # the reference: the whole step on every device (see the docstring)
    d, h, kv, dh, ff, v, layers = 64, 4, 2, 16, 128, 256, 2
    per_layer = (2 * d * (h + 2 * kv) * dh + 2 * h * dh * d
                 + 3 * 2 * d * ff + 2 * 2 * 64 * dh * h)
    assert ref["dot_flops"] == 128 * 3 * (layers * per_layer + 2 * d * v)
    ratio = results[0]["dot_flops"] / ref["dot_flops"]
    assert 0.25 <= ratio <= 0.40, ratio


def test_cli_runs_cells_on_a_fake_16x16_world(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    out = tmp_path / "r.json"
    p = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--cells",
         "deepfm:serve_p99", "--out", str(out)],
        env=env, capture_output=True, text=True, timeout=TIMEOUT)
    assert p.returncode == 0, p.stdout + p.stderr
    (r,) = json.loads(out.read_text())
    assert r["mesh"] == "16x16" and r["n_devices"] == 256
    assert "1 cells ran OK, 0 failed" in p.stdout
    assert r["mem"]["peak_bytes"] is None  # MemTracker refuses the MLP
    assert r["model_vs_hlo"] == pytest.approx(1.0, rel=0.01)
