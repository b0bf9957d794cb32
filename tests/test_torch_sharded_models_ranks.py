"""The port's sharded model paths on 4 gloo ranks over a ``(2, 2)``
``("data", "model")`` mesh, against the unsharded port and the
reference.

* The LMs (every ``smoke()`` config, float32): parameters placed by
  ``shard_params(lm_param_specs(cfg, model_size=2))`` (heads
  tensor-parallel where they divide 2; qwen2-7b also at the default 16,
  FSDP-only attention), the pinned config (``batch_axes="data"``,
  ``tp_axis="model"``), a batch of 4 x 16: ``forward``'s logits and aux
  loss, ``loss_fn`` and its gradients (the backward run on a thread of
  its own, where DTensor's implicit replication is off, so no plain
  tensor may reach it), ``prefill``'s logits, two ``decode_step``s from
  the prefill's cache placed by ``lm_cache_specs``, and kernel h's route
  (``_attend_kernel``, its plain version on CPU tensors) through
  ``local_map`` against the unsharded port. Float32 bound: 1e-5 absolute
  (measured: 3e-6).
* The GNNs (PNA, GIN, DimeNet, NequIP ``smoke()`` train cells): the
  reference's own concrete inputs (its parameters carried into the
  port by name), one training step with ``shard_axes=("data", "model")``
  (DimeNet in float32 messages) and its inputs placed by the cell's
  ``in_specs``, against the port's unsharded step and against the
  reference's ``shard_axes`` step under ``jax.jit`` on 4 forced host
  devices (one subprocess, started beside the ranks). Bounds as
  ``tests/test_torch_steps.py``'s: loss and grad norm within 1e-5
  relative of the unsharded port (1e-4 of the reference); each first
  moment (0.1 x the clipped gradient) within 1e-4 (1e-3) relative L2;
  each update within 1e-3 lr (PNA: 1e-2 lr, its ill-conditioned rows)
  where the gradient is at least 1e-6, and within 2 lr everywhere.

One module fixture runs everything once: the reference subprocess and 4
rank subprocesses meeting through a ``file://`` store in ``tmp_path``;
the ranks do the LM part first, then wait for the reference's file.
Every process and every wait has a timeout of its own.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("jax", reason="the reference package runs on jax")

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
TIMEOUT = 300  # seconds, for each process and for the whole run
LM_ARCHS = ("qwen2-7b", "qwen3-8b", "yi-34b", "deepseek-v2-lite-16b",
            "deepseek-v2-236b")
GNN_CELLS = (("pna", "full_graph_sm"), ("gin-tu", "minibatch_lg"),
             ("dimenet", "molecule"), ("nequip", "molecule"))
LR = 1e-3  # the GNN cells' learning rate

_REFERENCE = textwrap.dedent('''
    import dataclasses, os, sys, warnings
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    warnings.filterwarnings("ignore")
    import numpy as np
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from jax.tree_util import keystr, tree_flatten_with_path
    from repro.compat import set_mesh
    from repro.configs import get_arch
    from repro.launch import steps as JS
    assert len(jax.devices()) == 4, jax.devices()
    out = sys.argv[1]
    # Auto axes: under jax's default Explicit ones the reference's own
    # PNA refuses a concatenate of differently sharded operands
    mesh = jax.make_mesh((2, 2), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    set_mesh(mesh)

    def flat(prefix, tree, rec):
        for path, x in tree_flatten_with_path(tree)[0]:
            rec[prefix + keystr(path)] = np.array(jnp.asarray(x, jnp.float32))

    def run(arch, shape):
        mod = get_arch(arch)
        cell = next(c for c in mod.SHAPES_SMOKE if c.name == shape)
        cfg = dataclasses.replace(mod.smoke(), shard_axes=("data", "model"))
        prog = JS._gnn_cell(arch, cfg, cell, False, True)
        inputs = prog.concrete_inputs(jax.random.PRNGKey(0))
        rec = {{}}
        flat("p0", inputs[0], rec)
        in_sh = jax.tree.map(lambda s: NamedSharding(mesh, s),
                             prog.in_specs,
                             is_leaf=lambda x: isinstance(x, P))
        inputs = jax.device_put(inputs, in_sh)
        with mesh:
            params, opt, met = jax.jit(prog.fn, in_shardings=in_sh)(*inputs)
        flat("p1", params, rec)
        flat("m", opt["m"], rec)
        rec["loss"] = np.asarray(met["loss"], np.float64)
        rec["grad_norm"] = np.asarray(met["grad_norm"], np.float64)
        np.savez(f"{{out}}/{{arch}}.tmp.npz", **rec)
        os.replace(f"{{out}}/{{arch}}.tmp.npz", f"{{out}}/{{arch}}.npz")

    try:
        for arch, shape in {cells}:
            run(arch, shape)
    except BaseException:
        open(f"{{out}}/FAILED", "w").close()  # the ranks stop waiting
        raise
    print("reference OK")
''')

_RANK = textwrap.dedent('''
    import dataclasses, datetime, json, os, sys, threading, time
    import numpy as np
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    out, ref, rank, world, store = sys.argv[1], sys.argv[2], int(
        sys.argv[3]), int(sys.argv[4]), sys.argv[5]
    dist.init_process_group("gloo", init_method=f"file://{{store}}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    from repro_torch.configs import get_arch
    from repro_torch.launch import steps as S
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import transformer as T
    from repro_torch.optim.params import named
    from repro_torch.parallel.sharding import (P, distribute,
                                               lm_cache_specs,
                                               lm_param_specs, place,
                                               shard_params)
    mesh = make_mesh((2, 2), ("data", "model"))

    def full(x):
        return x.full_tensor() if hasattr(x, "full_tensor") else x

    def err(a, b):
        return float((full(a) - b).abs().max())

    # ---- the LMs ---------------------------------------------------------
    lm = {{}}
    for arch in {lm_archs}:
        for ms in ((2, 16) if arch == "qwen2-7b" else (2,)):
            cfg = dataclasses.replace(get_arch(arch).smoke(),
                                      dtype=torch.float32)
            scfg = dataclasses.replace(cfg, batch_axes="data",
                                       tp_axis="model")
            ref_m = T.init_params(cfg, torch.Generator().manual_seed(0),
                                  device="cpu")
            toks = torch.randint(0, cfg.vocab, (4, 16),
                                 generator=torch.Generator().manual_seed(1))
            sh = shard_params(ref_m.converted(),
                              lm_param_specs(cfg, model_size=ms), mesh)
            r = {{}}
            want, aux_w = T.forward(cfg, ref_m, toks, "torch")
            got, aux_g = T.forward(scfg, sh, toks, "torch")
            r["forward"] = err(got, want)
            r["aux"] = err(aux_g, aux_w)
            for p in list(sh.parameters()) + list(ref_m.parameters()):
                p.requires_grad_(True)
            lw = T.loss_fn(cfg, ref_m, toks, toks, "torch")
            lg = T.loss_fn(scfg, sh, toks, toks, "torch")
            gw = torch.autograd.grad(lw, list(ref_m.parameters()))
            box = []
            th = threading.Thread(target=lambda: box.append(
                torch.autograd.grad(lg, list(sh.parameters()))))
            th.start()
            th.join(timeout=120)
            r["loss"] = err(lg, lw)
            r["grads"] = max(err(a, b) for a, b in zip(box[0], gw))
            with torch.no_grad():
                lw2, cw = T.prefill(cfg, ref_m, toks, "torch")
                lg2, cg = T.prefill(scfg, sh, toks, "torch")
                r["prefill"] = err(lg2, lw2)
                cw = T.widen_cache(cw, 20)
                cg = place(T.widen_cache(
                    {{k: full(v) for k, v in cg.items()}}, 20),
                    lm_cache_specs(cfg, False, batch=4, data_size=2,
                                   model_size=ms), mesh)
                tok, worst = toks[:, -1], 0.0
                for _ in range(2):
                    dw, cw = T.decode_step(cfg, ref_m, cw, tok)
                    dg, cg = T.decode_step(scfg, sh, cg, tok)
                    worst = max(worst, err(dg, dw))
                    tok = dw.argmax(-1)
                r["decode"] = worst
                gen = torch.Generator().manual_seed(5)
                q, k, v = (torch.randn(4, 16, h, 16, generator=gen)
                           for h in (4, 2, 2))
                spec = P("data", None, "model")
                r["kernel_route"] = err(T._attend_kernel(
                    *(distribute(x, spec, mesh) for x in (q, k, v))),
                    T._attend_kernel(q, k, v))
            lm[f"{{arch}}/{{ms}}"] = r
    if rank == 0:
        with open(f"{{out}}/lm.json", "w") as fh:
            json.dump(lm, fh)

    # ---- the GNNs --------------------------------------------------------
    def wait(path):
        t0 = time.time()
        while not os.path.exists(path):
            if time.time() - t0 > 240 or os.path.exists(f"{{ref}}/FAILED"):
                raise TimeoutError(path)
            time.sleep(0.5)
        return np.load(path)

    def load(params, z):
        nd = named(params)
        with torch.no_grad():
            for name, p in nd.items():
                path, transposed = nd.paths[name]
                a = torch.from_numpy(z["p0" + path.replace("/", "")])
                p.copy_(a.t() if transposed else a)

    def result(res, tag, met, params, opt):
        res[f"{{tag}}/loss"] = np.asarray(float(full(met["loss"])))
        res[f"{{tag}}/grad_norm"] = np.asarray(float(full(met["grad_norm"])))
        nd = named(params)
        for name, p in nd.items():
            res[f"{{tag}}/p1/{{name}}"] = full(p).detach().numpy()
            res[f"{{tag}}/m/{{name}}"] = full(opt["m"][name]).numpy()

    for arch, shape in {gnn_cells}:
        z = wait(f"{{ref}}/{{arch}}.npz")
        mod = get_arch(arch)
        cell = next(c for c in mod.SHAPES_SMOKE if c.name == shape)
        res = {{}}
        plain = S.build_cell(arch, shape, smoke=True, device="cpu")
        ins = list(plain.concrete_inputs(0))
        load(ins[0], z)
        pw, ow, mw = plain.fn(*ins)
        result(res, "plain", mw, pw, ow)
        cfg = dataclasses.replace(mod.smoke(), shard_axes=("data", "model"))
        prog = S._gnn_cell(arch, cfg, cell, False, False, True,
                           torch.device("cpu"))
        ins = list(prog.concrete_inputs(0))
        load(ins[0], z)
        placed = place(tuple(ins), prog.in_specs, mesh)
        pg, og, mg = prog.fn(*placed)
        result(res, "sharded", mg, pg, og)
        res["paths"] = np.asarray(json.dumps({{
            n: pth.replace("/", "") for n, (pth, _) in
            named(pg).paths.items()}}))
        res["transposed"] = np.asarray(json.dumps({{
            n: tr for n, (_, tr) in named(pg).paths.items()}}))
        if rank == 0:
            np.savez(f"{{out}}/{{arch}}.npz", **res)
    dist.barrier()
    dist.destroy_process_group()
    print(f"rank {{rank}} OK")
''')


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("sharded4")
    (out / "ref").mkdir()
    (out / "port").mkdir()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu")
    fmt = dict(cells=repr(GNN_CELLS), lm_archs=repr(LM_ARCHS),
               gnn_cells=repr(GNN_CELLS))
    ref_py, rank_py = out / "reference.py", out / "rank.py"
    ref_py.write_text(_REFERENCE.format(**fmt))
    rank_py.write_text(_RANK.format(**fmt))
    cmds = [[sys.executable, str(ref_py), str(out / "ref")]]
    cmds += [[sys.executable, str(rank_py), str(out / "port"),
              str(out / "ref"), str(r), str(WORLD), str(out / "store")]
             for r in range(WORLD)]
    procs = [subprocess.Popen(c, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for c in cmds]
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
    for i, (rc, o, e) in enumerate(logs):
        who = "reference" if i == 0 else f"rank {i - 1}"
        assert rc == 0, f"{who} failed:\n{o}\n{e[-4000:]}"
    return out


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_sharded_paths_match_unsharded(runs, arch):
    got = json.loads((runs / "port" / "lm.json").read_text())
    keys = [k for k in got if k.split("/")[0] == arch]
    assert keys
    for key in keys:
        r = got[key]
        for what in ("forward", "aux", "loss", "grads", "prefill",
                     "decode", "kernel_route"):
            assert r[what] <= 1e-5, (key, what, r[what])


def _gnn(runs, arch):
    with np.load(runs / "port" / f"{arch}.npz") as z:
        port = {k: z[k] for k in z.files}
    with np.load(runs / "ref" / f"{arch}.npz") as z:
        ref = {k: z[k] for k in z.files}
    return port, ref


def _check_step(got, want, g_min_of, upd_tol, m_tol, rtol):
    """``got`` / ``want``: ``(loss, grad_norm, {name: m}, {name: p1},
    {name: p0})``."""
    assert abs(got[0] - want[0]) <= rtol * abs(want[0]) + 1e-7
    assert abs(got[1] - want[1]) <= rtol * abs(want[1]) + 1e-7
    for name, m_w in want[2].items():
        m_g = got[2][name]
        denom = np.linalg.norm(m_w) or 1.0
        assert np.linalg.norm(m_g - m_w) / denom <= m_tol, name
        upd = np.abs(got[3][name] - want[3][name])
        assert upd.max() <= 2 * LR, name
        big = np.abs(g_min_of[name]) >= 1e-6
        if big.any():
            assert upd[big].max() <= upd_tol * LR, (name, upd[big].max())


def _side(port, tag):
    names = [k[len(f"{tag}/m/"):] for k in port if k.startswith(f"{tag}/m/")]
    return (float(port[f"{tag}/loss"]), float(port[f"{tag}/grad_norm"]),
            {n: port[f"{tag}/m/{n}"] for n in names},
            {n: port[f"{tag}/p1/{n}"] for n in names})


@pytest.mark.parametrize("arch,shape", GNN_CELLS)
def test_gnn_sharded_step_matches_unsharded(runs, arch, shape):
    port, _ = _gnn(runs, arch)
    got, want = _side(port, "sharded"), _side(port, "plain")
    grads = {n: m / 0.1 for n, m in want[2].items()}
    _check_step(got, want, grads, 1e-2 if arch == "pna" else 1e-3, 1e-4,
                1e-5)


@pytest.mark.parametrize("arch,shape", GNN_CELLS)
def test_gnn_sharded_step_matches_reference_sharded(runs, arch, shape):
    port, ref = _gnn(runs, arch)
    paths = json.loads(str(port["paths"]))
    transposed = json.loads(str(port["transposed"]))

    def ref_leaf(prefix, name):
        a = ref[prefix + paths[name]]
        return a.T if transposed[name] else a

    got = _side(port, "sharded")
    want = (float(ref["loss"]), float(ref["grad_norm"]),
            {n: ref_leaf("m", n) for n in got[2]},
            {n: ref_leaf("p1", n) for n in got[2]})
    grads = {n: m / 0.1 for n, m in want[2].items()}
    _check_step(got, want, grads, 1e-2 if arch == "pna" else 1e-3, 1e-3,
                1e-4)
