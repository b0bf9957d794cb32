"""The port stands alone: ``src/repro_torch``, ``chip_smoke.py``, the
``scripts/`` that time and profile it and the port's examples
(``examples/*_torch.py``) import neither ``jax`` nor the
reference package ``repro``, and the port's entry points run on the card
unless the CPU is asked for."""
import ast
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core.api import CoreMaintainer
from repro_torch.graph.csr import build_csr

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def test_import_every_module_without_jax_or_repro():
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        import repro_torch
        names = [m.name for m in pkgutil.walk_packages(
            repro_torch.__path__, "repro_torch.")]
        for name in names:
            importlib.import_module(name)
        bad = sorted(k for k in sys.modules
                     if k == "jax" or k.startswith(("jax.", "jaxlib"))
                     or k == "repro" or k.startswith("repro."))
        assert not bad, bad
        assert len(names) >= 65, names
        for new in ("optim.adamw", "optim.compression", "optim.params",
                    "optim.schedule", "train.checkpoint", "train.fault",
                    "train.loop", "launch.steps", "launch.train",
                    "parallel", "parallel.sharding", "launch.dryrun",
                    "analysis", "analysis.walker", "analysis.programs",
                    "analysis.rules", "analysis.memory", "analysis.hostlint",
                    "analysis.audit"):
            assert "repro_torch." + new in names, new
        print("ok", len(names))
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize(
    "path",
    sorted(PORT.rglob("*.py"))
    + [ROOT / "chip_smoke.py"]
    + [ROOT / "examples" / f for f in ("stream_maintenance_torch.py",
                                       "train_lm_torch.py",
                                       "train_gnn_torch.py",
                                       "quickstart_torch.py")]
    + [ROOT / "scripts" / f for f in ("profile_burst.py",
                                      "time_attention.py",
                                      "time_coremaint.py",
                                      "time_gnn.py",
                                      "time_kernel_api.py",
                                      "time_lm.py")],
    ids=lambda p: str(p.relative_to(ROOT)),
)
def test_no_jax_or_repro_import_in_source(path):
    for mod in _imports(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), f"{path}: {mod}"


def test_from_graph_defaults_to_the_card():
    g = build_csr(4, np.array([[0, 1], [1, 2]]))
    if torch.cuda.is_available():
        m = CoreMaintainer.from_graph(g)
        assert m.device.type == "cuda" and m.kernel_backend == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            CoreMaintainer.from_graph(g)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            CoreMaintainer.from_state(
                CoreMaintainer.from_graph(g, device="cpu").state())


def test_cuda_backend_on_the_cpu_raises():
    g = build_csr(4, np.array([[0, 1], [1, 2]]))
    with pytest.raises(ValueError, match="kernel_backend='cuda'"):
        CoreMaintainer.from_graph(g, device="cpu", kernel_backend="cuda")
    with pytest.raises(ValueError, match="unknown kernel_backend"):
        CoreMaintainer.from_graph(g, device="cpu", kernel_backend="pallas")
    m = CoreMaintainer.from_graph(g, device="cpu")
    assert m.kernel_backend == "torch"
