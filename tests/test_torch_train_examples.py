"""The port's training entry points on the CPU: ``examples/
train_lm_torch.py`` (``--preset tiny``), ``examples/train_gnn_torch.py``
at a small size, ``examples/quickstart_torch.py`` and
``python -m repro_torch.launch.train``, each with ``--device cpu``.

The LM and GNN examples must improve the loss (the reference's own
assert); the GNN example's maintained cores must match BZ and, bit for
bit with the labels, the reference's maintainer over the same stream;
the quickstart's printed statistics must equal the reference
quickstart's; the launcher must resume from its checkpoint on a second
run.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
ENV = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")


def _run(args, timeout=240):
    out = subprocess.run([sys.executable] + args, env=ENV, cwd=ROOT,
                         capture_output=True, text=True, timeout=timeout)
    assert out.returncode == 0, out.stderr[-4000:]
    return out.stdout


def test_train_lm_tiny_improves_the_loss():
    out = _run(["examples/train_lm_torch.py", "--device", "cpu",
                "--preset", "tiny", "--steps", "40", "--micro-batches",
                "2"])
    assert "on cpu" in out
    assert "LM training improved the loss ✓" in out


def test_train_gnn_small_improves_the_loss_and_cores_match_bz():
    out = _run(["examples/train_gnn_torch.py", "--device", "cpu", "--n",
                "300", "--steps", "30", "--verify"])
    assert "kernel_backend=torch" in out
    assert "dynamic-graph GNN training improved the loss ✓" in out
    assert "final cores verified against BZ ✓" in out


def test_train_gnn_maintainer_matches_reference():
    """The example's maintainer, driven between training steps, holds
    the same cores and labels as the reference's maintainer after the
    same stream (``examples/train_gnn.py``'s calls)."""
    pytest.importorskip("jax")
    from repro.core.api import CoreMaintainer as JaxMaintainer
    from repro.graph.generators import erdos_renyi as j_er
    from repro.graph.stream import synthetic_stream as j_stream
    sys.path.insert(0, str(ROOT / "examples"))
    import train_gnn_torch

    n, steps, burst = 200, 24, 16
    lines = []
    report, m, model = train_gnn_torch.train(n, steps, burst, "cpu",
                                             say=lines.append)
    assert len(report["history"]) == steps and lines
    g = j_er(n, 4 * n, seed=0)
    jm = JaxMaintainer.from_graph(g, capacity=16 * n)
    for ev in j_stream(g, steps, burst, seed=7):
        if ev.kind == "insert":
            jm.insert_edges(ev.edges)
        else:
            jm.remove_edges(ev.edges)
    np.testing.assert_array_equal(m.cores(), jm.cores())
    np.testing.assert_array_equal(m.labels(), jm.labels())
    assert all(p.requires_grad for p in model.parameters())


def test_quickstart_matches_reference():
    pytest.importorskip("jax")
    port = _run(["examples/quickstart_torch.py", "--device", "cpu"])
    ref = _run(["examples/quickstart.py"])
    assert "cores match BZ recomputation ✓" in port
    assert "cores restored ✓" in port
    # every line after the first (which names the device) is the same
    assert port.splitlines()[1:] == ref.splitlines()[1:]
    assert port.splitlines()[0].startswith(ref.splitlines()[0])


def test_launch_train_resumes_from_its_checkpoint(tmp_path):
    args = ["-m", "repro_torch.launch.train", "--arch", "qwen2-7b",
            "--smoke", "--steps", "12", "--ckpt-every", "5", "--ckpt-dir",
            str(tmp_path), "--device", "cpu"]
    first = _run(args)
    assert "[train] qwen2-7b-smoke:" in first and "resuming" not in first
    assert "[train] done @ step 12" in first
    second = _run(args)
    assert "[train] resuming after committed step 10" in second
    assert "[train] done @ step 12" in second


def test_launch_train_refuses_other_families():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "pna",
         "--device", "cpu"], env=ENV, cwd=ROOT, capture_output=True,
        text=True, timeout=120)
    assert out.returncode != 0
    assert "launch.train drives LM archs" in out.stderr


def test_launch_train_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is usable")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--smoke",
         "--steps", "1"], env=ENV, cwd=ROOT, capture_output=True, text=True,
        timeout=120)
    assert out.returncode != 0 and "device='cpu'" in out.stderr
