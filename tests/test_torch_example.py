"""The port's streaming service, ``examples/stream_maintenance_torch.py``,
run on the CPU at a small size: ``--mixed --verify`` and the
single-kind stream on each engine (``--engine sharded`` on a world of
one gloo rank), the weighted sliding-window stream, a simulated crash
(exit 17) and the resume from its checkpoint (which the reference
package loads too), and the refusal."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
EXAMPLE = ROOT / "examples" / "stream_maintenance_torch.py"
SMALL = ["--device", "cpu", "--n", "200", "--m", "800", "--batches", "6",
         "--batch-size", "32"]
BZ_OK = "final cores verified against BZ ✓"


def run(tmp_path, *args, timeout=300):
    out = subprocess.run(
        [sys.executable, str(EXAMPLE), *SMALL, "--ckpt",
         str(tmp_path / "ckpt.npz"), *args],
        capture_output=True, text=True, timeout=timeout, cwd=tmp_path,
        env=dict(os.environ, OMP_NUM_THREADS="1"),
    )
    return out.returncode, out.stdout, out.stderr


@pytest.mark.parametrize("mixed", [True, False], ids=["mixed", "single"])
@pytest.mark.parametrize("engine", ["unified", "host", "sharded"])
def test_verify_passes(tmp_path, engine, mixed):
    rc, out, err = run(tmp_path, "--engine", engine, "--verify",
                       *(["--mixed"] if mixed else []))
    assert rc == 0, err
    assert f"engine={engine} kernel_backend=torch" in out
    assert out.count("[batch ") == 6
    assert BZ_OK in out
    assert not (tmp_path / "ckpt.npz").exists()  # cleaned on success


def test_weighted_window_verify(tmp_path):
    rc, out, err = run(tmp_path, "--weighted", "--window", "3",
                       "--verify")
    assert rc == 0, err
    assert "final cores verified against the weighted peeling oracle ✓" in out


def test_weighted_window_verify_sharded(tmp_path):
    rc, out, err = run(tmp_path, "--weighted", "--window", "3",
                       "--verify", "--engine", "sharded")
    assert rc == 0, err
    assert "engine=sharded kernel_backend=torch shards=1" in out
    assert "final cores verified against the weighted peeling oracle ✓" in out


@pytest.mark.parametrize("engine", ["unified", "host", "sharded"])
def test_crash_and_resume(tmp_path, engine):
    args = ("--engine", engine, "--mixed", "--verify", "--ckpt-every", "1")
    rc, out, err = run(tmp_path, *args, "--simulate-crash")
    assert rc == 17, err
    assert "[crash]" in out and BZ_OK not in out
    ckpt = tmp_path / "ckpt.npz"
    assert ckpt.exists()
    assert (tmp_path / "ckpt.npz.meta").read_text().strip() == "3"
    # the checkpoint is the payload both packages read
    pytest.importorskip("jax", reason="the reference package runs on jax")
    from repro.core.api import CoreMaintainer as JaxMaintainer
    from repro_torch.core.api import CoreMaintainer
    # a sharded checkpoint holds the global table: it loads on one device
    one = "unified" if engine == "sharded" else engine
    jm = JaxMaintainer.load(str(ckpt), engine=engine)
    tm = CoreMaintainer.load(ckpt, device="cpu", engine=one)
    np.testing.assert_array_equal(tm.cores(), jm.cores())
    np.testing.assert_array_equal(tm.labels(), jm.labels())
    assert tm.edge_slot == jm.edge_slot
    rc, out, err = run(tmp_path, *args)
    assert rc == 0, err
    assert "[resume] restored checkpoint, continuing at batch 4" in out
    assert out.count("[batch ") == 2
    assert BZ_OK in out
    assert not ckpt.exists()


@pytest.mark.parametrize("args,msg", [
    (("--engine", "host", "--weighted"), "needs a device engine"),
], ids=["host-weighted"])
def test_refusals(tmp_path, args, msg):
    rc, out, err = run(tmp_path, *args)
    assert rc == 2 and msg in err
    assert "[batch " not in out
