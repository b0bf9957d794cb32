"""The port's streaming service, ``examples/stream_maintenance_torch.py``,
under ``torchrun`` with 2 gloo ranks on the CPU (``--engine sharded``):
the group taken from the environment, every rank replaying the stream,
rank 0 alone printing and writing the checkpoints between barriers,
``--verify``'s collectives on every rank, a simulated crash and the
resume of every rank from the checkpoint (which both packages load on
one device). ``--standalone`` rendezvous binds a free localhost port of
its own, so parallel test workers do not collide. The halo engine runs
on 4 ranks as a 2x2 mesh with the sparse exchange."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
EXAMPLE = ROOT / "examples" / "stream_maintenance_torch.py"
RANKS = 2
SMALL = ["--device", "cpu", "--n", "200", "--m", "800", "--batches", "6",
         "--batch-size", "32", "--engine", "sharded"]
BZ_OK = "final cores verified against BZ ✓"


def torchrun(tmp_path, *args, timeout=300, ranks=RANKS):
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(ranks), str(EXAMPLE), *SMALL, "--ckpt",
         str(tmp_path / "ckpt.npz"), *args],
        capture_output=True, text=True, timeout=timeout, cwd=tmp_path,
        env=dict(os.environ, OMP_NUM_THREADS="1"),
    )
    return out.returncode, out.stdout, out.stderr


@pytest.mark.parametrize("mixed", [True, False], ids=["mixed", "single"])
def test_torchrun_verify_passes(tmp_path, mixed):
    rc, out, err = torchrun(tmp_path, "--verify",
                            *(["--mixed"] if mixed else []))
    assert rc == 0, err
    assert f"engine=sharded kernel_backend=torch shards={RANKS}" in out
    assert out.count("[batch ") == 6  # rank 0 alone prints
    assert out.count(BZ_OK) == 1
    assert not (tmp_path / "ckpt.npz").exists()  # cleaned on success


def test_torchrun_range_mixed_verify(tmp_path):
    """``--vertex-sharding range``: each rank owns half the vertices and
    a per-batch halo; the gathered cores equal BZ."""
    rc, out, err = torchrun(tmp_path, "--vertex-sharding", "range",
                            "--mixed", "--verify")
    assert rc == 0, err
    assert f"shards={RANKS} vertex_sharding=range" in out
    assert out.count("[batch ") == 6
    assert out.count(BZ_OK) == 1


def test_torchrun_halo_sparse_verify(tmp_path):
    """``--vertex-sharding halo --mesh-shape 2x2 --frontier-exchange
    sparse`` on 4 ranks: two edge rows of two owners each, the planned
    sparse cap; the gathered cores equal BZ."""
    rc, out, err = torchrun(tmp_path, "--vertex-sharding", "halo",
                            "--mesh-shape", "2x2", "--frontier-exchange",
                            "sparse", "--mixed", "--verify", ranks=4)
    assert rc == 0, err
    assert ("shards=4 vertex_sharding=halo mesh_shape=2x2 "
            "frontier_exchange=sparse") in out
    assert out.count("[batch ") == 6 and out.count("max_frontier=") == 6
    assert out.count(BZ_OK) == 1


@pytest.mark.parametrize("args,message", [
    (("--mesh-shape", "2x2"), "--mesh-shape needs --vertex-sharding halo"),
    (("--vertex-sharding", "halo", "--mesh-shape", "2by2"),
     "--mesh-shape must look like 4x2"),
    (("--frontier-exchange", "sparse"),
     "--frontier-exchange sparse needs --vertex-sharding range or halo")],
    ids=["mesh-shape-without-halo", "mesh-shape-syntax", "sparse-replicated"])
def test_cli_refuses_inconsistent_flags(tmp_path, args, message):
    out = subprocess.run([sys.executable, str(EXAMPLE), *SMALL, *args],
                         capture_output=True, text=True, timeout=120,
                         cwd=tmp_path)
    assert out.returncode == 2
    assert message in out.stderr


def test_torchrun_weighted_window_verify(tmp_path):
    rc, out, err = torchrun(tmp_path, "--weighted", "--window", "3",
                            "--verify")
    assert rc == 0, err
    assert f"shards={RANKS}" in out
    assert "final cores verified against the weighted peeling oracle ✓" in out


def test_torchrun_crash_and_resume(tmp_path):
    args = ("--mixed", "--verify", "--ckpt-every", "1")
    rc, out, err = torchrun(tmp_path, *args, "--simulate-crash")
    assert rc != 0, err  # every rank exits 17; torchrun reports a failure
    assert "[crash]" in out and BZ_OK not in out
    ckpt = tmp_path / "ckpt.npz"
    assert ckpt.exists()
    assert (tmp_path / "ckpt.npz.meta").read_text().strip() == "3"
    assert not list(tmp_path.glob("*.tmp*"))  # rank 0 committed atomically
    # the 2-shard checkpoint holds the global table: it loads on one
    # device in both packages, and they agree
    from repro_torch.core.api import CoreMaintainer
    tm = CoreMaintainer.load(ckpt, device="cpu", engine="unified")
    assert tm.capacity % RANKS == 0
    pytest.importorskip("jax", reason="the reference package runs on jax")
    from repro.core.api import CoreMaintainer as JaxMaintainer
    jm = JaxMaintainer.load(str(ckpt), engine="unified")
    np.testing.assert_array_equal(tm.cores(), jm.cores())
    np.testing.assert_array_equal(tm.labels(), jm.labels())
    assert tm.edge_slot == jm.edge_slot
    rc, out, err = torchrun(tmp_path, *args)
    assert rc == 0, err
    assert out.count("[resume] restored checkpoint, continuing at batch 4") == 1
    assert out.count("[batch ") == 2
    assert BZ_OK in out
    assert not ckpt.exists()
