"""``python -m repro_torch.launch.serve --device cpu`` runs every LM arch
at ``smoke()`` width (prefill, cache widening, greedy decode) and exits
0, printing the reference's two lines and the resolved
``kernel_backend``; it imports neither jax nor the reference package."""
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
LM_ARCHS = ["deepseek-v2-236b", "deepseek-v2-lite-16b", "yi-34b",
            "qwen3-8b", "qwen2-7b"]
PROBE = ("import runpy, sys; sys.argv = ['serve'] + sys.argv[1:]; "
         "runpy.run_module('repro_torch.launch.serve', run_name='__main__'); "
         "bad = [k for k in sys.modules if k.split('.')[0] in "
         "('jax', 'jaxlib', 'repro')]; assert not bad, bad")


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_serve_runs_on_the_cpu(arch):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-c", PROBE, "--arch", arch, "--device", "cpu",
         "--batch", "2", "--prompt-len", "16", "--gen", "6"],
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert lines[0] == (f"[serve] {arch}-smoke device=cpu "
                        "kernel_backend=torch")
    assert lines[1].startswith(f"[serve] {arch}-smoke batch=2 prefill 16 "
                               "tok in ")
    assert "decoded 5 steps in" in lines[1]
    assert lines[2].startswith("[serve] sample token ids: [")
    ids = eval(lines[2].split(":", 1)[1])
    assert len(ids) == 6 and all(0 <= t < 256 for t in ids)
