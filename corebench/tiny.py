"""Tiny cells for the CPU tests: a checkout-like root holding a
``BENCHMARK.json`` built from the real one, with tiny configurations
(``kernel_backend="torch"``, so the port runs its plain path on the CPU),
a tiny burst mix and the real metric readers."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

HERE = Path(__file__).resolve().parent

CONFIGS = {
    "tiny-rmat": {"generator": "kronecker", "scale": 7, "edgefactor": 16,
                  "initiator": [0.57, 0.19, 0.19], "graph_seed": 3},
    "tiny-er": {"generator": "gnm", "n": 300, "m": 1500, "graph_seed": 5},
}
MIX = {"kind": "burst", "batch_edges": 40, "distinct_pairs": 4,
       "trace_pairs": 1}


def make_root(path: Path) -> Path:
    """Write the tiny cells under ``path`` and return it."""
    bench = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    pkg = path / "corebench"
    (pkg / "configs").mkdir(parents=True, exist_ok=True)
    (pkg / "traffic").mkdir(exist_ok=True)
    shutil.copytree(HERE / "metrics", pkg / "metrics", dirs_exist_ok=True,
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench["configs"], bench["workloads"] = [], []
    for name, cfg in CONFIGS.items():
        cfg = dict(cfg, engine="unified", kernel_backend="torch",
                   init="jax-peel")
        (pkg / "configs" / f"{name}.json").write_text(json.dumps(cfg))
        bench["configs"].append({"name": name, "source": "test",
                                 "file": f"corebench/configs/{name}.json",
                                 "reduced": [], "why": "test"})
        bench["workloads"].append({"name": f"{name}.burst", "config": name,
                                   "traffic": "burst", "chips": 1,
                                   "why": "test"})
    for metric in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in metric:
            metric["workloads"] = ["tiny-rmat.burst"]
    (pkg / "traffic" / "burst.json").write_text(json.dumps(MIX))
    (path / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return path
