"""Tiny cells for the CPU tests: a checkout-like root holding a
``BENCHMARK.json`` built from the real one, with tiny configurations
(``kernel_backend="torch"``, so the port runs its plain path on the CPU)
in place of the real ones, tiny mixes of the same kinds, the real cells
renamed to match, and the real generators, kinds, references and metric
readers."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

HERE = Path(__file__).resolve().parent
PARTS = ("metrics", "generators", "kinds", "references")

CONFIGS = {
    "tiny-rmat": {"generator": "kronecker", "scale": 7, "edgefactor": 16,
                  "initiator": [0.57, 0.19, 0.19], "graph_seed": 3},
    "tiny-er": {"generator": "gnm", "n": 300, "m": 1500, "graph_seed": 5},
}
# the real configuration each tiny one stands in for
STANDS_FOR = {"rmat-s21": "tiny-rmat", "er-livej": "tiny-er"}
MIX = {"kind": "burst", "batch_edges": 40, "distinct_pairs": 4,
       "trace_pairs": 1}
MIXES = {"burst": MIX,
         "sliding": {"kind": "sliding", "step_edges": 30, "new_edges": 120,
                     "warmup_batches": 3, "trace_batches": 4}}


def make_root(path: Path) -> Path:
    """Write the tiny cells under ``path`` and return it."""
    bench = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    pkg = path / "corebench"
    (pkg / "configs").mkdir(parents=True, exist_ok=True)
    (pkg / "traffic").mkdir(exist_ok=True)
    for part in PARTS:
        shutil.copytree(HERE / part, pkg / part, dirs_exist_ok=True,
                        ignore=shutil.ignore_patterns("__pycache__"))
    renamed = {}
    for w in bench["workloads"]:
        if w["config"] in STANDS_FOR and w["traffic"] in MIXES:
            config = STANDS_FOR[w["config"]]
            renamed[w["name"]] = f"{config}.{w['traffic']}"
    bench["configs"], bench["workloads"] = [], []
    for name, cfg in CONFIGS.items():
        cfg = dict(cfg, engine="unified", kernel_backend="torch",
                   init="jax-peel")
        (pkg / "configs" / f"{name}.json").write_text(json.dumps(cfg))
        bench["configs"].append({"name": name, "source": "test",
                                 "file": f"corebench/configs/{name}.json",
                                 "reduced": [], "why": "test"})
    for name in renamed.values():
        config, traffic = name.split(".")
        bench["workloads"].append({"name": name, "config": config,
                                   "traffic": traffic, "chips": 1,
                                   "why": "test"})
    for metric in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in metric:
            metric["workloads"] = [renamed[w] for w in metric["workloads"]
                                   if w in renamed]
    for name, mix in MIXES.items():
        (pkg / "traffic" / f"{name}.json").write_text(json.dumps(mix))
    (path / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return path
