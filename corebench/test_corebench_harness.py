"""CPU tests of the harness: cells, mixes and metrics found by name (and
one of each added from files alone), the result line's shape, the run's
refusal without a card, and ``BENCHMARK.json`` against the contract it is
written to."""
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

from corebench import harness, parts, tiny

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda c: c["name"])
def test_each_cell_finds_its_config_and_mix_by_name(cell):
    found, config, mix = harness.find_cell(BENCH, cell["name"])
    assert found is cell
    assert config["name"] == cell["config"]
    # its generator, traffic kind and reference, each a file found by name
    assert callable(parts.load("generators", config["generator"]).generate)
    assert callable(parts.load("kinds", mix["kind"]).make)
    assert callable(parts.load("references", config.get(
        "reference", harness.DEFAULT_REFERENCE)).check)
    for name, _ in (harness.metric_names(BENCH, cell["name"], False)
                    + harness.metric_names(BENCH, cell["name"], True)):
        assert callable(harness.reader(name))


def test_benchmark_json_keeps_to_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["corebench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"] == f"corebench/configs/{c['name']}.json"
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert set(c["reduced"]) <= set(cfg)
    cells = BENCH["workloads"]
    assert len({(w["config"], w["traffic"]) for w in cells}) == len(cells)
    for w in cells:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        assert (HERE / "traffic" / f"{w['traffic']}.json").exists()
    names = [w["name"] for w in cells]
    # at most a quarter of the cells, rounded down, ask for four chips
    # (one always may)
    assert sum(w["chips"] == 4 for w in cells) <= max(1, len(cells) // 4)
    e2e, layers = BENCH["end_to_end"], BENCH["per_layer"]
    metric_names = [m["name"] for m in e2e + layers]
    assert len(set(metric_names)) == len(metric_names)
    for m in e2e:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" and m["bound"] <= 0.25 for m in e2e)
    for m in layers:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in {x["name"] for x in e2e}
        assert m["source"] in ("host_clock", "device_trace",
                               "program_span", "program_counter")
    for m in e2e + layers:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", names)) <= set(names)
        assert (HERE / "metrics" / f"{m['name']}.py").exists()
    for x in BENCH["configs"] + cells:
        assert NAME.match(x["name"])
        for text in (x["why"], x.get("source", "x")):
            assert 1 <= len(text) <= 200 and "\n" not in text
    for w in names:  # every cell reports setup_s, another e2e, a layer
        assert len(harness.metric_names(BENCH, w, False)) >= 2
        assert harness.metric_names(BENCH, w, True)
    # which cells report which metric: the burst latencies only where the
    # batches are pure bursts (a mixed batch is neither), the program's
    # spans and sync counter everywhere
    reports = {w: {m for m, _ in harness.metric_names(BENCH, w, False)
                   + harness.metric_names(BENCH, w, True)} for w in names}
    spans = {"api_host_ms", "table_ops_ms", "place_block_ms",
             "round_idle_ms", "syncs_per_batch"}
    bursts = {"remove_burst_ms", "insert_burst_ms"}
    expect = {"rmat-s21.burst": (bursts | {"batch_p90_ms"}, set()),
              "er-livej.burst": (bursts, {"batch_p90_ms"}),
              "er-livej.sliding": ({"batch_p90_ms"}, bursts)}
    for w, (has, lacks) in expect.items():
        assert has | spans <= reports[w] and not lacks & reports[w], w
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.fixture
def tiny_root(tmp_path):
    return tiny.make_root(tmp_path)


@pytest.mark.parametrize("trace", [False, True])
def test_result_line_has_the_contract_shape(tiny_root, trace):
    res = harness.run_cell("tiny-rmat.burst", 2**31 + 17, 1e9, trace,
                           device="cpu", root=tiny_root, max_batches=6)
    assert list(res)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(res)
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] == 6 + (2 if trace else 0)
    assert all(c["value"] == 0 == c["limit"] for c in res["checks"].values())
    want = dict(harness.metric_names(json.loads(
        (tiny_root / "BENCHMARK.json").read_text()), "tiny-rmat.burst",
        trace))
    # the device's metrics are not read off a CPU run
    cpu_silent = {"peak_mem_gib", "coremaint_kernel_roofline",
                  "device_idle_share"}
    assert set(res["metrics"]) == set(want) - cpu_silent
    for name, m in res["metrics"].items():
        assert m["unit"] == want[name] and isinstance(m["value"], float)
    json.dumps(res)


@pytest.mark.parametrize("cell", ["tiny-er.sliding", "tiny-er.burst"])
def test_each_kind_reports_what_its_batches_hold(tiny_root, cell):
    """A mixed batch is neither burst: the sliding cell reports no burst
    latency; both report the program's spans and sync counter traced."""
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    res = harness.run_cell(cell, 2**31 + 3, 1e9, True, device="cpu",
                           root=tiny_root, max_batches=6)
    assert res["correct"] is True, res["checks"]
    assert res["attempted"] == 6 + 4 * (cell == "tiny-er.sliding") \
        + 2 * (cell == "tiny-er.burst")
    got = set(res["metrics"])
    assert got == {m for m, _ in harness.metric_names(bench, cell, True)} \
        - {"coremaint_kernel_roofline", "device_idle_share"}
    assert {"api_host_ms", "table_ops_ms", "place_block_ms",
            "round_idle_ms", "syncs_per_batch"} <= got
    bursts = {"remove_burst_ms", "insert_burst_ms"}
    assert (bursts <= got) == (cell == "tiny-er.burst")
    assert res["metrics"]["syncs_per_batch"]["value"] > 0


# a weighted generator, written as a later configuration would add it: G(n,
# m) with weights 1-5, and further weighted pairs of the same law
WEIGHTED_GENERATOR = """
import torch

from corebench.graphs import distinct_absent, unique_keys


def _weights(keys, gen):
    return torch.randint(1, 6, (keys.numel(),), generator=gen,
                         device=keys.device)


def generate(config, gen, device):
    n, m = config["n"], config["m"]
    u = torch.randint(0, n, (4 * m,), generator=gen, device=device)
    v = torch.randint(0, n, (4 * m,), generator=gen, device=device)
    keys = unique_keys(u, v, n)
    keys = torch.sort(keys[torch.randperm(keys.numel(), generator=gen,
                                          device=device)[:m]]).values
    return {"n": n, "keys": keys, "weights": _weights(keys, gen)}


def more(config, graph, count, gen, device):
    n = graph["n"]

    def draw(k):
        u = torch.randint(0, n, (k,), generator=gen, device=device)
        v = torch.randint(0, n, (k,), generator=gen, device=device)
        return unique_keys(u, v, n)

    keys = distinct_absent(draw, graph["keys"], count, gen)
    return {"keys": keys, "weights": _weights(keys, gen)}
"""

# its reference: weighted cores by a plain min-weighted-degree peel; the
# weighted labels order the vertices by core, each label once; the live
# edges compared with their weights
WEIGHTED_REFERENCE = """
import torch


def cores(keys, weights, n):
    adj = [dict() for _ in range(n)]
    for k, w in zip(keys.tolist(), weights.tolist()):
        adj[k // n][k % n] = w
        adj[k % n][k // n] = w
    wdeg = [sum(a.values()) for a in adj]
    alive, core, level = set(range(n)), [0] * n, 0
    while alive:
        v = min(alive, key=lambda x: wdeg[x])
        level = max(level, wdeg[v])
        core[v] = level
        alive.discard(v)
        for u, w in adj[v].items():
            if u in alive:
                wdeg[u] -= w
    return torch.tensor(core)


def check(n, expected, live, want, rows):
    core_bad = order_bad = 0
    for keys, weights, states in expected:
        ref = cores(keys.cpu(), weights.cpu(), n)
        for core, label in states:
            core, label = torch.as_tensor(core).long(), torch.as_tensor(
                label).long()
            core_bad += int((core != ref).sum())
            by_label = ref[torch.argsort(label)]
            order_bad += int((by_label[1:] < by_label[:-1]).sum())
            order_bad += n - int(torch.unique(label).numel())
    got = dict(zip(live[0].tolist(), live[1].tolist()))
    exp = dict(zip(want[0].tolist(), want[1].tolist()))
    edge_bad = (live[0].numel() - len(got)
                + sum(got.get(k) != w for k, w in exp.items())
                + sum(k not in exp for k in got))
    count_bad = sum(int(r["n_inserted"]) != r["sent_insert"]
                    or int(r["n_removed"]) != r["sent_remove"] for r in rows)
    return {"core_mismatch": core_bad, "order_violations": order_bad,
            "edge_diff": edge_bad, "count_mismatch": count_bad}
"""


def add_weighted_cell(root):
    """A weighted configuration, its generator, its reference and a
    sliding mix, as new files and entries alone, and the configuration
    under the burst mix too; returns the sliding cell."""
    pkg = root / "corebench"
    (pkg / "generators" / "gnm_weighted.py").write_text(WEIGHTED_GENERATOR)
    (pkg / "references" / "weighted_peel.py").write_text(WEIGHTED_REFERENCE)
    (pkg / "configs" / "tiny-w.json").write_text(json.dumps(
        {"generator": "gnm_weighted", "n": 70, "m": 300, "graph_seed": 6,
         "weighted": True, "reference": "weighted_peel",
         "engine": "unified", "kernel_backend": "torch",
         "init": "jax-peel"}))
    (pkg / "traffic" / "slide.json").write_text(json.dumps(
        {"kind": "sliding", "step_edges": 11, "new_edges": 40,
         "warmup_batches": 2, "trace_batches": 2}))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny-w", "source": "test",
                             "file": "corebench/configs/tiny-w.json",
                             "reduced": [], "why": "test"})
    for mix in ("slide", "burst"):
        bench["workloads"].append({"name": f"tiny-w.{mix}",
                                   "config": "tiny-w", "traffic": mix,
                                   "chips": 1, "why": "test"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return "tiny-w.slide"


def test_a_config_mix_and_metric_added_from_files_alone(tiny_root):
    pkg = tiny_root / "corebench"
    (pkg / "configs" / "tiny-ba.json").write_text(json.dumps(
        {"generator": "gnm", "n": 120, "m": 700, "graph_seed": 2,
         "engine": "unified",
         "kernel_backend": "torch", "init": "host-bz"}))
    (pkg / "traffic" / "small.json").write_text(json.dumps(
        {"kind": "burst", "batch_edges": 7, "distinct_pairs": 2,
         "trace_pairs": 1}))
    (pkg / "metrics" / "batches_in_window.py").write_text(
        "def read(run):\n    return float(len(run['batches']))\n")
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny-ba", "source": "test",
                             "file": "corebench/configs/tiny-ba.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "tiny-ba.small", "config": "tiny-ba",
                               "traffic": "small", "chips": 1,
                               "why": "test"})
    bench["end_to_end"].append({"name": "batches_in_window", "unit": "n",
                                "better": "higher", "bound": 0.25,
                                "source": "host_clock",
                                "workloads": ["tiny-ba.small",
                                              "tiny-w.slide"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(bench))
    res = harness.run_cell("tiny-ba.small", 3, 1e9, False, device="cpu",
                           root=tiny_root, max_batches=4)
    assert res["correct"] is True
    assert res["metrics"]["batches_in_window"]["value"] == 4.0
    assert "edits_per_s" in res["metrics"]
    assert "batch_p90_ms" not in res["metrics"]
    # a weighted configuration with its own generator and reference, under
    # a mix of another kind, from files alone
    cell = add_weighted_cell(tiny_root)
    for trace in (False, True):
        res = harness.run_cell(cell, 4, 1e9, trace, device="cpu",
                               root=tiny_root, max_batches=6)
        assert res["correct"] is True, res["checks"]
        assert res["attempted"] == 6 + 2 * trace
    assert res["notes"]["m"] == 300
    assert "promote_ratio" in res["metrics"]
    assert "remove_burst_ms" not in res["metrics"]
    # the weighted graph's bursts put each edge back with its weight
    res = harness.run_cell("tiny-w.burst", 5, 1e9, False, device="cpu",
                           root=tiny_root, max_batches=6)
    assert res["correct"] is True, res["checks"]


def test_run_refuses_without_a_card():
    # no device visible, on a card's host too
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, str(HERE / "run.py"), "--workload",
         BENCH["workloads"][0]["name"], "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, env=env, timeout=120, cwd=ROOT)
    assert out.returncode != 0
    assert out.stdout == ""
    assert "CUDA" in out.stderr
