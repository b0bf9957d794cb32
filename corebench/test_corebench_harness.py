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

from corebench import harness, mixes, tiny

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
    assert config["generator"] in ("kronecker", "gnm")
    assert mix["kind"] in mixes.KINDS
    assert isinstance(mix["batch_edges"], int) and mix["batch_edges"] > 0
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
                                "workloads": ["tiny-ba.small"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(bench))
    res = harness.run_cell("tiny-ba.small", 3, 1e9, False, device="cpu",
                           root=tiny_root, max_batches=4)
    assert res["correct"] is True
    assert res["metrics"]["batches_in_window"]["value"] == 4.0
    assert "edits_per_s" in res["metrics"]
    assert "batch_p90_ms" not in res["metrics"]


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
