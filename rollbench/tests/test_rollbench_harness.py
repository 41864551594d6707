"""The harness finds every configuration, traffic mix, entry loop and metric of
BENCHMARK.json by its name, and takes new ones added as files alone; the
file keeps to the contract's shape."""

import json
import math
import os
import re
import shutil

import pytest

from rollbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    return harness.benchmark()


def test_every_cell_finds_its_parts(bench):
    for w in bench["workloads"]:
        cell, config, mix = harness.cell_parts(bench, w["name"])
        assert config["name"] == w["config"]
        assert hasattr(harness.entry_class(mix), "setup")
        e2e = harness.cell_metrics(bench, w["name"], False)
        per_layer = harness.cell_metrics(bench, w["name"], True)
        assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
        assert per_layer
        for m in e2e + per_layer:
            assert callable(harness.reader(m["name"]))


def test_contract_shape(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    cells = {w["name"] for w in bench["workloads"]}
    e2e = {m["name"] for m in bench["end_to_end"]}
    names = [c["name"] for c in bench["configs"]] + sorted(cells) + \
        [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(names) == len(set(names)) and all(map(NAME.match, names))
    n = 24
    assert (2 + 14 * n) * (bench["run_seconds"] + 60) + n * 180 + 1200 \
        <= 43200
    for c in bench["configs"]:
        assert c["file"].startswith("rollbench/") and not c["reduced"]
        assert any(w["config"] == c["name"] for w in bench["workloads"])
    for w in bench["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and UNIT.match(m["unit"])
        assert m["source"] in ("host_clock", "device_trace")
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and UNIT.match(m["unit"])
        assert set(m.get("workloads", cells)) <= cells
        for cell in m.get("workloads", cells):
            reported = {x["name"] for x in
                        harness.cell_metrics(bench, cell, False)}
            assert m["moves"] in reported
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    assert len(json.dumps(bench)) < 64 * 1024


def test_new_parts_are_files_alone(tmp_path, bench):
    """A configuration, a traffic mix and a metric added to a copy as new
    files and new entries, no file edited: the harness finds each."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(harness.ROOT, "rollbench"),
                    root / "rollbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (root / "rollbench").rglob("*")
              if p.is_file()}
    b = json.loads(json.dumps(bench))
    cfg = json.loads((root / "rollbench/configs/tx_b2_d6.json").read_text())
    cfg.update(name="tx_b8_d16", batch_size=8, tree_depth=16)
    (root / "rollbench/configs/tx_b8_d16.json").write_text(json.dumps(cfg))
    mix = json.loads((root / "rollbench/traffic/prove.json").read_text())
    mix["pool"] = 2
    (root / "rollbench/traffic/prove_small.json").write_text(json.dumps(mix))
    (root / "rollbench/metrics/calls_traced.py").write_text(
        "def read(run):\n    return float(sum(1 for c in run.calls "
        "if c.get('traced')))\n")
    b["configs"].append({"name": "tx_b8_d16", "source": "https://x",
                         "file": "rollbench/configs/tx_b8_d16.json",
                         "reduced": [], "why": "a later configuration"})
    b["workloads"].append({"name": "tx_b8_d16.prove_small",
                           "config": "tx_b8_d16", "traffic": "prove_small",
                           "chips": 1, "why": "a later cell"})
    b["per_layer"].append({"name": "calls_traced", "unit": "calls",
                           "better": "higher", "source": "program_counter",
                           "layer": "operator", "moves": "proofs_per_s"})
    for m in b["end_to_end"]:
        if "workloads" in m and m["name"] != "l2_tx_per_s":
            m["workloads"].append("tx_b8_d16.prove_small")
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    cell, config, mix = harness.cell_parts(harness.benchmark(str(root)),
                                           "tx_b8_d16.prove_small",
                                           str(root))
    assert (config["batch_size"], mix["pool"]) == (8, 2)
    run = harness.Run(cell=cell, config=config, mix=mix, unit="proof",
                      setup_s=1.0, window_s=2.0,
                      calls=[{"proof": 1, "traced": True, "latency_s": 1}])
    assert harness.reader("calls_traced", str(root))(run) == 1.0
    assert harness.reader("proofs_per_s", str(root))(run) == 0.5
    after = {p: p.read_bytes() for p in before}
    assert after == before


def test_percentile_nearest_rank():
    xs = list(range(1, 101))
    assert harness.percentile(xs, 90) == 90
    assert harness.percentile([5.0], 90) == 5.0
    assert harness.percentile(list(range(1, 12)), 90) == 10
    assert math.isclose(harness.percentile([0.1, 0.3, 0.2], 50), 0.2)
