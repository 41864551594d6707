"""The tx_b15_d20 cell's parts: the cell reports the prove cell's metrics
and its own two, the work model counts its configuration as it counts the
others, and the two new readers: quotient_roofline on a stub trace and
msm_groups on a stub span ring."""

import json
import math
import os

from rollbench import harness, workmodel as w

CELL = "tx_b15_d20.prove"


def config(name):
    with open(os.path.join(harness.ROOT, "rollbench", "configs",
                           f"{name}.json")) as f:
        return json.load(f)


def test_the_cell_reports_the_prove_metrics_and_its_own():
    bench = harness.benchmark()
    cell, cfg, mix = harness.cell_parts(bench, CELL)
    assert (cell["chips"], cfg["name"], mix["entry"]) == (1, "tx_b15_d20",
                                                         "prove")
    e2e = {m["name"] for m in harness.cell_metrics(bench, CELL, False)}
    per_layer = {m["name"] for m in harness.cell_metrics(bench, CELL, True)}
    assert e2e == {"proofs_per_s", "proof_p90_ms", "setup_s"}
    prove = {m["name"] for m in harness.cell_metrics(bench, "tx_b2_d6.prove",
                                                     True)}
    assert per_layer == prove | {"quotient_roofline", "msm_groups"}
    assert not {"quotient_roofline", "msm_groups"} & prove


def test_counts():
    c = config("tx_b15_d20")
    assert math.isclose(w.msm_seconds(c, "g1") * 1e3, 8.039875516528925)
    assert math.isclose(w.msm_seconds(c, "g2") * 1e3, 4.138394052384642)
    for curve, tables in c["msm_points"].items():
        for n in tables.values():
            assert w.msm_adds(curve, n, 254) <= 22 * (n + 2 * (1 << 12))


def test_quotient_reading_is_bounded_by_the_least_time():
    """quotient_roofline on a stub trace: the least time of the seven
    transforms over the device time under groth16.quotient a proof."""
    c = config("tx_b15_d20")
    least = w.quotient_seconds(c)
    assert least > w.quotient_seconds(config("tx_b2_d6")) * 16
    run = harness.Run(cell={}, config=c, mix={}, unit="proof", setup_s=0,
                      window_s=1, calls=[])
    run.trace = type("S", (), {"calls": 4, "label_us":
                               {"groth16.quotient": 4 * least * 1e6}})()
    read = harness.reader("quotient_roofline")
    assert math.isclose(read(run), 100.0)
    run.trace.label_us["groth16.quotient"] = 40 * least * 1e6
    assert math.isclose(read(run), 10.0)
    run.trace.label_us = {"groth16.msm_g1": 1.0}
    assert read(run) is None
    run.trace = None
    assert read(run) is None


def test_msm_groups_counts_group_spans_a_proof(monkeypatch):
    """msm_groups: the median over the unprofiled proofs' traces of their
    groth16.msm_group spans; None where no trace holds one (the program
    before the window groups)."""
    from rollbench import program_spans

    def s(name, trace, profiled=False):
        return type("Span", (), {"name": name, "trace": trace,
                                 "profiled": profiled})()
    ring = [s("groth16.prove", "t1"), s("groth16.msm_group", "t1"),
            s("groth16.msm_group", "t1"), s("witness.prepare", "t2"),
            s("groth16.msm_group", "t3"), s("groth16.msm_group", "t3"),
            s("groth16.msm_group", "t3"), s("groth16.msm_group", "t4"),
            s("groth16.msm_group", "t5", True), s("groth16.msm_group", "t5")]
    monkeypatch.setattr(program_spans, "finished", lambda: ring)
    run = harness.Run(cell={}, config={}, mix={}, unit="proof", setup_s=0,
                      window_s=1, calls=[])
    assert harness.reader("msm_groups")(run) == 2.0   # t1 2, t3 3, t4 1
    monkeypatch.setattr(program_spans, "finished",
                        lambda: [s("groth16.prove", "t1")])
    assert harness.reader("msm_groups")(run) is None
    run.unit = "batch"
    assert harness.reader("msm_groups")(run) is None
