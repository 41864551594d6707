"""The MSM work model: its counts for both configurations, taken from the
configuration files alone, and its bound: the least work, so that a
reading of 100% means the device time equals the least any route needs,
and the program's own route counts more."""

import json
import math
import os

import pytest

from rollbench import harness, workmodel as w


def config(name):
    with open(os.path.join(harness.ROOT, "rollbench", "configs",
                           f"{name}.json")) as f:
        return json.load(f)


def test_peaks():
    assert math.isclose(w.PEAK_MULS, 16.72704e12)
    assert w.PEAK_BYTES == 3.35e12
    assert w.FQ_PRODUCT_MULS == 190


@pytest.mark.parametrize("name,g1_ms,g2_ms", [
    ("tx_b2_d6", 0.6050800476354453, 0.3186815001339149),
    ("withdraw", 0.02681361914600551, 0.017337336432506886)])
def test_counts(name, g1_ms, g2_ms):
    c = config(name)
    assert math.isclose(w.msm_seconds(c, "g1") * 1e3, g1_ms)
    assert math.isclose(w.msm_seconds(c, "g2") * 1e3, g2_ms)


def test_glv_and_best_window():
    n = 110920
    plain = w.pippenger_adds(n, 254)
    assert w.msm_adds("g1", n, 254) == min(plain, w.pippenger_adds(2 * n,
                                                                   127))
    assert w.msm_adds("g2", n, 254) == plain
    for c in range(1, 25):
        assert plain <= math.ceil(254 / c) * (n + (1 << c))


def test_program_route_counts_more():
    """The program's scan at c = 12 (22 windows, every point added once a
    window, unsigned buckets summed with two additions each) needs more
    additions than the model counts, table by table."""
    for name in ("tx_b2_d6", "withdraw"):
        c = config(name)
        for curve, tables in c["msm_points"].items():
            for n in tables.values():
                route = 22 * (n + 2 * (1 << 12))
                assert w.msm_adds(curve, n, 254) <= route


def test_reading_is_bounded_by_the_least_time():
    c = config("tx_b2_d6")
    least = w.msm_seconds(c, "g1")
    run = harness.Run(cell={}, config=c, mix={}, unit="proof", setup_s=0,
                      window_s=1, calls=[])
    run.trace = type("S", (), {"calls": 2, "label_us":
                               {"groth16.msm_g1": 2 * least * 1e6}})()
    read = harness.reader("msm_g1_roofline")
    assert math.isclose(read(run), 100.0)
    run.trace.label_us["groth16.msm_g1"] = 20 * least * 1e6
    assert math.isclose(read(run), 10.0)
    run.trace.label_us = {}
    assert read(run) is None
