"""The per-layer metrics read from the program's spans
(rollbench/program_spans.py and the seven readers that use it), fed
hand-made span lists: the median over the traces none of whose spans was
profiled, of the named spans summed within a trace; None where nothing
holds them, where the program has no recorder, or in the other unit's
cells."""

import sys
from types import SimpleNamespace

import pytest

from rollbench import harness, program_spans

FINISHED = program_spans.finished

PROVE = {"encode_ms": ["groth16.encode"],
         "combine_ms": ["groth16.combine_g1", "groth16.combine_g2"],
         "blind_ms": ["groth16.blind"],
         "copy_wait_ms": ["groth16.copy_wait", "groth16.copy_wait"]}
OPERATOR = {"witness_wait_ms.operator": ["operator.wait_witness"],
            "synth_signature_ms.operator": ["synth.signature"] * 2,
            "synth_tree_ms.operator": ["synth.tree"] * 2}


def _span(name, trace, ms, profiled=False, start=0):
    return SimpleNamespace(name=name, trace=trace, start_ns=start,
                           end_ns=start + int(ms * 1e6), profiled=profiled)


def _call(trace, names, ms_each, profiled=False, other="groth16.prove"):
    """One proof or batch: each named span of ms_each, and a span of
    another name that no reader counts (profiled where asked)."""
    return [_span(n, trace, ms_each) for n in names] + \
        [_span(other, trace, 999.0, profiled)]


def _run(unit):
    return harness.Run(cell={"name": "x"}, config={}, mix={}, unit=unit,
                       setup_s=1.0, window_s=1.0, calls=[])


@pytest.fixture
def feed(monkeypatch):
    def put(found):
        monkeypatch.setattr(program_spans, "finished", lambda: found)
    return put


@pytest.mark.parametrize("name,unit,names",
                         [(m, "proof", n) for m, n in PROVE.items()] +
                         [(m, "batch", n) for m, n in OPERATOR.items()])
def test_reader_takes_the_median_of_untraced_calls(feed, name, unit, names):
    read = harness.reader(name)
    k = len(names)
    found = (_call("warm-up", names, 5000.0)           # an outlier
             + _call(1, names, 10.0) + _call(2, names, 12.0)
             + _call(3, names, 14.0)
             + _call(4, names, 1.0, profiled=True)    # the traced window
             + _call(5, names, 1.0, profiled=True)
             + _call(6, [], 0.0)                      # none of its spans
             + [_span(names[0], None, 3000.0)])       # in no trace
    feed(found)
    # sums a call: 10k, 12k, 14k, 5000k; the median of four
    assert read(_run(unit)) == pytest.approx(13.0 * k)
    other = "batch" if unit == "proof" else "proof"
    assert read(_run(other)) is None


@pytest.mark.parametrize("name", [*PROVE, *OPERATOR])
def test_reader_finds_nothing(feed, monkeypatch, name):
    read = harness.reader(name)
    unit = "proof" if name in PROVE else "batch"
    feed([])
    assert read(_run(unit)) is None
    # every call holding the spans was profiled, or holds none of them
    names = {**PROVE, **OPERATOR}[name]
    feed(_call(1, names, 5.0, profiled=True) + _call(2, [], 0.0))
    assert read(_run(unit)) is None
    # a program without the recorder (the parent of the change that
    # brought it)
    import zkrollup_torch
    monkeypatch.setattr(program_spans, "finished", FINISHED)
    monkeypatch.delattr(zkrollup_torch, "spans", raising=False)
    monkeypatch.setitem(sys.modules, "zkrollup_torch.spans", None)
    assert read(_run(unit)) is None
