"""zkrollup_torch.spans, the program's span recorder, on the CPU.

- a proof's spans: prove() records each stage once (groth16.copy_wait
  twice, G1 and G2), all under one groth16.prove in one trace, nested in
  time; the prover's stats come from them;
- the profiler: with no session recording, a span never enters
  torch.profiler.record_function; under torch.profiler every span is a
  user_annotation event of the exported trace (the whole proof's trace is
  tests/test_torch_tools.py's);
- run_pipeline: each batch's worker spans (witness.prepare, its
  children, the circuit's synth.signature with its
  synth.signature.replay, and synth.tree) are filed under the batch's
  trace id, beside this process's operator.wait_witness for it, on one
  clock;
- the ring keeps its bound; the recorder and the witness stage import no
  torch;
- BatchMetrics.proofs_per_second counts settled batches over wall time,
  so a slow roll_up lowers it.
"""

import collections
import json
import os
import subprocess
import sys
import threading
import time

import pytest
import torch

from zkrollup_torch import spans
from zkrollup_torch.config import RollupConfig
from zkrollup_torch.groth16.prove import prove, prove_host
from zkrollup_torch.groth16.setup import setup_host
from zkrollup_torch.operator.batchd import BatchDaemon
from zkrollup_torch.operator.prover import ProveStats
from zkrollup_torch.operator.queue import TxQueue
from zkrollup_torch.r1cs.builder import Builder
from zkrollup_torch.ref import eddsa
from zkrollup_torch.spans import span
from zkrollup_torch.tree.merkle import create_merkle_tree
from zkrollup_torch.witness.assembler import (Transaction, format_tx,
                                              hash_balance_tree_leaf)
from zkrollup_torch.witness.batch import prepare_fields

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# prove()'s spans on the single-device path, each once but the copy wait
PROOF_SPANS = collections.Counter({
    "groth16.prove": 1, "groth16.encode": 1, "groth16.spmv_abc": 1,
    "groth16.quotient": 1, "groth16.msm_g1": 1, "groth16.msm_g2": 1,
    "groth16.copy_wait": 2, "groth16.combine_g1": 1,
    "groth16.combine_g2": 1, "groth16.blind": 1})
WITNESS_SPANS = ("witness.prepare", "witness.assemble", "witness.synth",
                 "synth.signature", "synth.signature.replay", "synth.tree")


@pytest.fixture(scope="module")
def cubic():
    """x^3 + y = out, its key, witness and public signals."""
    bld = Builder()
    out = bld.alloc_output_deferred()
    y = bld.alloc_public_input(5)
    x = bld.alloc(3)
    bld.bind_output(out, bld.mul(bld.mul(x, x), x) + y)
    r1cs = bld.r1cs()
    return setup_host(r1cs, seed=b"spans"), r1cs, bld.witness()


def test_prove_records_each_stage_under_one_proof_span(cubic):
    """The spans of a CPU proof: each stage once, copy_wait twice, one
    trace, one groth16.prove their ancestor, each inside its parent's
    interval; the MSMs' one window group each a groth16.msm_group under
    groth16.msm_g1 and groth16.msm_g2; the proof keeps the native engine's
    bytes."""
    pk, r1cs, witness = cubic
    with spans.trace() as t:
        proof = prove(pk, r1cs, witness, r=2, s=3, device="cpu", c=4)
    found = t.spans()
    assert collections.Counter(s.name for s in found) == \
        PROOF_SPANS + collections.Counter({"groth16.msm_group": 2})
    assert {s.trace for s in found} == {t.trace}
    by_id = {s.id: s for s in found}
    (root,) = [s for s in found if s.name == "groth16.prove"]
    assert root.parent is None and found[-1] is root
    groups = [by_id[s.parent].name for s in found
              if s.name == "groth16.msm_group"]
    assert sorted(groups) == ["groth16.msm_g1", "groth16.msm_g2"]
    for s in found:
        if s is not root:
            if s.name != "groth16.msm_group":
                # every stage a child of the proof
                assert s.parent == root.id
            parent = by_id[s.parent]
            assert parent.start_ns <= s.start_ns <= s.end_ns \
                <= parent.end_ns
    assert not any(s.profiled for s in found)
    want = prove_host(pk, r1cs, witness, r=2, s=3)
    assert (proof.a, proof.b, proof.c) == (want.a, want.b, want.c)


def test_prove_stats_come_from_the_spans():
    """ProveStats.take: prove_s and verify_s are the proof's spans, stages
    every span name summed over its repeats."""
    with spans.trace() as t:
        with span("groth16.prove"):
            with span("groth16.copy_wait"):
                time.sleep(0.002)
            with span("groth16.copy_wait"):
                pass
        with span("groth16.verify"):
            pass
    found = t.spans()
    st = ProveStats()
    st.take(found)
    secs = {s.name: [] for s in found}
    for s in found:
        secs[s.name].append(s.seconds)
    assert st.stages == {k: sum(v) for k, v in secs.items()}
    assert st.prove_s == st.stages["groth16.prove"] >= 0.002
    assert st.verify_s == st.stages["groth16.verify"]
    assert st.stages["groth16.copy_wait"] >= 0.002


def test_no_record_function_without_a_profiler(cubic, monkeypatch):
    """With no profiler session, a whole proof enters record_function
    never."""
    import torch.profiler as tp
    entered = []
    real = tp.record_function

    def counted(name, *a, **k):
        entered.append(name)
        return real(name, *a, **k)
    monkeypatch.setattr(tp, "record_function", counted)
    pk, r1cs, witness = cubic
    prove(pk, r1cs, witness, r=2, s=3, device="cpu", c=4)
    assert entered == []
    # and under a session, each span once
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]):
        with span("groth16.prove"), span("groth16.encode"):
            pass
    assert entered == ["groth16.prove", "groth16.encode"]


def test_a_span_without_label_stays_out_of_the_profiler(tmp_path):
    """span(name, label=False) under a profiler session: recorded and
    marked profiled, but no user_annotation of its name, so the device
    work inside it keeps its parent's label."""
    from torch.profiler import ProfilerActivity, profile
    with spans.trace() as t:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with span("groth16.msm_g1"):
                with span("groth16.msm_group", label=False):
                    torch.ones(2) + 1
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    got = {e["name"] for e in events if e.get("ph") == "X"
           and e.get("cat") == "user_annotation"}
    assert "groth16.msm_g1" in got and "groth16.msm_group" not in got
    found = t.spans()
    assert [(s.name, s.profiled) for s in found] == [
        ("groth16.msm_group", True), ("groth16.msm_g1", True)]
    assert found[0].parent == found[1].id


def test_profiled_spans_are_user_annotations(tmp_path):
    """Under torch.profiler(activities=[CPU]) every span is a
    user_annotation event of the exported Chrome trace, and records that
    it was profiled; spans after the session do not."""
    from torch.profiler import ProfilerActivity, profile
    names = [*PROOF_SPANS, "groth16.verify", "operator.wait_witness",
             *WITNESS_SPANS]
    with spans.trace() as t:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            for name in names:
                with span(name):
                    torch.ones(2) + 1
        with span("groth16.prove"):
            pass
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    got = {e["name"] for e in events if e.get("ph") == "X"
           and e.get("cat") == "user_annotation"}
    assert set(names) <= got
    found = t.spans()
    assert [s.profiled for s in found] == [True] * len(names) + [False]


def test_trace_joins_the_callers_and_a_span_may_take_one_late():
    """trace() inside an open trace joins it; a new one otherwise; a
    span's trace may be set before it closes."""
    with spans.trace() as outer:
        with spans.trace() as inner:
            with span("a"):
                pass
        with spans.trace("batch-7") as given:
            with span("b"):
                pass
        with span("c") as late:
            late.trace = "batch-8"
    with spans.trace() as other:
        pass
    assert inner.trace == outer.trace != other.trace
    assert given.trace == "batch-7"
    assert [s.name for s in outer.spans()] == ["a"]
    assert [s.name for s in given.spans()] == ["b"]
    assert late.trace == "batch-8" and late.parent is None


def test_ring_stays_at_its_bound():
    """More than RING spans filed: the ring keeps the newest RING."""
    made = [spans.Span(f"fill.{i % 3}") for i in range(spans.RING + 5)]
    for s in made:
        s.start_ns, s.end_ns = 1, 2
    spans.add(made, trace="fill")
    ring = spans.finished()
    assert len(ring) == spans.RING
    assert ring[-1] is made[-1] and ring[0] is made[5]


def test_recorder_and_witness_stage_import_no_torch():
    """The witness worker imports the witness stage: no torch with it."""
    code = ("import sys; import zkrollup_torch.spans, "
            "zkrollup_torch.witness.batch; "
            "print('torch' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": ROOT})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "False"


# -- the operator loop -------------------------------------------------------

CFG = RollupConfig(batch_size=1, tree_depth=4)
PRIV = 41516261718191101


class _Chain:
    """The daemon's state and contract in one: the tree with two funded
    accounts; roll_up takes `roll_up_s` seconds."""

    def __init__(self, roll_up_s=0.0):
        self.tree = create_merkle_tree(CFG.tree_depth)
        for k in (PRIV, PRIV + 1):
            leaf = {"publicKey": list(eddsa.gen_public_key(k)),
                    "balance": 10 ** 18, "nonce": 0}
            self.tree.insert_(hash_balance_tree_leaf(leaf), leaf)
        self.roll_up_s = roll_up_s

    def load_tree(self):
        return self.tree

    def roll_up(self, proof, public_signals):
        time.sleep(self.roll_up_s)

    def apply_rollup_batch(self, final_tree):
        self.tree = final_tree


class _SpanProver:
    """The real witness stage (in the daemon's worker) and a stand-in
    proof of `prove_s` seconds under groth16.prove and groth16.verify."""

    host_stage = staticmethod(prepare_fields)

    def __init__(self, prove_s=0.0):
        self.prove_s = prove_s

    def prove_prepared(self, prep):
        with span("groth16.prove"):
            time.sleep(self.prove_s)
        with span("groth16.verify"):
            pass
        return object()

    def prove_batch(self, tree, txs):
        fields = prepare_fields(CFG, tree, txs)
        self.prove_prepared(None)
        return object(), fields["public_signals"], fields["final_tree"]


def _queue(n):
    queue = TxQueue()
    for nonce in range(1, n + 1):
        tx = Transaction(0, 1, 10 ** 16, 10 ** 15, nonce)
        tx.signature = eddsa.sign(PRIV, format_tx(tx))
        queue.push(tx)
    return queue


def test_pipeline_files_each_batch_under_its_queue_index():
    """run_pipeline(max_batches=2): each batch's worker spans and its
    operator.wait_witness share the trace id of its first queue index;
    its witness.prepare (worker) ends before its wait (here) ends."""
    chain = _Chain()
    daemon = BatchDaemon(CFG, chain, _queue(2), _SpanProver(), chain)
    floor = spans.Span("unrecorded").id     # ids only grow, add()'s too
    try:
        assert daemon.run_pipeline(max_batches=2) == 2
    finally:
        daemon.close()
    found = [s for s in spans.finished() if s.id > floor]
    for index in (0, 1):
        mine = [s for s in found if s.trace == index]
        names = collections.Counter(s.name for s in mine)
        assert names == collections.Counter(
            [*WITNESS_SPANS, "operator.wait_witness", "groth16.prove",
             "groth16.verify"])
        by = {s.name: s for s in mine}
        assert by["witness.prepare"].end_ns < by["operator.wait_witness"].end_ns
        assert by["witness.synth"].parent == by["witness.prepare"].id
        assert by["synth.signature"].parent == by["witness.synth"].id
        assert by["synth.signature.replay"].parent == by["synth.signature"].id
    assert daemon.metrics.batches_proven == 2


@pytest.mark.parametrize("loop", ["step", "run_pipeline"])
def test_a_slow_roll_up_lowers_proofs_per_second(loop):
    """proofs_per_second: batches settled over the wall from the first
    prove's start to the last settle, so two roll_ups of 0.25 s hold it
    under 2 / 0.5 (prove seconds alone would give over 2 / 0.04);
    last_prove_seconds is the last batch's prove and verify spans."""
    chain = _Chain(roll_up_s=0.25)
    daemon = BatchDaemon(CFG, chain, _queue(2), _SpanProver(0.02), chain)
    try:
        if loop == "step":
            assert daemon.step() and daemon.step()
        else:
            assert daemon.run_pipeline(max_batches=2) == 2
    finally:
        daemon.close()
    m = daemon.metrics
    assert m.batches_proven == 2
    assert 0.02 <= m.last_prove_seconds < 0.25
    assert 0 < m.proofs_per_second <= 2 / 0.5
    assert m.snapshot()["proofs_per_second"] == m.proofs_per_second


def test_spans_of_concurrent_threads_keep_their_traces():
    """Two threads recording at once: each trace gets its own spans, each
    span's parent on its own thread."""
    def work(tag, out):
        with spans.trace(tag) as t:
            for _ in range(200):
                with span("outer"):
                    with span("inner"):
                        pass
        out[tag] = t.spans()
    out = {}
    threads = [threading.Thread(target=work, args=(f"thread-{i}", out))
               for i in range(4)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for th in threads:
            th.start()
        for th in threads:
            th.join(60)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads)
    for tag, found in out.items():
        assert len(found) == 400 and {s.trace for s in found} == {tag}
        ids = {s.id for s in found if s.name == "outer"}
        assert all(s.parent in ids for s in found if s.name == "inner")
