"""The port's stage labels, msm_multi_host_combine and measurement tools
(zkrollup_torch/tools/) against the reference, on the CPU at tiny sizes.

The labels: prove() under torch.profiler names its stages with the
reference's jax.named_scope strings, at the reference's places, in its
order, and its proof keeps its bytes. msm_multi_host_combine against the
reference's (jitted on the CPU, as its own tests run the MSM) and the
native engine. Each tool's run(): its rows and its checked result, the
trace tool's Chrome JSON with the four labels, the mesh check's circuits
equal to the reference tool's R1CS and witness. Each tool's entry point
refuses to run without a card unless asked for the CPU.

Every comparison is exact: points as affine points, proofs byte for byte
at pinned (r, s).
"""

import collections
import importlib.util
import json
import os
import random
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from zkrollup.curve import g1_jax
from zkrollup.msm import msm as jmsm
from zkrollup_torch.curve import g1
from zkrollup_torch.fields import limbs as L
from zkrollup_torch.groth16 import prove as P
from zkrollup_torch.groth16.setup import setup_host
from zkrollup_torch.msm import msm
from zkrollup_torch.native import engine
from zkrollup_torch.ref import bn254 as ref
from zkrollup_torch.tools import (common, mesh_prove_check, msm_sweep,
                                  profile_kernels, profile_msm,
                                  profile_msm2, profiler_drops,
                                  prove_breakdown, trace_prove)

# One intra-op thread per process: the suite runs in several worker
# processes, whose torch thread pools would otherwise fight for the cores.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LABELS = trace_prove.LABELS
# prove()'s spans beside the reference's four stage labels (spans.py)
HOST_SPANS = ("groth16.prove", "groth16.encode", "groth16.copy_wait",
              "groth16.combine_g1", "groth16.combine_g2", "groth16.blind")


@pytest.fixture(scope="module")
def toy():
    """The reference's 40-squaring circuit and a key for it."""
    r1cs, witness, publics = mesh_prove_check.build("toy")
    return setup_host(r1cs, seed=b"tools"), r1cs, witness, publics


@pytest.fixture(scope="module")
def traced(toy, tmp_path_factory):
    """trace_prove.run on the CPU: one proof outside the trace, one under
    torch.profiler(activities=[CPU])."""
    pk, r1cs, witness, publics = toy
    return trace_prove.run(pk, r1cs, witness, publics, "cpu",
                           str(tmp_path_factory.mktemp("trace")), "toy")


def test_prove_labels_its_stages_in_the_reference_order(toy, traced):
    """Each label once, in the order the reference enters its scopes; the
    traced proof's bytes equal the native engine's at the same (r, s)."""
    pk, r1cs, witness, _ = toy
    assert traced["order"] == list(LABELS)
    want = P.prove_host(pk, r1cs, witness, r=3, s=5)
    got = traced["proof"]
    assert (got.a, got.b, got.c) == (want.a, want.b, want.c)


def test_trace_json_holds_the_labels(traced):
    """The exported Chrome trace, read by trace_events (held against
    json.load below; the CPU trace of a proof is about a gigabyte), holds
    each label and each of prove()'s host spans once, groth16.copy_wait
    twice (G1 and G2)."""
    events = trace_prove.trace_events(traced["trace"])
    names = collections.Counter(e["name"] for e in events
                                if e.get("cat") == "user_annotation")
    assert names == collections.Counter(
        LABELS + HOST_SPANS + ("groth16.copy_wait",))
    rows = traced["rows"]
    # no device on the CPU: every row empty, nothing busy
    assert rows["_busy_us"] == 0
    assert all(rows[k]["count"] == 0
               for k in (*LABELS, trace_prove.UNLABELLED))
    assert any("groth16.msm_g1" in line
               for line in trace_prove.table(rows, traced["wall_s"]))
    # one window with no lead-in: nothing launched, nothing lost
    assert (traced["lead"], traced["lost"]) == (0, [0])


def test_trace_events_are_the_json_events_it_reads(tmp_path):
    """trace_events, which parses only the categories by_label and
    label_order read, against json.load of the whole trace."""
    from torch.profiler import ProfilerActivity, profile, record_function
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("groth16.quotient"):
            torch.ones(3) + 1
        with record_function("groth16.msm_g1"):
            torch.zeros(2).sum()
    path = str(tmp_path / "t.json")
    prof.export_chrome_trace(path)
    keep = {"user_annotation", "gpu_user_annotation",
            *trace_prove.DEVICE_CATS, *trace_prove.LAUNCH_CATS}
    with open(path) as f:
        want = [e for e in json.load(f)["traceEvents"]
                if e.get("ph") == "X" and e.get("cat") in keep]
    got = trace_prove.trace_events(path)
    assert got == want and len(got) == 2
    assert trace_prove.label_order(got) == ["groth16.quotient",
                                            "groth16.msm_g1"]


def _scopes(path, pattern):
    with open(os.path.join(ROOT, path)) as f:
        return collections.Counter(re.findall(pattern, f.read()))


@pytest.mark.parametrize("module", ["groth16/prove.py", "msm/msm.py"])
def test_label_names_and_places_match_the_reference(module):
    """The stage labels (spans) of each port module are the
    jax.named_scope strings of its reference module, as many times; the
    union is trace_prove's LABELS; its other spans are prove()'s host
    spans."""
    want = _scopes(f"zkrollup/{module}", r'jax\.named_scope\("([^"]+)"\)')
    got = _scopes(f"zkrollup_torch/{module}", r'\bspan\("([^"]+)"\)')
    assert +collections.Counter({k: n for k, n in got.items()
                                 if k in LABELS}) == want
    assert set(got) - set(LABELS) <= set(HOST_SPANS)
    every = set()
    for m in ("groth16/prove.py", "msm/msm.py"):
        every |= set(_scopes(f"zkrollup/{m}",
                             r'jax\.named_scope\("([^"]+)"\)'))
    assert every == set(LABELS)


def test_by_label_attributes_launches_by_correlation():
    """A kernel belongs to the innermost label open, on the launching
    thread, when its launch (same correlation id) ran; a kernel launched
    outside every label, or on another thread, to none; a lead-in spin
    kernel is counted apart and left out."""
    ev = lambda cat, name, ts, dur, tid=1, **args: {
        "ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
        "pid": 7, "tid": tid, "args": args}
    events = [
        ev("user_annotation", "groth16.quotient", 10, 20),
        ev("user_annotation", "groth16.msm_g1", 40, 30),
        ev("gpu_user_annotation", "groth16.msm_g1", 50, 25, tid=99),
        ev("cuda_runtime", "cudaLaunchKernel", 12, 1, correlation=1),
        ev("cuda_runtime", "cudaLaunchKernel", 45, 1, correlation=2),
        ev("cuda_runtime", "cudaMemcpyAsync", 50, 1, correlation=3),
        ev("cuda_runtime", "cudaLaunchKernel", 80, 1, correlation=4),
        ev("cuda_runtime", "cudaLaunchKernel", 46, 1, tid=2, correlation=5),
        ev("kernel", "ntt", 20, 5, tid=99, correlation=1),
        ev("kernel", "madd", 50, 10, tid=99, correlation=2),
        ev("gpu_memcpy", "Memcpy DtoH", 58, 4, tid=99, correlation=3),
        ev("kernel", "fill", 90, 2, tid=99, correlation=4),
        ev("kernel", "other", 95, 3, tid=99, correlation=5),
        ev("cuda_runtime", "cudaLaunchKernel", 41, 1, correlation=6),
        ev("kernel", "at::cuda::spin_kernel(long)", 42, 1, tid=99,
           correlation=6),
    ]
    rows = trace_prove.by_label(events)
    assert rows["groth16.quotient"]["us"] == 5
    assert rows["groth16.msm_g1"]["us"] == 14
    assert rows["groth16.msm_g1"]["count"] == 2
    assert rows["groth16.msm_g1"]["span_us"] == 25
    assert rows["groth16.msm_g1"]["names"]["madd"] == 10
    assert rows[trace_prove.UNLABELLED]["count"] == 2
    assert rows["groth16.spmv_abc"]["count"] == 0
    assert rows["_busy_us"] == 5 + 12 + 2 + 3     # the copy overlaps madd
    assert rows["_lead_in"] == 1                  # counted, left out


def _window_events(lead: int, dropped: int, work: int = 3):
    """Trace events of a window on a card: `lead` spin-kernel launches,
    then `work` kernel launches and a copy; the first `dropped` kernels
    lost, as the profiler loses them."""
    events = []
    for c in range(lead + work):
        events.append({"ph": "X", "cat": "cuda_runtime",
                       "name": "cudaLaunchKernel", "ts": c, "dur": 1,
                       "args": {"correlation": c}})
        if c >= dropped:
            name = "spin_kernel" if c < lead else f"work{c}"
            events.append({"ph": "X", "cat": "kernel", "name": name,
                           "ts": c + 1, "dur": 1,
                           "args": {"correlation": c}})
    events.append({"ph": "X", "cat": "cuda_runtime",
                   "name": "cudaMemcpyAsync", "ts": 99, "dur": 1,
                   "args": {"correlation": 99}})
    return events


@pytest.mark.parametrize("lead,dropped,lost", [
    (64, 0, 0), (64, 63, 0), (64, 64, 0), (64, 65, 1), (64, 70, 3),
    (0, 0, 0), (0, 2, 2)])
def test_lost_launches_counts_the_work_kernels_missing(lead, dropped, lost):
    """Only kernel launches after the lead-in count, each without a kernel
    of its correlation id; a copy's runtime call is no launch."""
    assert trace_prove.lost_launches(_window_events(lead, dropped),
                                     lead) == lost


@pytest.mark.parametrize("drops,leads", [
    ([0], [64]), ([70, 70], [64, 512]), ([70, 600, 600], [64, 512, 4096]),
    ([10 ** 6] * 4, None)])
def test_whole_window_lengthens_the_lead_in_until_nothing_is_lost(
        monkeypatch, drops, leads):
    """On a card whole_window opens each window with a lead-in LEAD_GROWTH
    times longer than the last while a work kernel was lost, and raises
    after ATTEMPTS windows."""
    made = []

    def window(dev, fn, path, lead):
        made.append(lead)
        return None, _window_events(lead, drops[len(made) - 1]), 0.5, fn()

    monkeypatch.setattr(trace_prove, "window", window)
    card = torch.device("cuda", 0)
    if leads is None:
        with pytest.raises(RuntimeError, match="lost kernels"):
            trace_prove.whole_window(card, lambda: 7, "unused")
        assert made == [64 * 8 ** i for i in range(trace_prove.ATTEMPTS)]
        return
    w = trace_prove.whole_window(card, lambda: 7, "unused")
    assert made == leads and w["lead"] == leads[-1] and w["out"] == 7
    assert w["lost"] == [trace_prove.lost_launches(
        _window_events(n, d), n) for n, d in zip(leads, drops)]
    assert w["lost"][-1] == 0


def test_launch_kept_is_in_launch_order():
    """One flag a kernel launch, ordered by correlation id whatever the
    events' order; copies and other runtime calls are no launches."""
    events = _window_events(2, 1, work=2)[::-1]
    assert trace_prove.launch_kept(events) == [False, True, True, True]


@pytest.mark.parametrize("mode", ["idle", "launch", "sessions"])
def test_profiler_drops_runs_its_windows_on_the_cpu(mode):
    """Eight windows, the six after the wait as listed in AFTER; on the
    CPU no launch, so nothing lost."""
    rows = profiler_drops.run(torch.device("cpu"), mode, wait=0.01)
    assert len(rows) == 2 + len(profiler_drops.AFTER)
    assert all((r["launches"], r["lost"], r["prefix"], r["work"])
               == (0, 0, True, 0) for r in rows)
    assert f"after {mode}" in rows[2]["what"]
    assert rows[4]["what"].endswith("a 20 ms spin first")


def _tables(sizes, seed):
    ks = random.Random(seed).sample(range(1, 1 << 30), sum(sizes))
    x, y, inf = engine.g1_fixed_base_mont(engine.ints_to_fr_bytes(ks),
                                          len(ks))
    out, s = [], 0
    for n in sizes:
        out.append((x[s:s + n], y[s:s + n], inf[s:s + n]))
        s += n
    return out


def test_msm_multi_host_combine_matches_reference_and_engine():
    sizes = (40, 23, 9, 17)
    tables = _tables(sizes, 3)
    (x, y, inf), bounds = msm.pack_tables(tables)
    jpts, jbounds = jmsm.pack_tables(tables)
    assert bounds == jbounds
    rng = np.random.RandomState(0)
    vals = [[int(v) for v in rng.randint(0, 1 << 62, size=n)] for n in sizes]
    sc = np.zeros((x.shape[0], L.N_LIMBS), np.uint32)
    for (s, n), v in zip(bounds, vals):
        sc[s:s + n] = L.ints_to_limbs(v)
    want = jmsm.msm_multi_host_combine(g1_jax.G1, jpts, jbounds,
                                       jnp.asarray(sc), c=4)
    got = msm.msm_multi_host_combine(g1.G1, common.on_device((x, y, inf),
                                                             "cpu"),
                                     bounds, L.to_device(sc, "cpu"), c=4)
    assert all(a.device.type == "cpu" for p in got for a in p)
    affine = [common.jacobian_affine(p) for p in got]
    assert affine == [common.jacobian_affine(
        [torch.from_numpy(np.asarray(a).astype(np.int32)) for a in p])
        for p in want]
    assert affine == [engine.g1_msm_pip(engine.pack_g1_table_mont(t),
                                        engine.ints_to_fr_bytes(v), len(v))
                      for t, v in zip(tables, vals)]


def test_prove_breakdown_stages_give_the_proof(toy):
    pk, r1cs, witness, _ = toy
    out = prove_breakdown.run(pk, r1cs, witness, "cpu", best_of=1, full=1)
    assert [label for label, _ in out["rows"]] == [
        "ints_to_limbs", "to_mont", "abc_evals (spmv x3)",
        "quotient (3 transforms)", "device_pack_g1 (cached after 1st)",
        "scalars_cat (segsum)", "fused G1 window sums",
        "device_pack_g2 (cached after 1st)", "g2 scalars segsum",
        "G2 window sums", "G1 host combines x4", "G2 host combine"]
    want = P.prove_host(pk, r1cs, witness, r=7, s=11)
    got = out["proof"]
    assert (got.a, got.b, got.c) == (want.a, want.b, want.c)
    assert len(out["full_s"]) == 1
    assert len(prove_breakdown.lines(out)) == len(out["rows"]) + 2


def test_profile_msm_rows_and_result():
    """(f) against zkrollup_torch.ref over the tool's points and scalars:
    the first 32 of its 64 seeded base points."""
    out = profile_msm.run("cpu", log_n=5, c=4, reps=1)
    assert [r[0][:3] for r in out["rows"]] == ["(b)", "(c)", "(d)", "(f)"]
    rnd = random.Random(1234)
    base = [ref.g1_mul(ref.G1_GEN, rnd.randrange(1, ref.R))
            for _ in range(64)]
    sc = L.limbs_to_ints(common.random_scalars(32, 1234))
    assert out["msm"] == ref.g1_msm(base[:32], sc)


@pytest.fixture
def points_cache(tmp_path, monkeypatch):
    """profile_msm2's and msm_sweep's distinct points cached in a
    temporary build directory."""
    monkeypatch.setattr(common, "BUILD_DIR", str(tmp_path))
    return tmp_path


@pytest.mark.parametrize("chunk", [16, 256])
def test_profile_msm2_rows_and_results(points_cache, chunk):
    """chunk 16 runs a multi-level scan over chunk totals; 256 pads every
    problem past its points (pack_tables, the scan's K = N)."""
    tables = (20, 11, 9, 17)
    out = profile_msm2.run("cpu", log_n=5, c=4, chunk=chunk, reps=1,
                           tables=tables)
    assert [r[0][:3] for r in out["rows"]] == ["(a)", "(b)"]
    assert out["rows"][1][3] == sum(tables)
    assert len(out["results"]["b"]) == len(tables)
    assert (points_cache / "msm_points" / "g1_32.npz").exists()
    x, y, inf = common.distinct_points(32, torch.device("cpu"))
    assert not inf.any()
    assert len({tuple(r) for r in np.concatenate([x, y], 1)}) == 32


@pytest.mark.parametrize("chunk", [16, 64, 256])
def test_msm_sweep_chunks(points_cache, chunk):
    out = msm_sweep.run("cpu", 4, chunk, 5, reps=1)
    want = common.engine_msm(common.distinct_points(32, "cpu"),
                             common.random_scalars(32, 1234))
    assert out["msm"] == want
    assert msm_sweep.line(out).startswith(
        f"c=4 chunk={chunk} log_n=5 compile=")


def test_profile_kernels_rows():
    out = profile_kernels.run("cpu", log_n=8, reps=1)
    assert len(out["rows"]) == 5
    assert 0 < out["whole"] <= out["buckets"]


def test_mesh_prove_check_on_two_shards():
    assert mesh_prove_check.run("toy", 2, "cpu", log=lambda m: None) \
        == "host"


def _reference_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"reference_{name}", os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("circuit", ["toy", "withdraw"])
def test_mesh_circuits_equal_the_reference_tool(circuit):
    r1cs, witness, publics = mesh_prove_check.build(circuit)
    jr1cs, jwitness, jpublics = _reference_tool("mesh_prove_check").build(
        circuit)
    assert r1cs.n_constraints == jr1cs.n_constraints
    assert (r1cs.n_vars, r1cs.n_outputs, r1cs.n_public_inputs) == (
        jr1cs.n_vars, jr1cs.n_outputs, jr1cs.n_public_inputs)
    assert r1cs.constraints == jr1cs.constraints
    assert (witness, publics) == (list(jwitness), list(jpublics))


def test_demo_batch_is_the_reference_batch():
    """The (2,6) batch of prove_breakdown and trace_prove --circuit tx:
    A sends 0.1 and 0.3 ETH to B with fees 0.01 and 0.02."""
    from zkrollup_torch.config import RollupConfig
    from zkrollup_torch.operator.prover import TxProver
    prover = TxProver(RollupConfig(), backend="host", device="cpu")
    _, prep = common.demo_batch("cpu", prover=prover)
    final = prep.final_tree.leaves_raw
    wei = 10 ** 18
    assert (final[0]["balance"], final[0]["nonce"], final[1]["balance"]) \
        == (wei - 43 * wei // 100, 2, wei + 4 * wei // 10)
    assert len(prep.witness) == prover.structure_r1cs().n_vars


@pytest.mark.parametrize("tool,argv", [
    (trace_prove, []), (prove_breakdown, []), (profile_msm, []),
    (profile_msm2, []), (msm_sweep, ["12", "128"]), (profile_kernels, []),
    (mesh_prove_check, []), (profiler_drops, [])])
def test_entry_points_need_a_card_or_the_cpu(monkeypatch, tool, argv):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        tool.main(argv)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool.main(argv + ["--device", "cuda:0"])
