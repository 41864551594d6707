"""The MSM's windows in groups that fit the device (msm.window_groups), on
the CPU: the grouped window sums equal the one-group sums limb for limb,
for the fused four-table G1 MSM and for the G2 MSM, over 1, 2, 3 and W
groups (the last group smaller than the rest where the windows do not
divide); a proof made with the bound forced small equals the benchmark's
plain reference point for point and opens several groth16.msm_group spans
under each curve's stage; and the bound gives one group a curve at the
(2,6) batch circuit's sizes on an 80 GB card, and several at (15, 20).

The CPU has no bound of its own (msm._free_bytes is None there), so each
test forces one by standing in for msm._free_bytes with the memory that
makes the wanted group size.
"""

import collections
import json
import math
import os
import random

import numpy as np
import pytest
import torch

from rollbench.reference.groth16 import ProofReference
from zkrollup_torch import spans
from zkrollup_torch.curve import g1, g2
from zkrollup_torch.fields import limbs as L
from zkrollup_torch.groth16.prove import prove
from zkrollup_torch.groth16.setup import setup_host
from zkrollup_torch.msm import msm
from zkrollup_torch.native import engine
from zkrollup_torch.r1cs.builder import Builder
from zkrollup_torch.ref.bn254 import R as FR_MOD

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# four G1 tables, the largest keeping c = 8 unclamped: 32 windows, in 3
# groups of 11, 11 and 10
SIZES = (256, 40, 20, 60)
C1, W1 = 8, 32
# the G2 table's scalars below 2^32 at c = 4: 8 windows, in 3 groups of
# 3, 3 and 2
N2, BITS2, C2, W2 = 30, 32, 4, 8


def _scalars(n, seed):
    rng = random.Random(seed)
    vals = [rng.randrange(FR_MOD) for _ in range(n)]
    for i in range(0, n, 5):
        vals[i] = rng.randrange(3)
    return vals


def _free_for(n_windows_per_group, n_leaves, n_points):
    """The free memory that makes window_groups give that many windows."""
    need = (n_points * msm.LEAF_BYTES + (n_windows_per_group + 0.5)
            * msm.window_bytes(n_leaves, n_points))
    return need / msm.FREE_SHARE


def _force(monkeypatch, n_windows, n_groups, n_leaves, n_points):
    per = math.ceil(n_windows / n_groups)
    assert math.ceil(n_windows / per) == n_groups
    free = _free_for(per, n_leaves, n_points)
    assert msm.window_groups(n_windows, n_leaves, n_points, free) == per
    monkeypatch.setattr(msm, "_free_bytes", lambda device: free)


def _group_spans(run):
    with spans.trace() as t:
        out = run()
    return out, [s for s in t.spans() if s.name == "groth16.msm_group"]


@pytest.fixture(scope="module")
def g1_problem():
    ks = random.Random(3).sample(range(1, 1 << 30), sum(SIZES))
    ks[40:45] = ks[0:5]        # table 1 shares points with table 0
    x, y, inf = engine.g1_fixed_base_mont(engine.ints_to_fr_bytes(ks),
                                          len(ks))
    tables, s = [], 0
    for n in SIZES:
        tables.append((x[s:s + n], y[s:s + n], inf[s:s + n]))
        s += n
    (x, y, inf), bounds = msm.pack_tables(tables, chunk=16)
    sc = np.zeros((x.shape[0], 16), np.uint32)
    for t, (s, n) in enumerate(bounds):
        sc[s:s + n] = L.ints_to_limbs(_scalars(n, 10 + t))
    pts = (L.to_device(x, "cpu"), L.to_device(y, "cpu"),
           torch.from_numpy(inf))
    run = lambda: msm.multi_window_sums(g1.G1, pts, L.to_device(sc, "cpu"),
                                        C1, bounds, distinct=True, chunk=16)
    (whole, c), found = _group_spans(run)
    assert c == C1 and whole[0].shape[:2] == (W1, len(SIZES))
    assert len(found) == 1
    return run, x.shape[0], whole


@pytest.mark.parametrize("n_groups", [1, 2, 3, W1])
def test_grouped_g1_window_sums_equal_one_group(monkeypatch, g1_problem,
                                                n_groups):
    run, n_points, whole = g1_problem
    _force(monkeypatch, W1, n_groups, 1, n_points)
    (got, c), found = _group_spans(run)
    assert c == C1 and len(found) == n_groups
    for a, b in zip(got, whole):
        assert torch.equal(a, b)


@pytest.fixture(scope="module")
def g2_problem():
    ks = random.Random(5).sample(range(1, 1 << 30), N2)
    (x0, x1), (y0, y1), inf = engine.g2_fixed_base_mont(
        engine.ints_to_fr_bytes(ks), N2)
    d = lambda a: L.to_device(a, "cpu")
    pts = ((d(x0), d(x1)), (d(y0), d(y1)), torch.from_numpy(inf))
    sc = d(L.ints_to_limbs([v >> (254 - BITS2) for v in _scalars(N2, 6)]))
    run = lambda: msm.window_sums(g2.G2, pts, sc, c=C2, n_bits=BITS2,
                                  distinct=True, chunk=16)
    (whole, c), found = _group_spans(run)
    assert c == C2 and whole[0][0].shape[0] == W2 and len(found) == 1
    return run, 32, whole          # 30 points padded to 32


@pytest.mark.parametrize("n_groups", [1, 2, 3, W2])
def test_grouped_g2_window_sums_equal_one_group(monkeypatch, g2_problem,
                                                n_groups):
    run, n_points, whole = g2_problem
    _force(monkeypatch, W2, n_groups, 2, n_points)
    (got, c), found = _group_spans(run)
    assert c == C2 and len(found) == n_groups
    for a, b in zip(g2.G2.leaves(got), g2.G2.leaves(whole)):
        assert torch.equal(a, b)


def test_a_proof_in_groups_equals_the_plain_reference(monkeypatch):
    """prove(device="cpu"), the port's normal path, once as it runs (one
    group a curve) and once with the free memory forced down to three
    groups a curve: both proofs equal rollbench/reference's at pinned
    (r, s), and each curve's stage span holds its groups'
    groth16.msm_group spans."""
    bld = Builder()
    out = bld.alloc_output_deferred()
    y = bld.alloc_public_input(5)
    x = bld.alloc(3)
    bld.bind_output(out, bld.mul(bld.mul(x, x), x) + y)
    r1cs, witness = bld.r1cs(), bld.witness()
    seed = b"msm-groups"
    pk = setup_host(r1cs, seed=seed)
    ref = ProofReference(r1cs, seed)
    want = ref.proof(ref.scalars(witness), 11, 13)

    asked = []                 # (windows, leaves, points) of each MSM
    real = msm.window_groups

    def spy(n_windows, n_leaves, n_points, free):
        asked.append((n_windows, n_leaves, n_points))
        return real(n_windows, n_leaves, n_points, free)
    monkeypatch.setattr(msm, "window_groups", spy)
    for n_groups in (1, 3):
        with spans.trace() as t:
            proof = prove(pk, r1cs, witness, r=11, s=13, device="cpu", c=4)
        assert (proof.a, proof.b, proof.c) == want
        found = t.spans()
        by_id = {s.id: s for s in found}
        under = collections.Counter(by_id[s.parent].name for s in found
                                    if s.name == "groth16.msm_group")
        assert under == {"groth16.msm_g1": n_groups,
                         "groth16.msm_g2": n_groups}
        # the next proof: each MSM's free memory fits a third of its
        # windows
        frees = iter([_free_for(math.ceil(w / 3), leaves, n)
                      for w, leaves, n in asked[-2:]])
        assert [leaves for _, leaves, _ in asked[-2:]] == [1, 2]
        monkeypatch.setattr(msm, "_free_bytes", lambda device: next(frees))


def _config(name):
    with open(os.path.join(ROOT, "rollbench", "configs", f"{name}.json")) as f:
        return json.load(f)


def _msm_sizes(config):
    """(G1 points of the packed four tables, padded to the chunk; G2
    points padded to a power of two) from a configuration's counts."""
    g1_n = sum(config["msm_points"]["g1"].values())
    g2_n = config["msm_points"]["g2"]["b2"]
    return (-(-g1_n // msm.CHUNK) * msm.CHUNK,
            1 << (g2_n - 1).bit_length())


def test_b2_d6_takes_one_group_a_curve_on_80_gb():
    g1_n, g2_n = _msm_sizes(_config("tx_b2_d6"))
    assert msm.window_groups(22, 1, g1_n, 80e9) == 22
    assert msm.window_groups(22, 2, g2_n, 80e9) == 22


def test_b15_d20_g1_takes_several_groups_on_80_gb():
    """The G1 MSM at (15, 20) does not fit one group, each group holding
    several windows; its G2 MSM still fits one."""
    g1_n, g2_n = _msm_sizes(_config("tx_b15_d20"))
    per = msm.window_groups(22, 1, g1_n, 80e9)
    assert 2 <= per < 22
    assert msm.window_bytes(1, g1_n) * per <= 80e9 * msm.FREE_SHARE
    assert msm.window_groups(22, 2, g2_n, 80e9) == 22
