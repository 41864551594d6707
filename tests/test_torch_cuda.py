"""zkrollup_torch's CUDA kernels on the card.

Each kernel wrapper against its plain PyTorch version on the same CUDA
tensors, bit for bit (the NTT pass with every prologue and epilogue, the
lazy-sum fold, the gathered mont_mul, the Fq and Fq2 inversions and
batch_inverse's one launch, the paired g2_add_z01's warp vote, the doubles
on ragged launches, the Horner kernels on its edge cases and against the
route of one double or add launch a step, and the integer-unit kernels of
tools/profile_alu.py too); the NTT, the quotient, the MSM window sums and the general MSM on
the card against the same functions on the CPU, one Horner launch and no
double a msm() call; the
bucket strategies and the GLV MSM against the native engine; the G2
point-kernel check; the field add and sub kernels and the MiMC sponge
kernel against their plain versions on ragged launches, with broadcast
operands and keys; a small setup on the card against the native engine's;
TxProver.prove_batch against prove_prepared; the witness's pinned
staging across proofs; the BatchProcessTx(2,6) proof against the native
engine; and the operator loop: a withdraw proof against the native
engine's, the pipelined batch daemon settling on the chain simulator, and
the provers' default device. Every test needs a CUDA
device and skips without one.

The file imports neither JAX nor the zkrollup package, so it runs where JAX
is not installed, as on the machine with the card (tests/conftest.py
imports JAX, hence --noconftest):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import random

import numpy as np
import pytest
import torch

from zkrollup_torch.curve import cuda_curve, g1, g2
from zkrollup_torch.fields import cuda_mont, limbs as L
from zkrollup_torch.fields.mont import FR, FQ
from zkrollup_torch.msm import msm
from zkrollup_torch.native import engine
from zkrollup_torch.ntt import ntt
from zkrollup_torch.ref import bn254 as ref

N = 64
CURVES = {
    "g1": (g1, ref.g1_mul, ref.g1_neg, ref.G1_GEN),
    "g2": (g2, ref.g2_mul, ref.g2_neg, ref.G2_GEN),
}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _values(p: int, n: int, seed: int) -> list:
    rng = np.random.RandomState(seed)
    words = rng.randint(0, 1 << 32, size=(n, 8), dtype=np.uint64)
    return [sum(int(w) << (32 * i) for i, w in enumerate(row)) % p
            for row in words]


def _limbs(vals, device):
    return L.to_device(L.ints_to_limbs(vals), device)


@pytest.mark.cuda
@pytest.mark.parametrize("F", [FR, FQ], ids=["fr", "fq"])
def test_mont_mul_kernel_matches_plain(cuda_device, F):
    """Random values plus 0, 1, p - 1, R mod p and, for a, 2^256 - 1 (the
    spmv fold hands the kernel values below 2^256 but not below p)."""
    edges = [0, 1, F.p - 1, F.r_mod_p]
    a = _limbs(_values(F.p, 124, 1) + edges + [(1 << 256) - 1] * 4,
               cuda_device)
    b = _limbs(_values(F.p, 124, 2) + edges[::-1] + edges, cuda_device)
    assert torch.equal(F.mont_mul(a, b), cuda_mont.mont_mul_plain(F, a, b))
    assert torch.equal(F.mont_mul(a, b[3]),
                       cuda_mont.mont_mul_plain(F, a, b[3]))


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 8, 64])
def test_butterfly_kernel_matches_plain(cuda_device, m):
    x = _limbs(_values(FR.p, 128, 3), cuda_device)
    tw = _limbs(_values(FR.p, m, 4), cuda_device)
    got, want = x.clone(), x.clone()
    cuda_mont.ntt_stage_(FR, got, tw, m)
    cuda_mont.ntt_stage_plain_(FR, want, tw, m)
    assert torch.equal(got, want)


def _ntt_operands(device, log_n, batch, seed):
    """(batch, 2^log_n, 16) random canonical values with 0, 1 and r - 1 in
    the first rows, and three (2^log_n, 16) tables."""
    n = 1 << log_n
    vals = _values(FR.p, batch * n, seed)
    vals[:3] = [0, 1, FR.p - 1]
    x = _limbs(vals, device).view(batch, n, 16)
    tabs = [_limbs(_values(FR.p, n, seed + k), device) for k in (1, 2, 3)]
    return x, tabs


# (log_n, s0, k, bitrev, pre, post, batch): whole transforms in two passes,
# later passes in place with strided sets, one-stage passes, the tables
NTT_PASSES = [
    (12, 0, 10, True, False, "none", 1),
    (12, 10, 2, False, False, "table", 3),
    (12, 0, 10, True, True, "bcast", 3),
    (13, 4, 6, False, False, "table", 1),
    (13, 12, 1, False, True, "none", 2),
    (12, 0, 1, True, False, "table", 1),
    (5, 0, 5, True, True, "table", 3),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", NTT_PASSES)
def test_ntt_pass_kernel_matches_plain(cuda_device, case):
    log_n, s0, k, bitrev, use_pre, post_kind, batch = case
    x, (tw, pre, post) = _ntt_operands(cuda_device, log_n, batch, 21)
    post = {"none": None, "table": post, "bcast": post[5]}[post_kind]
    kw = dict(bitrev=bitrev, pre=pre if use_pre else None, post=post)
    got = cuda_mont.ntt_pass(FR, x, tw, s0, k, **kw)
    want = cuda_mont.ntt_pass_plain(FR, x, tw, s0, k, **kw)
    assert torch.equal(got, want)
    if not bitrev:                          # in place
        y = x.clone()
        cuda_mont.ntt_pass(FR, y, tw, s0, k, out=y, **kw)
        assert torch.equal(y, want)


@pytest.mark.cuda
def test_ntt_pass_pointwise_prologue_matches_plain(cuda_device):
    """The quotient's first coset-iNTT pass: (x * b - c) * z on each row
    as it is gathered, the plain-form post table on the way out."""
    x, (tw, b, post) = _ntt_operands(cuda_device, 12, 1, 31)
    c = _limbs(_values(FR.p, 1 << 12, 35), cuda_device)
    z = _limbs(_values(FR.p, 1, 36), cuda_device)[0]
    pw = (b, c, z)
    for s0, k, kw in ((0, 10, dict(bitrev=True, pointwise=pw)),
                      (0, 12 - 10, dict(bitrev=True, pointwise=pw,
                                        post=post))):
        got = cuda_mont.ntt_pass(FR, x[0], tw, s0, k, **kw)
        want = cuda_mont.ntt_pass_plain(FR, x[0], tw, s0, k, **kw)
        assert torch.equal(got, want)


@pytest.mark.cuda
def test_fold_kernel_matches_plain(cuda_device):
    """Random lazy sums of up to 300 canonical terms a limb, and the edge
    rows V = 0, V = 2^288 - 1 and V = 5 r (V = 0 mod r)."""
    rng = np.random.RandomState(8)
    sums = torch.from_numpy(rng.randint(0, 300 * 65536, size=(4096, 16))
                            .astype(np.int64))
    sums[0] = 0
    sums[1, :15] = 0xFFFF
    sums[1, 15] = (1 << 48) - 1
    sums[2] = torch.from_numpy(L.ints_to_limbs([5 * FR.p]).astype(np.int64))
    sums = sums.to(cuda_device)
    got = cuda_mont.fold(FR, sums)
    assert torch.equal(got, cuda_mont.fold_plain(FR, sums))
    assert L.limbs_to_ints(got[:3]) == [0, ((1 << 288) - 1) % FR.p, 0]


@pytest.mark.cuda
@pytest.mark.parametrize("F", [FR, FQ], ids=["fr", "fq"])
def test_mont_mul_gather_kernel_matches_plain(cuda_device, F):
    a = _limbs(_values(F.p, 3000, 9), cuda_device)
    b = _limbs(_values(F.p, 700, 10), cuda_device)
    idx = torch.from_numpy(np.random.RandomState(11).randint(
        0, 700, size=3000)).to(cuda_device)
    assert torch.equal(F.mont_mul(a, b, idx),
                       cuda_mont.mont_mul_gather_plain(F, a, b, idx))


@pytest.mark.cuda
def test_kernel_wrappers_reject_bad_operands(cuda_device):
    a = torch.zeros((8, 16), dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError):
        FR.mont_mul(a.to(torch.int64), a)          # dtype
    with pytest.raises(ValueError):
        FR.mont_mul(a, a[:4])                      # shape
    with pytest.raises(ValueError):
        FR.mont_mul(a.T.contiguous().T, a)         # contiguity
    with pytest.raises(ValueError):
        FR.mont_mul(a, a.cpu())                    # device
    with pytest.raises(ValueError):
        cuda_mont.ntt_stage_(FR, a, a[:2], 4)      # twiddle table size
    with pytest.raises(ValueError):                # gather in place
        cuda_mont.ntt_pass(FR, a, a, 0, 3, out=a, bitrev=True)
    with pytest.raises(ValueError):                # stages past n
        cuda_mont.ntt_pass(FR, a, a, 2, 2)
    with pytest.raises(ValueError):                # int32 sums
        cuda_mont.fold(FR, a)
    with pytest.raises(ValueError):                # int32 index
        FR.mont_mul(a, a, torch.zeros(8, dtype=torch.int32,
                                      device=cuda_device))
    p = g1.G1.infinity((8,), cuda_device)
    with pytest.raises(ValueError):
        g1.G1.add(p, g1.G1.infinity((4,), cuda_device))


def _point_operands(name, device):
    """(p, q) batches of N lanes on `device`, p with Z != 1. Lanes: 0 P + P,
    1 P + (-P), 2 inf + Q, 3 P + inf, 4 inf + inf, the rest random."""
    mod, mul, neg, gen = CURVES[name]
    rng = random.Random(5)
    pts = lambda: [mul(gen, rng.randrange(1, ref.R)) for _ in range(N)]
    pa, qa, ra = pts(), pts(), pts()
    qa[0] = pa[0]
    qa[1] = neg(pa[1])
    pa[2], qa[3], pa[4], qa[4] = None, None, None, None
    curve = mod.G1 if name == "g1" else mod.G2
    # p = (p - r) + r: the same points with Z != 1 (plain adds on the CPU)
    p = curve.add(curve.add(mod.pack_jacobian_host(pa),
                            mod.pack_jacobian_host([neg(r) for r in ra])),
                  mod.pack_jacobian_host(ra))
    q = mod.pack_jacobian_host(qa)
    to = lambda t: curve.map(lambda a: a.to(device), t)
    return curve, to(p), to(q)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["g1", "g2"])
def test_point_kernels_match_plain(cuda_device, name):
    curve, p, q = _point_operands(name, cuda_device)
    got, want = (curve.leaves(f(curve, p, q))
                 for f in (cuda_curve.add, cuda_curve.add_plain))
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    # the mixed add with the doubling path: every lane, P + P included
    got, want = (curve.leaves(f(curve, p, q))
                 for f in (cuda_curve.madd, cuda_curve.madd_plain))
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    # the double, of p (Z != 1, lanes 2 and 4 infinity) and of q (Z = 1)
    for pt in (p, q):
        got, want = (curve.leaves(f(curve, pt))
                     for f in (cuda_curve.double, cuda_curve.double_plain))
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    # the double on one lane: infinity (lane 2) and a finite point (lane 5)
    for k in (2, 5):
        one = curve.map(lambda a: a[k:k + 1].contiguous(), p)
        got, want = (curve.leaves(f(curve, one))
                     for f in (cuda_curve.double, cuda_curve.double_plain))
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    # the add without the doubling path: every lane, P + P included
    # (outside its contract, but the kernel and the plain version agree)
    got, want = (curve.leaves(f(curve, p, q))
                 for f in (cuda_curve.add_nd, cuda_curve.add_nd_plain))
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    # the add of Z in {0, 1} operands, against q: P + P, P + (-P),
    # inf + Q, P + inf, inf + inf
    z01 = _z01_operand(curve, q)
    got, want = (curve.leaves(f(curve, z01, q))
                 for f in (cuda_curve.add_z01, cuda_curve.add_z01_plain))
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    # the no-double mixed add: every lane but P + P (its contract)
    pm, qm = (curve.map(lambda a: a[1:].contiguous(), t) for t in (p, q))
    got, want = (curve.leaves(f(curve, pm, qm))
                 for f in (cuda_curve.madd_nd, cuda_curve.madd_nd_plain))
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    # the add, the no-double mixed add and the double (two threads a lane
    # over G2) at odd and tiny lane counts, where a ragged edge cuts a
    # warp: the lanes above, repeated
    for m in (1, 22, 33, 1025):
        for f, plain, args in ((cuda_curve.add, cuda_curve.add_plain, (p, q)),
                               (cuda_curve.madd_nd, cuda_curve.madd_nd_plain,
                                (pm, qm)),
                               (cuda_curve.double, cuda_curve.double_plain,
                                (p,))):
            n = curve.leaves(args[0])[0].shape[0]
            idx = torch.arange(m, device=cuda_device) % n
            sub = [curve.map(lambda a: a.index_select(0, idx), t)
                   for t in args]
            got, want = (curve.leaves(g(curve, *sub)) for g in (f, plain))
            assert all(torch.equal(a, b) for a, b in zip(got, want)), m


def _horner_cases(curve, p):
    """Window sums for the Horner kernels, {label: (wsum, c)}, from p
    (Z != 1; lanes 5.. distinct, lane 4 infinity): W = 1, W = 3 at small
    c, infinity windows at the top, the middle and the bottom, every
    window infinity, W_1 = 2^c res in other limbs (the add's doubling
    path), W_1 = -(2^c res) and, last, W_0 = -(2^c res)."""
    rows = lambda *idx: curve.map(lambda a: a[list(idx)].contiguous(), p)
    cat = lambda *pts: curve.map(lambda *a: torch.cat(a).contiguous(), *pts)
    c = 5
    twice = rows(5)
    for _ in range(c):
        twice = cuda_curve.double_plain(curve, twice)
    other = cuda_curve.add_plain(curve, cuda_curve.add_plain(
        curve, twice, curve.neg(rows(8))), rows(8))
    return {
        "W=1": (rows(5), c),
        "W=3, c=1": (rows(5, 6, 7), 1),
        "infinity windows": (rows(4, 5, 6, 4, 7, 4, 4), 2),
        "every window infinity": (rows(4, 4), c),
        "doubling path": (cat(rows(7), other, rows(5)), c),
        "P + (-P)": (cat(rows(7), curve.neg(twice), rows(5)), c),
        "P + (-P) last": (cat(curve.neg(twice), rows(5)), c),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["g1", "g2"])
def test_horner_matches_plain(cuda_device, name):
    """g1_horner and g2_horner against horner_plain on the edge cases,
    Jacobian limbs, and against c double and one add launch a window (the
    route msm took before the Horner kernels)."""
    curve, p, _ = _point_operands(name, cuda_device)
    for label, (wsum, c) in _horner_cases(curve, p).items():
        got = curve.leaves(cuda_curve.horner(curve, wsum, c))
        want = curve.leaves(cuda_curve.horner_plain(
            curve, curve.map(lambda a: a.cpu(), wsum), c))
        assert all(torch.equal(a.cpu(), b) for a, b in zip(got, want)), label
        res = curve.infinity((1,), cuda_device)
        for w in range(curve.leaves(wsum)[0].shape[0] - 1, -1, -1):
            for _ in range(c):
                res = cuda_curve.double(curve, res)
            res = cuda_curve.add(curve, res, curve.map(
                lambda a: a[w:w + 1].contiguous(), wsum))
        assert all(torch.equal(a, b[0]) for a, b in
                   zip(got, curve.leaves(res))), label


VOTE_CASES = ["one_p_plus_p", "inf_plus_inf", "ragged_33", "ragged_1025"]
# lanes a warp holds: one thread a G1 lane, two a G2 lane (thread pairs)
WARP_LANES = {"g1": 32, "g2": 16}


def _vote_lanes(case: str, warp: int) -> list:
    """Lanes of _point_operands for a warp-vote case: a warp of distinct
    pairs and one P + P lane, a warp of infinity + infinity only (H = R = 0
    on every lane, no doubling), or a launch of 33 or 1,025 lanes whose
    P + P lane is in the ragged last warp."""
    distinct = list(range(5, N))            # lanes 5.. are distinct pairs
    if case == "one_p_plus_p":
        k = warp // 2 + 1
        return distinct[:k] + [0] + distinct[k:warp - 1]
    if case == "inf_plus_inf":
        return [4] * warp
    m = int(case.split("_")[1])
    return [distinct[k % len(distinct)] for k in range(m - 1)] + [0]


def _check_on_lanes(curve, fn, plain, p, q, idx):
    sub = [curve.map(lambda a: a.index_select(0, idx), t) for t in (p, q)]
    got, want = (curve.leaves(f(curve, *sub)) for f in (fn, plain))
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("case", VOTE_CASES)
def test_g1_add_vote_matches_plain(cuda_device, case):
    """g1_add runs the doubling path only in warps with a P == Q lane of
    finite points: a warp of 31 distinct pairs and one P + P lane, a warp
    of infinity + infinity only (H = R = 0 on every lane, no doubling), and
    launches of 33 and 1,025 lanes whose P + P lane is in the ragged last
    warp; bit for bit against the plain version."""
    curve, p, q = _point_operands("g1", cuda_device)
    idx = torch.tensor(_vote_lanes(case, 32), device=cuda_device)
    _check_on_lanes(curve, cuda_curve.add, cuda_curve.add_plain, p, q, idx)


@pytest.mark.cuda
@pytest.mark.parametrize("case", VOTE_CASES)
@pytest.mark.parametrize("name", ["g1", "g2"])
def test_madd_vote_matches_plain(cuda_device, name, case):
    """g1_madd and g2_madd (on thread pairs, 16 lanes a warp) run the
    doubling path only in warps with a P == Q lane of finite points: the
    cases of test_g1_add_vote_matches_plain at each kernel's warp; bit for
    bit against the plain version."""
    curve, p, q = _point_operands(name, cuda_device)
    idx = torch.tensor(_vote_lanes(case, WARP_LANES[name]),
                       device=cuda_device)
    _check_on_lanes(curve, cuda_curve.madd, cuda_curve.madd_plain, p, q, idx)


@pytest.mark.cuda
@pytest.mark.parametrize("name,m", [("g1", 482_413), ("g2", 117_114),
                                    ("g1", 22_528), ("g2", 22_528)])
def test_madd_wide_matches_plain(cuda_device, name, m):
    """g1_madd and g2_madd at the (2,6) setup's lanes a launch (its G1 and
    G2 tables, one chunk each) and at the msm paths' 22,528: the point
    operands repeated (P + P lanes in many warps), then lanes 1.. of them
    (no lane on the doubling path, as in the setup); bit for bit against
    the plain version."""
    curve, p, q = _point_operands(name, cuda_device)
    idx = torch.arange(m, device=cuda_device)
    for lanes in (idx % N, idx % (N - 1) + 1):
        _check_on_lanes(curve, cuda_curve.madd, cuda_curve.madd_plain, p, q,
                        lanes)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [67_584, 74_492])
def test_g1_madd_nd_wide_matches_plain(cuda_device, m):
    """g1_madd_nd at one wave of 16 warps an SM (67,584 lanes) and at the
    (2,6) proof's lanes a launch (74,492): lanes 1.. of the point operands
    (every case but P + P, the kernel's contract), repeated; bit for bit
    against the plain version."""
    curve, p, q = _point_operands("g1", cuda_device)
    idx = torch.arange(m, device=cuda_device) % (N - 1) + 1
    sub = [curve.map(lambda a: a.index_select(0, idx), t) for t in (p, q)]
    got, want = (curve.leaves(f(curve, *sub))
                 for f in (cuda_curve.madd_nd, cuda_curve.madd_nd_plain))
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def _z01_operand(curve, q):
    """Affine-or-infinity points against q (Z in {0, 1}): q rolled by one
    lane, then lane 0 = q (P + P), lane 1 = -q (P + (-P)), lanes 2 and 4
    infinity (inf + Q, inf + inf); q's lane 3 is infinity (P + inf)."""
    z = curve.map(lambda a: a.roll(1, dims=0).contiguous(), q)
    neg_q = curve.neg(q)
    for d, s0, s1 in zip(curve.leaves(z), curve.leaves(q),
                         curve.leaves(neg_q)):
        d[0], d[1], d[2], d[4] = s0[0], s1[1], 0, 0
    return z


@pytest.mark.cuda
@pytest.mark.parametrize("case", VOTE_CASES + ["one_p_minus_p", "wide"])
def test_g2_add_z01_vote_matches_plain(cuda_device, case):
    """g2_add_z01 on thread pairs runs the affine double only in warps (16
    lanes) with a P == Q lane of finite points: the vote cases against q
    and _z01_operand's Z in {0, 1} points, a warp of distinct pairs with
    one P + (-P) lane, and 1,441,792 lanes (the msm paths' leaf level:
    every case repeated); bit for bit against the plain version."""
    curve, _, q = _point_operands("g2", cuda_device)
    z01 = _z01_operand(curve, q)
    if case == "wide":
        idx = torch.arange(1_441_792, device=cuda_device) % N
    elif case == "one_p_minus_p":
        idx = torch.tensor(_vote_lanes("one_p_plus_p", 16), device=cuda_device)
        idx[idx == 0] = 1
    else:
        idx = torch.tensor(_vote_lanes(case, 16), device=cuda_device)
    sub = [curve.map(lambda a: a.index_select(0, idx), t) for t in (z01, q)]
    got, want = (curve.leaves(f(curve, *sub))
                 for f in (cuda_curve.add_z01, cuda_curve.add_z01_plain))
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def _inv_operand(n, seed, device):
    """n canonical Fq values, Montgomery form: random, 0, 1, q - 1 and
    R mod q in rows 1-4, every third lane of the first 64 zero, and zero
    the lanes of thread 1 at 16 lanes a thread (lanes 1 + j T, T the
    thread count)."""
    vals = _values(FQ.p, n, seed)
    vals[1:5] = [0, 1, FQ.p - 1, FQ.r_mod_p][:max(0, n - 1)]
    T = -(-n // 16)
    for i in list(range(0, min(n, 64), 3)) + list(range(min(1, T - 1), n,
                                                        T)):
        vals[i] = 0
    return _limbs(vals, device)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["fq", "fq2"])
@pytest.mark.parametrize("n", [1, 22, 33, 1025, 482_413])
def test_inv_kernels_match_plain(cuda_device, kind, n):
    """inv[fq] (FQ.mont_inv) and inv[fq2] (fq2.inv) on CUDA tensors: one
    launch each, bit for bit against the plain versions (Fermat over the
    plain product) on one lane, ragged launches and the setup's G1 width;
    zero lanes map to zero."""
    from zkrollup_torch import kernels
    from zkrollup_torch.fields import fq2
    a0 = _inv_operand(n, 7, cuda_device)
    kernels.reset_launches()
    if kind == "fq":
        got = [FQ.mont_inv(a0)]
        want = [cuda_mont.inv_plain(FQ, a0)]
    else:
        a1 = _inv_operand(n, 8, cuda_device)
        a1[5::7] = 0
        got = list(fq2.inv((a0, a1)))
        want = list(cuda_mont.inv_fq2_plain(FQ, (a0, a1)))
    assert kernels.LAUNCHES[f"inv[{kind}]"] == 1
    assert kernels.LAUNCHES["mont_mul[fq]"] == 0
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["g1", "g2"])
def test_batch_inverse_on_cuda_is_one_launch(cuda_device, name):
    """weierstrass.batch_inverse on CUDA: one inversion launch over the m
    lanes (no product tree, no padding), the limbs of the plain product
    tree on the CPU."""
    from zkrollup_torch import kernels
    from zkrollup_torch.curve import weierstrass as W
    F = W.FqOps if name == "g1" else W.Fq2Ops
    m = 1000
    leaves = [_limbs([v or 1 for v in _values(FQ.p, m, 9 + k)], "cpu")
              for k in range(len(F.leaves(F.zeros((1,), "cpu"))))]
    d = F.from_leaves(leaves)
    want = F.leaves(W.batch_inverse(F, d))
    kernels.reset_launches()
    got = F.leaves(W.batch_inverse(F, F.from_leaves(
        [a.to(cuda_device) for a in leaves])))
    assert kernels.LAUNCHES["inv[fq]" if name == "g1" else "inv[fq2]"] == 1
    assert kernels.LAUNCHES["mont_mul[fq]"] == 0
    assert all(torch.equal(g.cpu(), w) for g, w in zip(got, want))


@pytest.mark.cuda
def test_ntt_on_cuda_matches_cpu(cuda_device):
    a = L.to_device(FR.to_mont_host(_values(FR.p, 1 << 10, 6)), "cpu")
    for fn in (ntt.intt_mont, ntt.coset_ntt_mont, ntt.coset_intt_mont):
        assert torch.equal(fn(a.to(cuda_device)).cpu(), fn(a))


@pytest.mark.cuda
def test_quotient_on_cuda_matches_cpu(cuda_device):
    from zkrollup_torch.groth16 import prove as P
    evals = [L.to_device(FR.to_mont_host(_values(FR.p, 1 << 10, 40 + k)),
                         "cpu") for k in range(3)]
    zinv = FR.const_mont(12345, "cpu")
    want = P._quotient_plain(*evals, zinv)
    got = P._quotient_plain(*(e.to(cuda_device) for e in evals),
                            zinv.to(cuda_device))
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_window_sums_on_cuda_match_cpu(cuda_device):
    """Four G1 tables at c = 8 through the fused scan. The kernels and the
    plain versions follow one formula, so the window sums agree limb for
    limb, not only as affine points."""
    sizes = (256, 70, 33, 97)
    ks = random.Random(7).sample(range(1, 1 << 30), sum(sizes))
    x, y, inf = engine.g1_fixed_base_mont(engine.ints_to_fr_bytes(ks),
                                          len(ks))
    tables, s = [], 0
    for n in sizes:
        tables.append((x[s:s + n], y[s:s + n], inf[s:s + n]))
        s += n
    (px, py, pinf), bounds = msm.pack_tables(tables)
    sc = np.zeros((px.shape[0], 16), np.uint32)
    for t, (s, n) in enumerate(bounds):
        sc[s:s + n] = L.ints_to_limbs(_values(FR.p, n, 10 + t))
    run = lambda dev: msm.multi_window_sums(
        g1.G1, (L.to_device(px, dev), L.to_device(py, dev),
                torch.from_numpy(pinf).to(dev)),
        L.to_device(sc, dev), 8, bounds, distinct=True)[0]
    got, want = run(cuda_device), run("cpu")
    assert all(torch.equal(a.cpu(), b) for a, b in zip(got, want))


def _dup_table(curve, n, seed):
    """A table of n affine points with 8 duplicates and two infinity rows,
    and its scalars, as tensors on the CPU."""
    ks = random.Random(seed).sample(range(1, 1 << 30), n)
    ks[n // 2:n // 2 + 8] = ks[:8]
    if curve is g1.G1:
        x, y, inf = engine.g1_fixed_base_mont(engine.ints_to_fr_bytes(ks), n)
        planes = [x, y]
    else:
        (x0, x1), (y0, y1), inf = engine.g2_fixed_base_mont(
            engine.ints_to_fr_bytes(ks), n)
        planes = [x0, x1, y0, y1]
    for a in planes:
        a[3:5] = 0
    inf[3:5] = True
    t = [L.to_device(a, "cpu") for a in planes]
    k = len(t) // 2
    pts = (curve.F.from_leaves(t[:k]), curve.F.from_leaves(t[k:]),
           torch.from_numpy(inf))
    sc = L.to_device(L.ints_to_limbs(_values(FR.p, n, seed + 1)), "cpu")
    return pts, sc


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["g1", "g2"])
def test_general_msm_on_cuda_matches_cpu(cuda_device, name):
    """msm(distinct=False) over a table with duplicate points: the madd
    kernels in the scan leg, one launch of the Horner kernel and no
    double."""
    from zkrollup_torch import kernels
    curve = g1.G1 if name == "g1" else g2.G2
    (x, y, inf), sc = _dup_table(curve, 200, 11)
    on = lambda v: curve.F.from_leaves([a.to(cuda_device)
                                        for a in curve.F.leaves(v)])
    kernels.reset_launches()
    got = msm.msm(curve, (on(x), on(y), inf.to(cuda_device)),
                  sc.to(cuda_device), c=6)
    assert kernels.LAUNCHES[f"{name}_horner"] == 1
    assert kernels.LAUNCHES["g1_double"] == kernels.LAUNCHES["g2_double"] == 0
    want = msm.msm(curve, (x, y, inf), sc, c=6)
    assert all(torch.equal(a.cpu(), b)
               for a, b in zip(curve.leaves(got), curve.leaves(want)))


@pytest.mark.cuda
def test_setup_on_cuda_equals_setup_host(cuda_device):
    """A small circuit: the key made on the card equals the native
    engine's byte for byte (tables, single points and verifying key)."""
    from zkrollup_torch.groth16.setup import setup, setup_host
    from zkrollup_torch.r1cs.builder import Builder
    bld = Builder()
    out = bld.alloc_output_deferred()
    y = bld.alloc_public_input(5)
    x = bld.alloc(3)
    acc = x
    for _ in range(40):
        acc = bld.mul(acc, x)
    bld.bind_output(out, acc + y)
    got = setup(bld.r1cs(), seed=b"cuda-setup", device=cuda_device)
    want = setup_host(bld.r1cs(), seed=b"cuda-setup")
    for f in ("a_g1", "b1_g1", "c_g1", "h_g1", "b2_g2"):
        flat = lambda t: [v for c in t for v in
                          (c if isinstance(c, tuple) else (c,))]
        assert all(u.dtype == v.dtype and u.tobytes() == v.tobytes()
                   for u, v in zip(flat(getattr(got, f)),
                                   flat(getattr(want, f)))), f
    assert got.vk == want.vk
    assert (got.alpha1, got.beta1, got.delta1, got.beta2, got.delta2) == \
        (want.alpha1, want.beta1, want.delta1, want.beta2, want.delta2)


@pytest.mark.slow
@pytest.mark.cuda
def test_tx_2_6_proof_on_cuda_equals_native_engine(cuda_device):
    """The production circuit: the duplicate points of the real key tables
    exercise the no-double kernels' distinct contract."""
    from zkrollup_torch.config import RollupConfig
    from zkrollup_torch.groth16.prove import prove_host
    from zkrollup_torch.operator.prover import TxProver
    from zkrollup_torch.ref import eddsa
    from zkrollup_torch.tree.merkle import create_merkle_tree
    from zkrollup_torch.witness.assembler import (Transaction, format_tx,
                                                  hash_balance_tree_leaf)
    priv = 41516261718191101
    prover = TxProver(RollupConfig(), setup_seed=b"zkrollup-test-seed",
                      device=cuda_device)
    pk = prover.ensure_keys()
    tree = create_merkle_tree(6)
    for k in (priv, priv + 1):
        leaf = {"publicKey": list(eddsa.gen_public_key(k)),
                "balance": 10 ** 18, "nonce": 0}
        tree.insert_(hash_balance_tree_leaf(leaf), leaf)
    txs = []
    for nonce in (1, 2):
        tx = Transaction(0, 1, 10 ** 17, 10 ** 15, nonce)
        tx.signature = eddsa.sign(priv, format_tx(tx))
        txs.append(tx)
    prep = prover.prepare_batch(tree, txs)
    proof = prover.prove_prepared(prep, r=5, s=6)   # raises unless it verifies
    want = prove_host(pk, prover.structure_r1cs(), prep.witness, r=5, s=6)
    assert (proof.a, proof.b, proof.c) == (want.a, want.b, want.c)


def _tx_batch(prover, priv):
    """Two signed transfers between two funded accounts, prepared."""
    from zkrollup_torch.ref import eddsa
    from zkrollup_torch.tree.merkle import create_merkle_tree
    from zkrollup_torch.witness.assembler import (Transaction, format_tx,
                                                  hash_balance_tree_leaf)
    cfg = prover.cfg
    tree = create_merkle_tree(cfg.tree_depth)
    for k in (priv, priv + 1):
        leaf = {"publicKey": list(eddsa.gen_public_key(k)),
                "balance": 10 ** 18, "nonce": 0}
        tree.insert_(hash_balance_tree_leaf(leaf), leaf)
    txs = []
    for nonce in range(1, cfg.batch_size + 1):
        tx = Transaction(0, 1, 10 ** 17, 10 ** 15, nonce)
        tx.signature = eddsa.sign(priv, format_tx(tx))
        txs.append(tx)
    return tree, txs


@pytest.mark.cuda
def test_prove_batch_on_cuda_equals_prove_prepared(cuda_device):
    """BatchProcessTx(1, 4): prove_batch at pinned (r, s) gives
    prove_prepared's proof bytes, its public signals and its final tree,
    and the native engine's proof; the prover's stages are the proof's
    spans."""
    from zkrollup_torch.config import RollupConfig
    from zkrollup_torch.groth16.prove import prove_host
    from zkrollup_torch.operator.prover import TxProver
    prover = TxProver(RollupConfig(batch_size=1, tree_depth=4),
                      setup_seed=b"zkrollup-test-seed", device=cuda_device)
    tree, txs = _tx_batch(prover, 41516261718191101)
    proof, signals, final = prover.prove_batch(tree, txs, r=5, s=6)
    prep = prover.prepare_batch(tree, txs)
    want = prover.prove_prepared(prep, r=5, s=6)
    host = prove_host(prover.pk, prover.structure_r1cs(), prep.witness,
                      r=5, s=6)
    assert (proof.a, proof.b, proof.c) == (want.a, want.b, want.c)
    assert (proof.a, proof.b, proof.c) == (host.a, host.b, host.c)
    assert signals == prep.public_signals
    assert final.root == prep.final_tree.root
    assert set(prover.stats.stages) == {
        "groth16.prove", "groth16.encode", "groth16.spmv_abc",
        "groth16.quotient", "groth16.msm_g1", "groth16.msm_g2",
        "groth16.copy_wait", "groth16.combine_g1", "groth16.combine_g2",
        "groth16.blind", "groth16.verify", "groth16.msm_group"}
    assert prover.stats.stages["groth16.msm_group"] > 0


@pytest.mark.cuda
def test_prove_in_window_groups_on_cuda(cuda_device, monkeypatch):
    """BatchProcessTx(1, 4) with the card's free memory standing in at a
    third of what each MSM's windows take: three groth16.msm_group spans
    under each curve's stage, and the native engine's proof bytes; the
    prover's next proof, at the card's own free memory, one group a
    curve and the same bytes."""
    import collections
    import math
    from zkrollup_torch import spans
    from zkrollup_torch.config import RollupConfig
    from zkrollup_torch.groth16.prove import prove_host
    from zkrollup_torch.operator.prover import TxProver
    prover = TxProver(RollupConfig(batch_size=1, tree_depth=4),
                      setup_seed=b"zkrollup-test-seed", device=cuda_device)
    prep = prover.prepare_batch(*_tx_batch(prover, 41516261718191101))
    want = prove_host(prover.ensure_keys(), prover.structure_r1cs(),
                      prep.witness, r=5, s=6)
    sizes = []
    real = msm.window_groups

    def third(n_windows, n_leaves, n_points, free):
        sizes.append(real(n_windows, n_leaves, n_points, free))
        room = (n_points * msm.LEAF_BYTES + (math.ceil(n_windows / 3) + 0.5)
                * msm.window_bytes(n_leaves, n_points))
        return real(n_windows, n_leaves, n_points, room / msm.FREE_SHARE)
    for grouped in (True, False):
        with monkeypatch.context() as m:
            if grouped:
                m.setattr(msm, "window_groups", third)
            with spans.trace() as t:
                proof = prover.prove_prepared(prep, r=5, s=6)
        assert (proof.a, proof.b, proof.c) == (want.a, want.b, want.c)
        found = t.spans()
        by_id = {s.id: s for s in found}
        under = collections.Counter(by_id[s.parent].name for s in found
                                    if s.name == "groth16.msm_group")
        n = 3 if grouped else 1
        assert under == {"groth16.msm_g1": n, "groth16.msm_g2": n}
    assert sizes == [22, 22]       # the card's own memory: one group each


@pytest.mark.cuda
def test_witness_staging_between_proofs_on_cuda(cuda_device):
    """BatchProcessTx(1, 4): proofs of two batches in turns, each
    prove_host's proof, every entry through the native pass, one pinned
    staging buffer on the key; and two encodings in a row behind a
    sleeping stream, the second written only after the first's copy left
    the buffer: each device tensor holds its own witness's rows."""
    from zkrollup_torch.config import RollupConfig
    from zkrollup_torch.groth16 import prove as P
    from zkrollup_torch.operator.prover import TxProver
    prover = TxProver(RollupConfig(batch_size=1, tree_depth=4),
                      setup_seed=b"zkrollup-test-seed", device=cuda_device)
    pk = prover.ensure_keys()
    preps = [prover.prepare_batch(*_tx_batch(prover, priv))
             for priv in (41516261718191101, 27182818284590452)]
    ws = [p.witness for p in preps]
    assert ws[0] != ws[1]
    wants = [P.prove_host(pk, prover.structure_r1cs(), w, r=5, s=6)
             for w in ws]
    L.reset_encoded()
    for prep, want in zip(preps * 2, wants * 2):
        proof = prover.prove_prepared(prep, r=5, s=6)
        assert (proof.a, proof.b, proof.c) == (want.a, want.b, want.c)
    assert L.ENCODED == {"native": 4 * len(ws[0]), "fallback": 0}
    staging = pk.__dict__["_torch_staging"]
    assert len(staging) == 1
    assert next(iter(staging.values())).host.is_pinned()
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)        # the copies queue behind it
    got = [P._encode_witness(pk, w, cuda_device) for w in ws]
    for g, w in zip(got, ws):
        want = L.ints_to_limbs([v % ref.R for v in w]).astype(np.int32)
        assert torch.equal(g.cpu(), torch.from_numpy(want))


@pytest.mark.cuda
def test_alu_kernels_match_plain(cuda_device):
    """tools/profile_alu: each integer-unit kernel at (16, 4096) and 256
    reps equals its plain version bit for bit."""
    from zkrollup_torch.tools import profile_alu
    assert set(profile_alu.check(cuda_device)) == set(profile_alu.OPS)


@pytest.mark.cuda
def test_point_kernel_check_on_cuda(cuda_device):
    from zkrollup_torch.tools import g2_kernel_check
    g2_kernel_check.run(cuda_device, log=lambda m: None)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["g1", "g2"])
def test_msm_trees_on_cuda_match_native_engine(cuda_device, name):
    """Every bucket strategy over a table with duplicates and infinity
    rows on the card, against the native engine; the G1 GLV MSM too."""
    from zkrollup_torch.msm.glv import msm_glv
    curve, mod = (g1.G1, g1) if name == "g1" else (g2.G2, g2)
    (x, y, inf), sc = _dup_table(curve, 200, 13)
    tbl = tuple(np.asarray(v) if not isinstance(v, tuple)
                else tuple(np.asarray(a) for a in v) for v in (x, y, inf))
    w_bytes = engine.ints_to_fr_bytes(L.limbs_to_ints(sc))
    if name == "g1":
        want = engine.g1_msm_pip(engine.pack_g1_table_mont(tbl), w_bytes,
                                 200)
    else:
        want = engine.g2_msm_pip(engine.pack_g2_table_mont(tbl), w_bytes,
                                 200)
    on = lambda v: curve.F.from_leaves([a.to(cuda_device)
                                        for a in curve.F.leaves(v)])
    pts = (on(x), on(y), inf.to(cuda_device))
    affine = lambda pt: mod.to_affine_host(pt)[0]
    for tree in msm.TREES:
        got = msm.msm(curve, pts, sc.to(cuda_device), c=6, tree=tree)
        assert affine(got) == want, tree
    if name == "g1":
        for tree in ("scan", "jacobian"):
            got = msm_glv(pts, sc.to(cuda_device), c=6, tree=tree)
            assert affine(got) == want, f"glv {tree}"


@pytest.mark.cuda
def test_withdraw_proof_on_cuda_equals_native_engine(cuda_device):
    """The withdraw circuit (domain 2^12, 3,585 variables): WithdrawProver
    on the card with a setup_host key gives prove_host's bytes at pinned
    (r, s), and they verify."""
    from zkrollup_torch.groth16.prove import prove_host
    from zkrollup_torch.groth16.setup import setup_host
    from zkrollup_torch.groth16.verify import verify
    from zkrollup_torch.operator.prover import WithdrawProver
    from zkrollup_torch.r1cs.circuits import synthesize_withdraw
    from zkrollup_torch.ref import eddsa
    prover = WithdrawProver(device=cuda_device)
    prover.pk = setup_host(prover.structure_r1cs(), seed=b"cuda-withdraw")
    fpriv = eddsa.format_priv_key_for_babyjub(41516261718191101)
    proof, signals = prover.prove_withdraw(fpriv, 777, r=5, s=6)
    res = synthesize_withdraw(fpriv, 777)
    want = prove_host(prover.pk, res.r1cs, res.witness, r=5, s=6)
    assert (proof.a, proof.b, proof.c) == (want.a, want.b, want.c)
    assert signals == res.public_signals
    assert verify(prover.pk.vk, proof, signals)


@pytest.mark.cuda
def test_run_pipeline_on_cuda_settles_on_the_contract(cuda_device):
    """BatchDaemon.run_pipeline over four sends, two BatchProcessTx(2, 6)
    batches proven on the card with a setup_host key: A 1.56 ETH nonce 4,
    B 1.40 ETH, fees 0.04, and the operator's root equals the contract's."""
    from zkrollup_torch.chain.simulator import RollUpContract
    from zkrollup_torch.config import RollupConfig
    from zkrollup_torch.groth16.setup import setup_host
    from zkrollup_torch.operator.batchd import BatchDaemon
    from zkrollup_torch.operator.prover import TxProver
    from zkrollup_torch.operator.queue import TxQueue
    from zkrollup_torch.operator.service import OperatorApp
    from zkrollup_torch.operator.state import OperatorState
    from zkrollup_torch.ref import eddsa
    from zkrollup_torch.ref.mimc import multi_hash
    from zkrollup_torch.witness.assembler import Transaction, format_tx
    cfg = RollupConfig()
    prover = TxProver(cfg, device=cuda_device)
    prover.pk = setup_host(prover.structure_r1cs(), seed=b"cuda-pipeline")
    contract = RollUpContract(cfg, tx_vk=prover.pk.vk, withdraw_vk=None)
    state, queue = OperatorState(cfg), TxQueue()
    daemon = BatchDaemon(cfg, state, queue, prover, contract)
    app = OperatorApp(cfg, state, queue, contract, daemon)
    privs = (41516261718191101, 41516261718191102)
    pubs = [eddsa.gen_public_key(k) for k in privs]
    contract.deposit(*pubs[0], 2 * 10 ** 18)
    contract.deposit(*pubs[1], 10 ** 18)
    app.sync_chain()
    for nonce in range(1, 5):
        tx = Transaction(0, 1, 10 ** 17, 10 ** 16, nonce)
        tx.signature = eddsa.sign(privs[0], format_tx(tx))
        assert queue.push(tx) == nonce - 1
    assert daemon.run_pipeline(max_batches=2) == 2
    a = contract.get_user_data(multi_hash(list(pubs[0])))
    b = contract.get_user_data(multi_hash(list(pubs[1])))
    assert (a[3], a[4], b[3]) == (156 * 10 ** 16, 4, 140 * 10 ** 16)
    assert contract.get_accrued_fees() == 4 * 10 ** 16
    assert state.load_tree().root == contract.balance_tree.get_root()
    assert daemon.metrics.batches_proven == 2 and queue.pending_count() == 0


@pytest.mark.cuda
def test_provers_default_to_the_card(cuda_device):
    """TxProver(cfg) and WithdrawProver() with no device or backend make
    their keys and prove on cuda: kernels launch, and the proofs verify."""
    from zkrollup_torch import kernels
    from zkrollup_torch.config import RollupConfig
    from zkrollup_torch.operator.prover import TxProver, WithdrawProver
    from zkrollup_torch.ref import eddsa
    tx_prover = TxProver(RollupConfig(batch_size=1, tree_depth=4))
    w_prover = WithdrawProver()
    assert (tx_prover.device, tx_prover.backend) == ("cuda", "device")
    assert (w_prover.device, w_prover.backend) == ("cuda", "device")
    kernels.reset_launches()
    tx_prover.prove_batch(*_tx_batch(tx_prover, 41516261718191101))
    w_prover.prove_withdraw(
        eddsa.format_priv_key_for_babyjub(41516261718191101), 5)
    for name in ("g1_madd", "g2_madd", "ntt_pass", "g1_madd_nd",
                 "g2_madd_nd"):
        assert kernels.LAUNCHES[name] > 0, name


@pytest.mark.cuda
def test_g1_add_nd_ragged_matches_plain(cuda_device):
    """g1_add_nd (one thread a lane, the Fq product called) on ragged
    launches of 1, 22, 33 and 1,025 lanes, on 2^16 lanes and on each of
    the special lanes alone: P + P and P + (-P) (H = 0), infinity on
    either side and on both."""
    curve, p, q = _point_operands("g1", cuda_device)
    for m, off in ((1, 0), (22, 0), (33, 0), (1025, 0), (1 << 16, 0),
                   (22, 50), (33, 40)) + tuple((1, k) for k in range(6)):
        idx = (torch.arange(m, device=cuda_device) + off) % N
        sub = [curve.map(lambda a: a.index_select(0, idx), t) for t in (p, q)]
        got, want = (curve.leaves(f(curve, *sub))
                     for f in (cuda_curve.add_nd, cuda_curve.add_nd_plain))
        assert all(torch.equal(a, b) for a, b in zip(got, want)), (m, off)


def _add_sub_operands(F, n, seed, device):
    """(a, b) of n canonical values, 0, 1, p - 1, a + b = p and a < b in
    the first rows."""
    a, b = _values(F.p, n, seed), _values(F.p, n, seed + 1)
    x, top = a[-1], F.p - 1
    edges = [(0, 0), (top, 1), (1, top), (top, top), (x, F.p - x), (1, 2)]
    for i, (u, v) in enumerate(edges[:n]):
        a[i], b[i] = u, v
    return _limbs(a, device), _limbs(b, device)


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["add", "sub"])
@pytest.mark.parametrize("F", [FR, FQ], ids=["fr", "fq"])
def test_add_sub_kernels_match_plain(cuda_device, F, op, monkeypatch):
    """add[fr|fq] and sub[fr|fq] (FieldCtx.add / sub on CUDA tensors): one
    launch each, bit for bit against add_plain / sub_plain on ragged
    launches of 1, 22, 33 and 1,025 lanes, with either operand one
    broadcast row, on a strided view and through the broadcasts of
    (5, 1, 16) and (1, 8, 16); limbs.normalize never runs."""
    from zkrollup_torch import kernels
    plain = getattr(cuda_mont, f"{op}_plain")
    wrapper = getattr(F, op)
    a, b = _add_sub_operands(F, 1025, 31, cuda_device)
    cases = [(a[:n], b[:n]) for n in (1, 22, 33, 1025)]
    cases += [(a, b[3]), (a[2], b), (a[:1024:2], b[1::2]),
              (a[:5].reshape(5, 1, 16), b[:8].reshape(1, 8, 16))]
    wants = [plain(F, x, y) for x, y in cases]
    orig = cuda_mont.L.normalize

    def no_cuda_normalize(t):
        assert t.device.type != "cuda", "limbs.normalize on a CUDA tensor"
        return orig(t)

    monkeypatch.setattr(cuda_mont.L, "normalize", no_cuda_normalize)
    for (x, y), want in zip(cases, wants):
        kernels.reset_launches()
        got = wrapper(x, y)
        assert kernels.LAUNCHES[f"{op}[{F.name}]"] == 1
        assert got.shape == want.shape and torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("n_in", [2, 4])
def test_mimc_sponge_kernel_matches_plain(cuda_device, n_in):
    """mimc_sponge[fr] (multi_hash_mont on CUDA tensors): one launch, bit
    for bit against multi_hash_mont_plain on ragged launches of 1, 22, 33
    and 1,025 lanes, without a key, under one broadcast key and under a
    key a lane; and against the host sponge (ref.mimc) on a few lanes."""
    from zkrollup_torch import kernels
    from zkrollup_torch.hash import mimc
    from zkrollup_torch.ref.mimc import multi_hash
    n = 1025
    vals = _values(FR.p, n * n_in, 40 + n_in)
    vals[:3] = [0, 1, FR.p - 1]
    x = L.to_device(FR.to_mont_host(vals), cuda_device).reshape(n, n_in, 16)
    keys = L.to_device(FR.to_mont_host(_values(FR.p, n, 50)), cuda_device)
    for k in (None, keys[7], keys):
        want = mimc.multi_hash_mont_plain(x, k)
        for m in (1, 22, 33, n):
            kernels.reset_launches()
            km = k if k is None or k.dim() == 1 else k[:m]
            got = mimc.multi_hash_mont(x[:m], km)
            assert kernels.LAUNCHES["mimc_sponge[fr]"] == 1
            assert kernels.LAUNCHES["mont_mul[fr]"] == 0
            assert torch.equal(got, want[:m]), (m, k is None)
    got = FR.from_mont_host(mimc.multi_hash_mont(x[:4]))
    assert got == [multi_hash(vals[i * n_in:(i + 1) * n_in])
                   for i in range(4)]


def _affine(curve, jac):
    mod = g1 if curve is g1.G1 else g2
    return mod.to_affine_host(curve.map(lambda a: a.reshape(1, 16).cpu(),
                                        jac))[0]


@pytest.mark.cuda
def test_virtual_mesh_ntt_and_msm_on_cuda(cuda_device):
    """Four shards on one card: the sharded NTT and its inverse against
    the one-device transform, the relayout against cyclic_shard, and the
    sharded G1 and G2 MSMs over tables with duplicates and infinity rows
    against msm() on the CPU, as affine points."""
    from zkrollup_torch import kernels
    from zkrollup_torch.dist import mesh as dm
    mesh = dm.make_mesh(4, device=cuda_device)
    x = L.to_device(FR.to_mont_host(_values(FR.p, 1 << 10, 21)), cuda_device)
    fwd = dm.sharded_ntt(mesh, dm.cyclic_shard(x, 4), 10)
    assert torch.equal(dm.unblock(fwd), ntt.ntt_mont(x))
    cyc = dm.blocked_to_cyclic(mesh, fwd)
    assert all(torch.equal(a, b) for a, b in
               zip(cyc, dm.cyclic_shard(dm.unblock(fwd), 4)))
    assert torch.equal(dm.unblock(dm.sharded_ntt(mesh, cyc, 10, True)), x)
    for curve, fn in ((g1.G1, dm.sharded_msm_g1), (g2.G2, dm.sharded_msm_g2)):
        (px, py, inf), sc = _dup_table(curve, 200, 31)
        on = lambda v: curve.F.from_leaves([a.to(cuda_device)
                                            for a in curve.F.leaves(v)])
        kernels.reset_launches()
        got = fn(mesh, (on(px), on(py), inf.to(cuda_device)),
                 sc.to(cuda_device), c=6)
        assert kernels.LAUNCHES[f"{curve.name}_horner"] == 1
        assert kernels.LAUNCHES[f"{curve.name}_add"] > 0
        want = msm.msm(curve, (px, py, inf), sc, c=6)
        assert _affine(curve, got) == _affine(curve, want)


@pytest.mark.cuda
def test_mesh_proof_on_cuda_equals_native_engine(cuda_device):
    """prove(mesh=) of a small circuit on four virtual shards of the card,
    with and without table groups (each on its own streams), against
    prove_host at pinned (r, s)."""
    from zkrollup_torch.dist import mesh as dm
    from zkrollup_torch.groth16.prove import prove, prove_host
    from zkrollup_torch.groth16.setup import setup_host
    from zkrollup_torch.groth16.verify import verify
    from zkrollup_torch.r1cs.builder import Builder
    bld = Builder()
    out = bld.alloc_output_deferred()
    y = bld.alloc_public_input(7)
    t = y
    for _ in range(40):
        t = bld.mul(t, t) + y
    bld.bind_output(out, t)
    r1cs, w = bld.r1cs(), bld.witness()
    pk = setup_host(r1cs, seed=b"cuda-mesh")
    want = prove_host(pk, r1cs, w, r=3, s=5)
    mesh = dm.make_mesh(4, device=cuda_device)
    for groups in (1, 2):
        got = prove(pk, r1cs, w, r=3, s=5, mesh=mesh, table_groups=groups)
        assert (got.a, got.b, got.c) == (want.a, want.b, want.c), groups
    assert verify(pk.vk, got, bld.public_signals())
