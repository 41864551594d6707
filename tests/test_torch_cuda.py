"""zkrollup_torch's CUDA kernels on the card.

Each kernel wrapper against its plain PyTorch version on the same CUDA
tensors, bit for bit (the integer-unit kernels of tools/profile_alu.py
too); the NTT, the MSM window sums and the general MSM on the card against
the same functions on the CPU; the bucket strategies and the GLV MSM
against the native engine; the G2 point-kernel check; a small setup on the
card against the native engine's; and the BatchProcessTx(2,6) proof
against the native engine. Every test needs a CUDA device and skips
without one.

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
    # the double on one lane, as the MSM's Horner launches it: infinity
    # (lane 2) and a finite point (lane 5)
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
    p, q = (curve.map(lambda a: a[1:].contiguous(), t) for t in (p, q))
    got, want = (curve.leaves(f(curve, p, q))
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
def test_ntt_on_cuda_matches_cpu(cuda_device):
    a = L.to_device(FR.to_mont_host(_values(FR.p, 1 << 10, 6)), "cpu")
    for fn in (ntt.intt_mont, ntt.coset_ntt_mont, ntt.coset_intt_mont):
        assert torch.equal(fn(a.to(cuda_device)).cpu(), fn(a))


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
    kernels in the scan leg, the double and add kernels in the Horner."""
    curve = g1.G1 if name == "g1" else g2.G2
    (x, y, inf), sc = _dup_table(curve, 200, 11)
    on = lambda v: curve.F.from_leaves([a.to(cuda_device)
                                        for a in curve.F.leaves(v)])
    got = msm.msm(curve, (on(x), on(y), inf.to(cuda_device)),
                  sc.to(cuda_device), c=6)
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
