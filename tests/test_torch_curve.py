"""zkrollup_torch G1 point ops against zkrollup.curve (JAX): the unified add,
the add without the doubling path, the add of Z in {0, 1} operands, the
double and the mixed add (no-double and safe) against the generic
weierstrass G1 formulas and, in the slow tier, against the Pallas kernels
in interpret mode; every result also against zkrollup.ref affine
arithmetic. The plain versions of the double and the safe mixed add are
held against zkrollup.ref for G1 and G2, limb for limb. The rule g1_add's
warp vote relies on (the doubling path is needed only on P == Q lanes of
finite points) is held against add_plain and the reference, and so is
the same rule for g1_madd's vote against madd_plain.

Exactness: Jacobian limbs are equal wherever the result is a finite point,
and Z is equal everywhere. On P + (-P) the Pallas kernels (and the port)
zero only Z, where the generic JAX formula zeroes X and Y too. On P + P the
safe mixed add follows the Pallas kernel (the affine double of q, Z = 2 y2),
where the generic JAX mixed_add doubles p: the same point, other limbs.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from zkrollup.curve import g1_jax, g2_jax
from zkrollup.ref import bn254 as ref
from zkrollup_torch.curve import cuda_curve, g1, g2
from zkrollup_torch.fields import fq2
from zkrollup_torch.fields.mont import FQ
from zkrollup_torch.ref import bn254 as tref

# One intra-op thread per process: the suite runs in several worker
# processes, whose torch thread pools would otherwise fight for the cores.
torch.set_num_threads(1)

N = 16


def _points(n, seed, with_inf=True):
    rng = np.random.RandomState(seed)
    return [None if with_inf and i % 7 == 3 else
            ref.g1_mul(ref.G1_GEN, int(rng.randint(1, 1 << 62)))
            for i in range(n)]


def _operands(seed, nonunit_z):
    """(p, q, affine p, affine q) with special lanes: 0 P + P, 1 P + (-P),
    2 inf + Q, 3 P + inf, 4 inf + inf; p has Z != 1 when nonunit_z."""
    pa, qa = _points(N, seed), _points(N, seed + 1)
    pa[0] = qa[0] = ref.g1_mul(ref.G1_GEN, 5)
    pa[1] = ref.g1_mul(ref.G1_GEN, 6)
    qa[1] = ref.g1_neg(pa[1])
    pa[2], qa[3], pa[4], qa[4] = None, None, None, None
    p = g1.pack_jacobian_host(pa)
    if nonunit_z:
        # p = (p - r) + r with r random: same points, Z != 1
        ra = _points(N, seed + 2, with_inf=False)
        minus_r = g1.pack_jacobian_host([ref.g1_neg(r) for r in ra])
        p = g1.G1.add(g1.G1.add(p, minus_r), g1.pack_jacobian_host(ra))
    return p, g1.pack_jacobian_host(qa), pa, qa


def _jax(p):
    return tuple(jnp.asarray(c.numpy().astype(np.uint32)) for c in p)


def _assert_matches(got, want):
    """Z equal everywhere, X and Y equal on finite lanes."""
    got = [c.numpy().astype(np.uint32) for c in got]
    want = [np.asarray(c) for c in want]
    assert np.array_equal(got[2], want[2])
    fin = np.any(got[2] != 0, axis=1)
    assert np.array_equal(got[0][fin], want[0][fin])
    assert np.array_equal(got[1][fin], want[1][fin])


def _sums(pa, qa):
    return [ref.g1_add(a, b) for a, b in zip(pa, qa)]


def _mixed_add(curve, p, q_affine):
    """p (Jacobian) + q (affine (x, y) with an (..., 1) infinity mask): the
    generic shape of zkrollup/curve/weierstrass.py:mixed_add, whose
    doubling branch doubles p. The same affine result as madd_z01, other
    Jacobian limbs on P == Q."""
    F = curve.F
    x2, y2, q_inf = q_affine
    added, H, R = cuda_curve.madd_add_path(F, p, q_affine)
    h_zero, r_zero = F.is_zero(H), F.is_zero(R)
    p_inf = curve.is_infinity(p)
    out = curve.select(h_zero & r_zero, curve.double(p), added)
    bshape = curve.leaves(out)[0].shape[:-1]
    dev = curve.leaves(out)[0].device
    out = curve.select(h_zero & ~r_zero & ~p_inf,
                       curve.infinity(bshape, dev), out)
    out = curve.select(p_inf, (x2, y2, F.one(bshape, dev)), out)
    return curve.select(q_inf, p, out)


# the P + (-P) lanes of _z01_operands
Z01_OPPOSITE = (1, 8)


def _z01_operands(seed):
    """(p, q, affine p, affine q), every Z in {0, 1}. Lanes: 0 and 6
    P + P, 1 P + (-P) and 8 (-Q) + Q, 2 and 13 inf + Q, 3 and 11 P + inf,
    4 inf + inf, the rest random (10 inf + inf)."""
    pa, qa = _points(N, seed), _points(N, seed + 1)
    pa[0], pa[6] = qa[0], qa[6]
    pa[1], pa[8] = ref.g1_neg(qa[1]), ref.g1_neg(qa[8])
    pa[3] = ref.g1_mul(ref.G1_GEN, 99)
    pa[2], qa[3], pa[4], qa[4], qa[11], pa[13] = (None,) * 6
    return g1.pack_jacobian_host(pa), g1.pack_jacobian_host(qa), pa, qa


def _limbs_equal(got, want, lanes=slice(None)):
    return all(np.array_equal(g.numpy().astype(np.uint32)[lanes],
                              np.asarray(w)[lanes])
               for g, w in zip(got, want))


@pytest.mark.parametrize("nonunit_z", [False, True])
def test_add_matches_generic_and_ref(nonunit_z):
    p, q, pa, qa = _operands(3, nonunit_z)
    got = g1.G1.add(p, q)
    _assert_matches(got, g1_jax.G1._add_generic(_jax(p), _jax(q)))
    assert g1.to_affine_host(got) == _sums(pa, qa)


def _vote_operands(seed):
    """(p, q, affine p, affine q) over N lanes: the special lanes of
    _operands (0 P + P, 1 P + (-P), 2 inf + Q, 3 P + inf, 4 inf + inf, p
    with Z != 1), then Jacobian infinities with X, Y != 0 (the Z-only
    zeroing of a P + (-P) result, J below): 5 J + Q, 6 P + J, 7 J + J;
    8 P + P on the same limbs, 9 P + P with Z != 1 against Z = 1; the rest
    distinct pairs."""
    p, q, pa, qa = _operands(seed, nonunit_z=True)
    jinf = g1.G1.add(p, g1.G1.neg(p))
    assert jinf[2][5:8].eq(0).all() and jinf[0][5:8].ne(0).any(dim=1).all()
    same_z1 = g1.pack_jacobian_host(pa)
    p0, q0 = (tuple(c.clone() for c in t) for t in (p, q))
    lanes = {5: (jinf, q0), 6: (p0, jinf), 7: (jinf, jinf), 8: (p0, p0),
             9: (p0, same_z1)}
    for k, (a, b) in lanes.items():
        for d, s in zip(p + q, a + b):
            d[k] = s[k]
    pa[5], qa[6], pa[7], qa[7], qa[8], qa[9] = (None, None, None, None,
                                                pa[8], pa[9])
    return p, q, pa, qa


def _voted(need, warp: int):
    """(n, 1) bools: every lane of each group of `warp` lanes where `need`
    (an (n, 1) mask) holds on some lane, as a warp vote gives it."""
    need = need[:, 0]
    n = need.shape[0]
    voted = torch.nn.functional.pad(need, (0, -n % warp)).view(-1, warp)
    return voted.any(dim=1).repeat_interleave(warp)[:n, None]


def _add_voted(curve, p, q, warp: int):
    """The unified add as csrc/curve.cuh:jac_add_lane runs it over FqCall
    (g1_add): the doubling path computed only in groups of `warp` lanes
    where some lane has H = R = 0 with neither operand infinite, and there
    selected where H = R = 0, before the infinity selects."""
    F = curve.F
    out, H, R = cuda_curve._add_path(F, p, q)
    h_zero, r_zero = F.is_zero(H), F.is_zero(R)
    p_inf, q_inf = F.is_zero(p[2]), F.is_zero(q[2])
    voted = _voted(h_zero & r_zero & ~p_inf & ~q_inf, warp)
    out = curve.select(h_zero & r_zero & voted,
                       cuda_curve.double_plain(curve, p), out)
    return cuda_curve._inf_selects(curve, out, h_zero & ~r_zero & ~p_inf
                                   & ~q_inf, p, q)


@functools.lru_cache(maxsize=None)
def _vote_case():
    """_vote_operands(23) and the reference's plain JAX add of them, made
    once for the cases of test_add_doubles_only_where_needed."""
    p, q, pa, qa = _vote_operands(23)
    return p, q, pa, qa, g1_jax.G1._add_generic(_jax(p), _jax(q))


@pytest.mark.parametrize("warp", [1, 5, 32])
def test_add_doubles_only_where_needed(warp):
    """g1_add's warp vote: with the doubling path selected only in groups
    of `warp` lanes that hold a P == Q lane of finite points (warp 1: only
    on those lanes; 5: a ragged last group; 32: every lane in one warp),
    the add equals add_plain limb for limb on every lane, infinities with
    X, Y != 0 and infinity + infinity (H = R = 0 too) included; both equal
    the reference's plain JAX add (Z everywhere, X and Y on finite lanes)
    and zkrollup.ref."""
    p, q, pa, qa, want = _vote_case()
    got = _add_voted(g1.G1, p, q, warp)
    plain = cuda_curve.add_plain(g1.G1, p, q)
    assert all(torch.equal(a, b) for a, b in zip(got, plain))
    _assert_matches(got, want)
    _assert_matches(plain, want)
    assert g1.to_affine_host(got) == _sums(pa, qa)


def _madd_vote_operands(seed):
    """(p, q, affine p, affine q) over N lanes for the mixed add, q with Z
    in {0, 1}: the special lanes of _operands (0 P + P, 1 P + (-P), 2 inf +
    Q, 3 P + inf, 4 inf + inf, p with Z != 1), then 5 J + Q with J a
    Jacobian infinity with X, Y != 0 (the Z-only zeroing of a P + (-P)
    result), 6 P + P on the same limbs (Z = 1 both), 7 P + (x, y, 0) (q
    infinite by its Z alone), 8 J + (x, y, 0); the rest distinct pairs."""
    p, q, pa, qa = _operands(seed, nonunit_z=True)
    jinf = g1.G1.add(p, g1.G1.neg(p))
    assert jinf[2][5].eq(0).all() and jinf[0][5].ne(0).any()
    for k in (5, 8):
        for d, s in zip(p, jinf):
            d[k] = s[5]
    for d, s in zip(p, q):
        d[6] = s[6]
    q[2][7:9] = 0
    pa[5], pa[6], qa[7], pa[8], qa[8] = None, qa[6], None, None, None
    return p, q, pa, qa


def _madd_voted(curve, p, q, warp: int):
    """The mixed add as csrc/curve.cuh:jac_madd_lane runs it (g1_madd over
    FqCall, g2_madd over Fq2Pair): the affine double of q computed only in
    groups of `warp` lanes where some lane has H = R = 0 with neither
    operand infinite, and there selected where H = R = 0, before the
    infinity selects."""
    F = curve.F
    out, H, R = cuda_curve.madd_add_path(F, p, q)
    h_zero, r_zero = F.is_zero(H), F.is_zero(R)
    p_inf, q_inf = F.is_zero(p[2]), F.is_zero(q[2])
    voted = _voted(h_zero & r_zero & ~p_inf & ~q_inf, warp)
    dX, dY = cuda_curve._dbl_xy(F, q[0], q[1])
    out = curve.select(h_zero & r_zero & voted, (dX, dY, F.add(q[1], q[1])),
                       out)
    return cuda_curve._inf_selects(curve, out, h_zero & ~r_zero & ~p_inf
                                   & ~q_inf, p, q)


@functools.lru_cache(maxsize=None)
def _madd_vote_case():
    """_madd_vote_operands(53) and the reference's plain JAX mixed add of
    them, made once for the cases of test_madd_doubles_only_where_needed."""
    p, q, pa, qa = _madd_vote_operands(53)
    madd = jax.jit(lambda a, b: g1_jax.G1.madd_z01(a, b, distinct=False))
    return p, q, pa, qa, madd(_jax(p), _jax(q))


@pytest.mark.parametrize("warp", [1, 5, 32])
def test_madd_doubles_only_where_needed(warp):
    """g1_madd's warp vote: with the affine double selected only in groups
    of `warp` lanes that hold a P == Q lane of finite points (warp 1: only
    on those lanes; 5: a ragged last group; 32: every lane in one warp),
    the mixed add equals madd_plain limb for limb on every lane,
    infinities with X, Y != 0 and infinity + infinity (H = R = 0 too)
    included; both equal the reference's plain JAX mixed add (Z
    everywhere, X and Y on finite lanes) on every lane but P + P, where
    that formula doubles p (other limbs, the same point), and
    zkrollup_torch.ref on every lane."""
    p, q, pa, qa, want = _madd_vote_case()
    got = _madd_voted(g1.G1, p, q, warp)
    plain = cuda_curve.madd_plain(g1.G1, p, q)
    assert all(torch.equal(a, b) for a, b in zip(got, plain))
    keep = [k for k in range(N) if k not in (0, 6)]      # not P + P
    for t in (got, plain):
        _assert_matches([c[keep] for c in t],
                        [np.asarray(c)[keep] for c in want])
    sums = [tref.g1_add(a, b) for a, b in zip(pa, qa)]
    assert sums[0] == tref.g1_add(qa[0], qa[0]) and sums[6] is not None
    assert g1.to_affine_host(got) == sums


def test_add_nd_matches_generic_and_ref():
    """Distinct lanes (all but lane 0, P + P): the generic safe add, limb
    for limb on finite lanes and Z everywhere (on P + (-P) the generic
    formula zeroes X and Y too)."""
    p, q, pa, qa = _operands(31, nonunit_z=True)
    # the reference runs on every lane (the shapes of the add test, so its
    # compiled ops are reused); lane 0 is outside add_nd's contract
    want = [np.asarray(c)[1:]
            for c in jax.jit(g1_jax.G1.add_nd)(_jax(p), _jax(q))]
    got = tuple(c[1:] for c in g1.G1.add_nd(p, q))
    _assert_matches(got, want)
    assert g1.to_affine_host(got) == _sums(pa[1:], qa[1:])


@pytest.mark.parametrize("seed", [37, 41])
def test_add_z01_matches_generic_and_ref(seed):
    """Both operands with Z in {0, 1}; every special lane. Limb for limb on
    every lane but P + (-P) (lanes 1 and 8), where only Z is zeroed (the
    generic formula gives (0, 0, 0)): there as affine points."""
    p, q, pa, qa = _z01_operands(seed)
    got = g1.G1.add_z01(p, q)
    want = jax.jit(g1_jax.G1._add_z01_generic)(_jax(p), _jax(q))
    keep = ~np.isin(np.arange(N), Z01_OPPOSITE)
    assert _limbs_equal(got, want, keep)
    for k in Z01_OPPOSITE:
        assert np.array_equal(got[2][k].numpy(), np.zeros(16, np.int32))
    assert g1.to_affine_host(got) == _sums(pa, qa)
    assert g1.to_affine_host(tuple(np.asarray(w) for w in want)) == \
        _sums(pa, qa)


@pytest.mark.parametrize("distinct", [True, False])
def test_madd_matches_generic_and_ref(distinct):
    p, q, pa, qa = _operands(5, nonunit_z=True)
    if distinct:      # the no-double contract: no lane with P == Q
        keep = torch.arange(1, N)
        p = tuple(c[keep] for c in p)
        q = tuple(c[keep] for c in q)
        pa, qa = pa[1:], qa[1:]
    got = g1.G1.madd_z01(p, q, distinct=distinct)
    want = g1_jax.G1.madd_z01(_jax(p), _jax(q), distinct=distinct)
    if distinct:
        _assert_matches(got, want)
    else:
        # the generic shape, limb for limb
        generic = _mixed_add(g1.G1, p, (q[0], q[1], g1.G1.is_infinity(q)))
        assert all(np.array_equal(g.numpy().astype(np.uint32), np.asarray(w))
                   for g, w in zip(generic, want))
        # madd_z01 (the Pallas shape) matches it on every lane but P + P
        _assert_matches([c[1:] for c in got], [np.asarray(c)[1:]
                                               for c in want])
    assert g1.to_affine_host(got) == _sums(pa, qa)


def _g2_operands(seed):
    """G2 counterpart of _operands(seed, nonunit_z=True), 8 lanes."""
    rng = np.random.RandomState(seed)
    pt = lambda: ref.g2_mul(ref.G2_GEN, int(rng.randint(1, 1 << 62)))
    pa, qa, ra = ([pt() for _ in range(8)] for _ in range(3))
    qa[0] = pa[0]
    qa[1] = ref.g2_neg(pa[1])
    pa[2], qa[3], pa[4], qa[4] = None, None, None, None
    p = g2.G2.add(g2.G2.add(g2.pack_jacobian_host(pa),
                            g2.pack_jacobian_host([ref.g2_neg(r)
                                                   for r in ra])),
                  g2.pack_jacobian_host(ra))
    return p, g2.pack_jacobian_host(qa), pa, qa


CURVES = {
    "g1": (g1, lambda s: _operands(s, nonunit_z=True), ref.g1_add,
           lambda c: FQ.from_mont_host(c)),
    "g2": (g2, _g2_operands, ref.g2_add, fq2.from_mont_host),
}


@pytest.mark.parametrize("name", sorted(CURVES))
def test_double_plain_matches_ref(name):
    """2P for p with Z != 1 and for q with Z = 1; infinity stays Z = 0."""
    mod, operands, add, _ = CURVES[name]
    curve = mod.G1 if name == "g1" else mod.G2
    p, q, pa, qa = operands(13)
    for pt, aff in ((p, pa), (q, qa)):
        got = cuda_curve.double_plain(curve, pt)
        assert mod.to_affine_host(got) == [add(a, a) for a in aff]
        assert all(bool(z) == (a is None) for z, a in
                   zip(curve.is_infinity(got)[:, 0], aff))
        assert all(torch.equal(a, b) for a, b in
                   zip(curve.leaves(curve.double(pt)), curve.leaves(got)))


@pytest.mark.parametrize("name", sorted(CURVES))
def test_madd_plain_matches_ref_with_the_mdbl_shape(name):
    """Every lane against zkrollup.ref; on P + P (lane 0) the Pallas mdbl
    shape limb for limb: Z = 2 y2, X = x Z^2, Y = y Z^3 with (x, y) the
    affine double of q."""
    mod, operands, add, from_mont = CURVES[name]
    curve = mod.G1 if name == "g1" else mod.G2
    p, q, pa, qa = operands(17)
    assert pa[0] == qa[0]
    got = cuda_curve.madd_plain(curve, p, q)
    assert mod.to_affine_host(got) == [add(a, b) for a, b in zip(pa, qa)]
    X, Y, Z = (from_mont(curve.map(lambda a: a[:1], got)[k])[0]
               for k in range(3))
    x2, y2 = qa[0]
    x, y = add(qa[0], qa[0])
    if name == "g1":
        Q = ref.Q
        assert Z == 2 * y2 % Q
        assert (X, Y) == (x * Z * Z % Q, y * pow(Z, 3, Q) % Q)
    else:
        assert Z == ref.fq2_add(y2, y2)
        z2 = ref.fq2_sqr(Z)
        assert (X, Y) == (ref.fq2_mul(x, z2),
                          ref.fq2_mul(y, ref.fq2_mul(z2, Z)))
    assert all(torch.equal(a, b) for a, b in
               zip(curve.leaves(curve.madd_z01(p, q)), curve.leaves(got)))


def test_double_matches_generic():
    """p has Z != 1 and infinity lanes: every limb equal."""
    p, _, _, _ = _operands(19, nonunit_z=True)
    got = g1.G1.double(p)
    want = g1_jax.G1._double_generic(_jax(p))
    assert all(np.array_equal(g.numpy().astype(np.uint32), np.asarray(w))
               for g, w in zip(got, want))


def test_neg_select_and_infinity():
    p, q, pa, qa = _operands(7, nonunit_z=False)
    assert g1.to_affine_host(g1.G1.neg(p)) == [
        ref.g1_neg(a) for a in pa]
    cond = torch.tensor([[i % 2 == 0] for i in range(N)])
    sel = g1.to_affine_host(g1.G1.select(cond, p, q))
    assert sel == [a if i % 2 == 0 else b for i, (a, b) in
                   enumerate(zip(pa, qa))]
    inf = g1.G1.infinity((3,), "cpu")
    assert g1.G1.is_infinity(inf).all()
    assert g1.to_affine_host(inf) == [None] * 3


@pytest.mark.slow
def test_add_matches_pallas_kernel_interpret():
    from zkrollup.curve import pallas_curve
    p, q, _, _ = _operands(9, nonunit_z=True)
    got = g1.G1.add(p, q)
    want = pallas_curve.g1_add(_jax(p), _jax(q))
    assert all(np.array_equal(g.numpy().astype(np.uint32), np.asarray(w))
               for g, w in zip(got, want))


@pytest.mark.slow
def test_madd_nd_matches_pallas_kernel_interpret():
    from zkrollup.curve import pallas_curve
    p, q, _, _ = _operands(11, nonunit_z=True)
    p, q = (tuple(c[1:] for c in t) for t in (p, q))
    got = g1.G1.madd_z01(p, q, distinct=True)
    want = pallas_curve.g1_madd_nd(_jax(p), _jax(q))
    assert all(np.array_equal(g.numpy().astype(np.uint32), np.asarray(w))
               for g, w in zip(got, want))


@pytest.mark.slow
def test_madd_matches_pallas_kernel_interpret():
    from zkrollup.curve import pallas_curve
    p, q, _, _ = _operands(23, nonunit_z=True)
    got = g1.G1.madd_z01(p, q, distinct=False)
    want = pallas_curve.g1_madd(_jax(p), _jax(q))
    assert all(np.array_equal(g.numpy().astype(np.uint32), np.asarray(w))
               for g, w in zip(got, want))


@pytest.mark.slow
def test_double_matches_pallas_kernel_interpret():
    from zkrollup.curve import pallas_curve
    p, _, _, _ = _operands(29, nonunit_z=True)
    got = g1.G1.double(p)
    want = pallas_curve.g1_double(_jax(p))
    assert all(np.array_equal(g.numpy().astype(np.uint32), np.asarray(w))
               for g, w in zip(got, want))


@pytest.mark.slow
def test_add_nd_matches_pallas_kernel_interpret():
    """Every lane, P + P (lane 0) included: there the kernel without the
    doubling path gives infinity by Z, and so does the port."""
    from zkrollup.curve import pallas_curve
    p, q, _, _ = _operands(43, nonunit_z=True)
    got = g1.G1.add_nd(p, q)
    assert _limbs_equal(got, pallas_curve.g1_add_nd(_jax(p), _jax(q)))
    assert not got[2][0].any()


@pytest.mark.slow
def test_add_z01_matches_pallas_kernel_interpret():
    from zkrollup.curve import pallas_curve
    p, q, _, _ = _z01_operands(47)
    got = g1.G1.add_z01(p, q)
    assert _limbs_equal(got, pallas_curve.g1_add_z01(_jax(p), _jax(q)))
