"""zkrollup_torch G2 point ops (Jacobian over Fq2) against zkrollup.curve
(JAX): the unified add, the add without the doubling path, the add of Z in
{0, 1} operands and the no-double mixed add against the generic
weierstrass G2 formulas and zkrollup.ref affine arithmetic; the rule
g2_madd's and g2_add_z01's warp votes rely on (the doubling path is needed
only on P == Q lanes of finite points) against madd_plain and
add_z01_plain, the generic formulas and zkrollup_torch.ref.

Exactness as for G1 (test_torch_curve.py): Jacobian limbs equal on finite
lanes, Z equal everywhere. The G2 add_z01 kernel has no Pallas
counterpart: the reference computes it with the generic formula, which
gives (0, 0, 0) on P + (-P) where the kernel zeroes Z only.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from zkrollup.curve import g2_jax
from zkrollup.ref import bn254 as ref
from zkrollup_torch.curve import cuda_curve, g2
from zkrollup_torch.ref import bn254 as tref

# One intra-op thread per process: the suite runs in several worker
# processes, whose torch thread pools would otherwise fight for the cores.
torch.set_num_threads(1)

N = 6


def _operands(seed):
    """Lanes: 0 P + P, 1 P + (-P), 2 inf + Q, 3 P + inf, 4-5 random; p has
    Z != 1 (p = (p - r) + r)."""
    rng = np.random.RandomState(seed)
    pt = lambda: ref.g2_mul(ref.G2_GEN, int(rng.randint(1, 1 << 62)))
    pa = [pt() for _ in range(N)]
    qa = [pt() for _ in range(N)]
    qa[0] = pa[0]
    qa[1] = ref.g2_neg(pa[1])
    pa[2], qa[3] = None, None
    ra = [pt() for _ in range(N)]
    p = g2.G2.add(g2.G2.add(g2.pack_jacobian_host(pa),
                            g2.pack_jacobian_host([ref.g2_neg(r)
                                                   for r in ra])),
                  g2.pack_jacobian_host(ra))
    return p, g2.pack_jacobian_host(qa), pa, qa


def _jax(p):
    return tuple((jnp.asarray(c[0].numpy().astype(np.uint32)),
                  jnp.asarray(c[1].numpy().astype(np.uint32))) for c in p)


def _assert_matches(got, want):
    got = [[c.numpy().astype(np.uint32) for c in coord] for coord in got]
    want = [[np.asarray(c) for c in coord] for coord in want]
    assert all(np.array_equal(g, w) for g, w in zip(got[2], want[2]))
    fin = np.any((got[2][0] != 0) | (got[2][1] != 0), axis=1)
    for k in (0, 1):
        assert all(np.array_equal(g[fin], w[fin])
                   for g, w in zip(got[k], want[k]))


def test_add_matches_generic_and_ref():
    p, q, pa, qa = _operands(3)
    got = g2.G2.add(p, q)
    _assert_matches(got, g2_jax.G2._add_generic(_jax(p), _jax(q)))
    assert g2.to_affine_host(got) == [ref.g2_add(a, b)
                                      for a, b in zip(pa, qa)]


def test_madd_nd_matches_generic_and_ref():
    p, q, pa, qa = _operands(5)
    p, q = (tuple((c[0][1:], c[1][1:]) for c in t) for t in (p, q))
    got = g2.G2.madd_z01(p, q, distinct=True)
    _assert_matches(got, g2_jax.G2.madd_z01(_jax(p), _jax(q),
                                            distinct=True))
    assert g2.to_affine_host(got) == [ref.g2_add(a, b)
                                      for a, b in zip(pa[1:], qa[1:])]


def test_madd_with_double_path_matches_ref():
    p, q, pa, qa = _operands(7)
    got = g2.G2.madd_z01(p, q, distinct=False)
    assert g2.to_affine_host(got) == [ref.g2_add(a, b)
                                      for a, b in zip(pa, qa)]


def test_add_nd_matches_generic_and_ref():
    """Distinct lanes (all but lane 0, P + P) against the generic safe
    add."""
    p, q, pa, qa = _operands(11)
    # the reference runs on every lane (the shapes of the add test, so its
    # compiled ops are reused); lane 0 is outside add_nd's contract
    want = jax.jit(g2_jax.G2.add_nd)(_jax(p), _jax(q))
    got = g2.G2.add_nd(p, q)
    got, want = ([(c[0][1:], c[1][1:]) for c in t] for t in (got, want))
    _assert_matches(got, want)
    assert g2.to_affine_host(tuple(got)) == [ref.g2_add(a, b)
                                             for a, b in zip(pa[1:], qa[1:])]


def test_add_z01_matches_generic_and_ref():
    """Z in {0, 1} on both sides; lanes 0 P + P, 1 P + (-P), 2 inf + Q,
    3 P + inf, 4 inf + inf, 5 random. Limb for limb on every lane but
    P + (-P), where the two agree as affine points (infinity) and on Z."""
    rng = np.random.RandomState(13)
    pt = lambda: ref.g2_mul(ref.G2_GEN, int(rng.randint(1, 1 << 62)))
    pa = [pt() for _ in range(N)]
    qa = [pt() for _ in range(N)]
    qa[0] = pa[0]
    qa[1] = ref.g2_neg(pa[1])
    pa[2], qa[3], pa[4], qa[4] = None, None, None, None
    p, q = g2.pack_jacobian_host(pa), g2.pack_jacobian_host(qa)
    got = g2.G2.add_z01(p, q)
    want = jax.jit(g2_jax.G2._add_z01_generic)(_jax(p), _jax(q))
    keep = np.arange(N) != 1
    for gc, wc in zip(got, want):
        for g, w in zip(gc, wc):
            assert np.array_equal(g.numpy().astype(np.uint32)[keep],
                                  np.asarray(w)[keep])
    _assert_matches(got, want)
    assert g2.to_affine_host(got) == [ref.g2_add(a, b)
                                      for a, b in zip(pa, qa)]


# lanes of the vote cases: more than one 16-lane warp of thread pairs
N_VOTE = 20


def _z01_vote_operands(seed):
    """(p, q, affine p, affine q) over N_VOTE lanes, every Z in {0, 1}:
    0 P + P, 1 P + (-P), 2 inf + Q, 3 P + inf, 4 inf + inf, 6 (-Q) + Q,
    9 inf + inf, 17 P + P in the second warp; the rest distinct pairs."""
    rng = np.random.RandomState(seed)
    pt = lambda: ref.g2_mul(ref.G2_GEN, int(rng.randint(1, 1 << 62)))
    pa, qa = ([pt() for _ in range(N_VOTE)] for _ in range(2))
    qa[0], qa[17] = pa[0], pa[17]
    qa[1], pa[6] = ref.g2_neg(pa[1]), ref.g2_neg(qa[6])
    pa[2], qa[3], pa[4], qa[4], pa[9], qa[9] = (None,) * 6
    return g2.pack_jacobian_host(pa), g2.pack_jacobian_host(qa), pa, qa


def _z01_voted(p, q, warp: int):
    """G2's z01 add as csrc/curve.cuh:jac_add_z01_voted_lane runs it over
    Fq2Pair (g2_add_z01): the affine double of p computed only in groups
    of `warp` lanes where some lane has H = R = 0 with neither operand
    infinite."""
    G2 = g2.G2
    F = G2.F
    X1, Y1 = p[0], p[1]
    H, R = F.sub(q[0], X1), F.sub(q[1], Y1)
    X3, Y3 = cuda_curve._add_xy(F, H, R, X1, Y1)
    h_zero, r_zero = F.is_zero(H), F.is_zero(R)
    p_inf, q_inf = F.is_zero(p[2]), F.is_zero(q[2])
    need = (h_zero & r_zero & ~p_inf & ~q_inf)[:, 0]
    n = need.shape[0]
    voted = torch.nn.functional.pad(need, (0, -n % warp)).view(-1, warp)
    voted = voted.any(dim=1).repeat_interleave(warp)[:n, None]
    dX, dY = cuda_curve._dbl_xy(F, X1, Y1)
    out = G2.select(h_zero & r_zero & voted, (dX, dY, F.add(Y1, Y1)),
                    (X3, Y3, H))
    return cuda_curve._inf_selects(G2, out, h_zero & ~r_zero & ~p_inf
                                   & ~q_inf, p, q)


@functools.lru_cache(maxsize=None)
def _z01_vote_case():
    """_z01_vote_operands(67) and the reference's _add_z01_generic of
    them, made once for the cases of test_add_z01_doubles_only_where_needed."""
    p, q, pa, qa = _z01_vote_operands(67)
    return p, q, pa, qa, jax.jit(g2_jax.G2._add_z01_generic)(_jax(p),
                                                              _jax(q))


@pytest.mark.parametrize("warp", [1, 5, 16])
def test_add_z01_doubles_only_where_needed(warp):
    """g2_add_z01's warp vote (16 lanes a warp on thread pairs): with the
    affine double selected only in groups of `warp` lanes that hold a
    P == Q lane of finite points, the z01 add equals add_z01_plain limb for
    limb on every lane (P == Q, P + (-P) and infinity lanes included); both
    equal the reference's _add_z01_generic limb for limb on every lane but
    P + (-P), where only Z is zeroed (the generic formula gives (0, 0, 0):
    there as affine points), and zkrollup_torch.ref on every lane."""
    p, q, pa, qa, want = _z01_vote_case()
    got = _z01_voted(p, q, warp)
    plain = cuda_curve.add_z01_plain(g2.G2, p, q)
    assert all(torch.equal(a, b) for a, b in
               zip(g2.G2.leaves(got), g2.G2.leaves(plain)))
    keep = np.ones(N_VOTE, bool)
    keep[[1, 6]] = False
    for gc, wc in zip(got, want):
        for g, w in zip(gc, wc):
            assert np.array_equal(g.numpy().astype(np.uint32)[keep],
                                  np.asarray(w)[keep])
    assert all(not c[k].any() for c in got[2] for k in (1, 6))
    assert g2.to_affine_host(got) == [tref.g2_add(a, b)
                                      for a, b in zip(pa, qa)]


def _madd_vote_operands(seed):
    """(p, q, affine p, affine q) over N_VOTE lanes, q with Z in {0, 1} and
    p with Z != 1: 0 P + P, 1 P + (-P), 2 inf + Q, 3 P + inf, 4 inf + inf,
    5 J + Q with J a Jacobian infinity with X, Y != 0 (the Z-only zeroing
    of a P + (-P) result), 6 P + P on the same limbs (Z = 1 both), 7 P +
    (x, y, 0) (q infinite by its Z alone), 17 P + P in the second warp;
    the rest distinct pairs."""
    rng = np.random.RandomState(seed)
    pt = lambda: ref.g2_mul(ref.G2_GEN, int(rng.randint(1, 1 << 62)))
    pa, qa, ra = ([pt() for _ in range(N_VOTE)] for _ in range(3))
    qa[0], qa[17] = pa[0], pa[17]
    qa[1] = ref.g2_neg(pa[1])
    pa[2], qa[3], pa[4], qa[4] = None, None, None, None
    G2 = g2.G2
    p = G2.add(G2.add(g2.pack_jacobian_host(pa),
                      g2.pack_jacobian_host([ref.g2_neg(r) for r in ra])),
               g2.pack_jacobian_host(ra))
    q = g2.pack_jacobian_host(qa)
    jinf = G2.add(p, G2.neg(p))
    assert G2.is_infinity(jinf)[5] and jinf[0][0][5].ne(0).any()
    for d, s in zip(G2.leaves(p), G2.leaves(jinf)):
        d[5] = s[5]
    for d, s in zip(G2.leaves(p), G2.leaves(q)):
        d[6] = s[6]
    for c in q[2]:
        c[7] = 0
    pa[5], pa[6], qa[7] = None, qa[6], None
    return p, q, pa, qa


def _madd_voted(p, q, warp: int):
    """G2's mixed add as csrc/curve.cuh:jac_madd_lane runs it over Fq2Pair
    (g2_madd): the affine double of q computed only in groups of `warp`
    lanes where some lane has H = R = 0 with neither operand infinite."""
    G2 = g2.G2
    F = G2.F
    out, H, R = cuda_curve.madd_add_path(F, p, q)
    h_zero, r_zero = F.is_zero(H), F.is_zero(R)
    p_inf, q_inf = F.is_zero(p[2]), F.is_zero(q[2])
    need = (h_zero & r_zero & ~p_inf & ~q_inf)[:, 0]
    n = need.shape[0]
    voted = torch.nn.functional.pad(need, (0, -n % warp)).view(-1, warp)
    voted = voted.any(dim=1).repeat_interleave(warp)[:n, None]
    dX, dY = cuda_curve._dbl_xy(F, q[0], q[1])
    out = G2.select(h_zero & r_zero & voted, (dX, dY, F.add(q[1], q[1])),
                    out)
    return cuda_curve._inf_selects(G2, out, h_zero & ~r_zero & ~p_inf
                                   & ~q_inf, p, q)


@functools.lru_cache(maxsize=None)
def _madd_vote_case():
    """_madd_vote_operands(59) and the reference's plain JAX mixed add of
    them, made once for the cases of test_madd_doubles_only_where_needed."""
    p, q, pa, qa = _madd_vote_operands(59)
    madd = jax.jit(lambda a, b: g2_jax.G2.madd_z01(a, b, distinct=False))
    return p, q, pa, qa, madd(_jax(p), _jax(q))


@pytest.mark.parametrize("warp", [1, 5, 16])
def test_madd_doubles_only_where_needed(warp):
    """g2_madd's warp vote (a warp holds 16 lanes on thread pairs): with the
    affine double selected only in groups of `warp` lanes that hold a
    P == Q lane of finite points (warp 1: only there; 5: a ragged last
    group; 16: a whole warp and the ragged second one), the mixed add
    equals madd_plain limb for limb on every lane; both equal the
    reference's plain JAX mixed add (Z everywhere, X and Y on finite
    lanes) on every lane but P + P, where that formula doubles p, and
    zkrollup_torch.ref on every lane."""
    p, q, pa, qa, want = _madd_vote_case()
    got = _madd_voted(p, q, warp)
    plain = cuda_curve.madd_plain(g2.G2, p, q)
    assert all(torch.equal(a, b) for a, b in
               zip(g2.G2.leaves(got), g2.G2.leaves(plain)))
    keep = [k for k in range(N_VOTE) if k not in (0, 6, 17)]   # not P + P
    cut = lambda t: tuple(tuple(c[keep] for c in coord) for coord in t)
    for t in (got, plain):
        _assert_matches(cut(t), [[np.asarray(c)[keep] for c in coord]
                                 for coord in want])
    sums = [tref.g2_add(a, b) for a, b in zip(pa, qa)]
    assert sums[0] == tref.g2_add(qa[0], qa[0]) and sums[6] is not None
    assert g2.to_affine_host(got) == sums
