"""zkrollup_torch G2 point ops (Jacobian over Fq2) against zkrollup.curve
(JAX): the unified add, the add without the doubling path, the add of Z in
{0, 1} operands and the no-double mixed add against the generic
weierstrass G2 formulas and zkrollup.ref affine arithmetic.

Exactness as for G1 (test_torch_curve.py): Jacobian limbs equal on finite
lanes, Z equal everywhere. The G2 add_z01 kernel has no Pallas
counterpart: the reference computes it with the generic formula, which
gives (0, 0, 0) on P + (-P) where the kernel zeroes Z only.
"""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from zkrollup.curve import g2_jax
from zkrollup.ref import bn254 as ref
from zkrollup_torch.curve import g2

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
