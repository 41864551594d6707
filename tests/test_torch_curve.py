"""zkrollup_torch G1 point ops against zkrollup.curve (JAX): the unified add
and the mixed add (no-double and safe) against the generic weierstrass G1
formulas and, in the slow tier, against the Pallas kernels in interpret
mode; every result also against zkrollup.ref affine arithmetic.

Exactness: Jacobian limbs are equal wherever the result is a finite point,
and Z is equal everywhere. On P + (-P) the Pallas kernels (and the port)
zero only Z, where the generic JAX formula zeroes X and Y too.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from zkrollup.curve import g1_jax
from zkrollup.ref import bn254 as ref
from zkrollup_torch.curve import g1

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


@pytest.mark.parametrize("nonunit_z", [False, True])
def test_add_matches_generic_and_ref(nonunit_z):
    p, q, pa, qa = _operands(3, nonunit_z)
    got = g1.G1.add(p, q)
    _assert_matches(got, g1_jax.G1._add_generic(_jax(p), _jax(q)))
    assert g1.to_affine_host(got) == _sums(pa, qa)


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
        assert all(np.array_equal(g.numpy().astype(np.uint32), np.asarray(w))
                   for g, w in zip(got, want))
    assert g1.to_affine_host(got) == _sums(pa, qa)


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
