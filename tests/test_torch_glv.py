"""zkrollup_torch GLV MSM against zkrollup.msm.glv (JAX): the decomposition
(native and pure Python) output for output, and msm_glv at c = 4, as
tests/test_glv.py calls it, as affine points against the reference's
msm_glv (default strategy) with each of the port's strategies; with
infinity rows and zero scalars against zkrollup.ref.
"""

import random

import numpy as np
import pytest
import torch

from zkrollup.curve import g1_jax
from zkrollup.msm import glv as jglv
from zkrollup.ref import bn254 as ref
from zkrollup.ref.bn254 import R as FR_MOD
from zkrollup_torch.curve import g1
from zkrollup_torch.fields import limbs as L
from zkrollup_torch.msm import glv, msm

# One intra-op thread per process: the suite runs in several worker
# processes, whose torch thread pools would otherwise fight for the cores.
torch.set_num_threads(1)


def _scalars():
    rng = random.Random(19)
    return [0, 1, FR_MOD - 1, glv.LAMBDA] + [rng.randrange(FR_MOD)
                                             for _ in range(28)]


def test_constants_match_reference():
    assert (glv.LAMBDA, glv.BETA, glv.GLV_BITS) == (jglv.LAMBDA, jglv.BETA,
                                                     jglv.GLV_BITS)
    assert np.array_equal(glv._BETA_MONT_NP, jglv._BETA_MONT_NP)


@pytest.mark.parametrize("form", ["ints", "limbs"])
def test_decompose_batch_matches_reference(form):
    """The native decomposition, given ints or an (n, 16) limb array."""
    sc = _scalars()
    arg = sc if form == "ints" else L.ints_to_limbs(sc)
    got, want = glv.decompose_batch(arg), jglv.decompose_batch(arg)
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(got[1], want[1])


def test_decompose_batch_py_matches_reference():
    sc = _scalars()
    got, want = glv.decompose_batch_py(sc), jglv.decompose_batch_py(sc)
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(got[1], want[1])
    assert [glv.decompose(k) for k in sc] == [jglv.decompose(k) for k in sc]


def _to_affine(jac):
    return g1.to_affine_host([np.asarray(c).reshape(1, 16)
                              for c in jac])[0]


@pytest.fixture(scope="module")
def glv_problem():
    """16 points and scalars (test_glv.py's _setup), and the reference's
    msm_glv result at c = 4."""
    random.seed(5)
    rng = np.random.RandomState(6)
    ks = [int(v) for v in rng.randint(1, 1 << 24, size=16)]
    scalars = [random.randrange(FR_MOD) for _ in range(16)]
    pts = [ref.g1_mul(ref.G1_GEN, k) for k in ks]
    pa = g1_jax.pack_affine_host(pts)
    want = _to_affine(jglv.msm_glv(pa, scalars, c=4))
    return pa, ks, scalars, want


@pytest.mark.parametrize("tree", msm.TREES)
def test_msm_glv_matches_reference(glv_problem, tree):
    pa, ks, scalars, want = glv_problem
    x, y, inf = pa
    pts = (L.to_device(x, "cpu"), L.to_device(y, "cpu"),
           torch.from_numpy(inf))
    got = _to_affine(glv.msm_glv(pts, scalars, c=4, tree=tree))
    assert got == want
    total = sum(k * s for k, s in zip(ks, scalars)) % FR_MOD
    assert got == ref.g1_mul(ref.G1_GEN, total)


@pytest.mark.parametrize("tree", ["scan", "jacobian"])
def test_msm_glv_with_infinity_and_zero_scalars(tree):
    """test_glv.py's infinity case: an infinity row (whose y must stay 0
    under the sign fold) and a zero scalar; scalars as a limb tensor."""
    pts = [ref.g1_mul(ref.G1_GEN, 5), None, ref.g1_mul(ref.G1_GEN, 7)]
    x, y, inf = g1.pack_affine_host(pts)
    t = (L.to_device(x, "cpu"), L.to_device(y, "cpu"), torch.from_numpy(inf))
    sc = L.to_device(L.ints_to_limbs([3, 11, 0]), "cpu")
    got = _to_affine(glv.msm_glv(t, sc, c=4, tree=tree))
    assert got == ref.g1_mul(ref.G1_GEN, 15)
