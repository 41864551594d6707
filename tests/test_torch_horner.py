"""zkrollup_torch's Horner combine of MSM window sums (cuda_curve.horner,
the g1_horner / g2_horner kernels on the card) against the reference.

horner_plain, the plain version the wrapper takes on the CPU, runs the
loop of zkrollup/msm/msm.py:msm: from infinity, for each window from the
top, c doubles and one unified add. It is held limb for limb against the
same loop over the reference's plain JAX formulas (weierstrass.py
_double_generic and _add_generic, jitted), and as an affine point against
sum_w 2^(c w) W_w in zkrollup_torch.ref integers; on the edge cases too:
infinity windows, a window equal to 2^c times the running sum (the add's
doubling path), a window equal to its negation (P + (-P)) and one window.
msm() combines through curve.horner, once a call.

Exactness: on P + (-P) the port zeroes only Z, where the generic JAX add
zeroes X and Y too; Jacobian limbs are equal wherever the result is a
finite point, and Z is equal everywhere.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from zkrollup.curve import g1_jax, g2_jax
from zkrollup_torch.curve import cuda_curve, g1, g2
from zkrollup_torch.fields import limbs as L
from zkrollup_torch.msm import msm
from zkrollup_torch.ref import bn254 as tref

# One intra-op thread per process: the suite runs in several worker
# processes, whose torch thread pools would otherwise fight for the cores.
torch.set_num_threads(1)

CURVES = {
    "g1": (g1, g1_jax.G1, tref.g1_mul, tref.g1_add, tref.g1_neg,
           tref.G1_GEN),
    "g2": (g2, g2_jax.G2, tref.g2_mul, tref.g2_add, tref.g2_neg,
           tref.G2_GEN),
}


def _curve(name):
    mod = CURVES[name][0]
    return mod, (mod.G1 if name == "g1" else mod.G2)


def _jacobian(name, pts, seed):
    """pts (affine ref points, None for infinity) as a Jacobian batch with
    Z != 1 on the finite rows: (p - r) + r with r random."""
    mod, curve = _curve(name)
    _, _, mul, _, neg, gen = CURVES[name]
    rng = np.random.RandomState(seed)
    rs = [mul(gen, int(rng.randint(1, 1 << 62))) for _ in pts]
    return curve.add(curve.add(mod.pack_jacobian_host(pts),
                               mod.pack_jacobian_host([neg(r) for r in rs])),
                     mod.pack_jacobian_host(rs))


def _random_windows(name, W, seed):
    _, _, mul, _, _, gen = CURVES[name]
    rng = np.random.RandomState(seed)
    return [mul(gen, int(rng.randint(1, 1 << 62))) for _ in range(W)]


def _to_jax(name, p):
    u32 = lambda t: jnp.asarray(t.numpy().astype(np.uint32))
    if name == "g1":
        return tuple(u32(c) for c in p)
    return tuple((u32(c[0]), u32(c[1])) for c in p)


def _to_np(name, p):
    if name == "g1":
        return [np.asarray(c) for c in p]
    return [np.asarray(a) for c in p for a in c]


@functools.lru_cache(maxsize=None)
def _jitted(name):
    jcurve = CURVES[name][1]
    return jax.jit(jcurve._double_generic), jax.jit(jcurve._add_generic)


def _jax_horner(name, wsum, c):
    """The loop of zkrollup/msm/msm.py:msm over the plain JAX formulas, on
    one point: (1, 16) leaves."""
    dbl, add = _jitted(name)
    jw = _to_jax(name, wsum)
    res = CURVES[name][1].infinity((1,))
    for w in range(jax.tree_util.tree_leaves(jw)[0].shape[0] - 1, -1, -1):
        for _ in range(c):
            res = dbl(res)
        res = add(res, jax.tree_util.tree_map(lambda a: a[w:w + 1], jw))
    return res


def _ref_horner(name, pts, c):
    """sum_w 2^(c w) W_w in zkrollup_torch.ref integers."""
    _, _, mul, add, _, _ = CURVES[name]
    acc = None
    for w, p in enumerate(pts):
        if p is not None:
            acc = add(acc, mul(p, 1 << (c * w)))
    return acc


def _check(name, pts, wsum, c):
    """horner_plain against the JAX loop (Z everywhere, X and Y where the
    result is finite) and against ref; returns both results' limbs."""
    mod, curve = _curve(name)
    got = cuda_curve.horner_plain(curve, wsum, c)
    want = _to_np(name, _jax_horner(name, wsum, c))
    got_np = _to_np(name, curve.map(lambda a: a.reshape(1, 16), got))
    k = len(got_np) // 3
    assert all(np.array_equal(g.astype(np.uint32), w)
               for g, w in zip(got_np[2 * k:], want[2 * k:]))
    if any(np.any(z) for z in got_np[2 * k:]):
        assert all(np.array_equal(g.astype(np.uint32), w)
                   for g, w in zip(got_np, want))
    assert mod.to_affine_host(curve.map(lambda a: a.reshape(1, 16),
                                        got)) == [_ref_horner(name, pts, c)]
    return got_np, want


@pytest.mark.parametrize("name,W,c", [("g1", 22, 12), ("g1", 4, 3),
                                      ("g2", 3, 2)])
def test_horner_plain_matches_jax_loop_and_ref(name, W, c):
    """Random windows with Z != 1: every limb equal to the JAX loop's."""
    pts = _random_windows(name, W, 100 + W)
    got, want = _check(name, pts, _jacobian(name, pts, 200 + W), c)
    assert all(np.array_equal(g.astype(np.uint32), w)
               for g, w in zip(got, want))


def _edge_windows(name, case):
    """(affine windows W_0 .., c) of an edge case."""
    _, _, mul, _, neg, gen = CURVES[name]
    P = mul(gen, 12345)
    c = 3
    twice = mul(P, 1 << c)
    other = [mul(gen, 7), mul(gen, 99)]
    return {
        "one window": ([P], c),
        "infinity windows at the top, middle and bottom": (
            [None, other[0], None, other[1], None, None], c),
        "every window infinity": ([None, None, None], c),
        # at w = 1 the running sum is 2^c P: the add's doubling path
        "window equal to 2^c res": ([other[0], twice, P], c),
        "window equal to -(2^c res)": ([other[0], neg(twice), P], c),
        "last window equal to -(2^c res)": ([neg(twice), P], c),
    }[case]


EDGE_CASES = ["one window", "infinity windows at the top, middle and bottom",
              "every window infinity", "window equal to 2^c res",
              "window equal to -(2^c res)", "last window equal to -(2^c res)"]


@pytest.mark.parametrize("case", EDGE_CASES)
@pytest.mark.parametrize("name", ["g1", "g2"])
def test_horner_plain_edge_cases(name, case):
    pts, c = _edge_windows(name, case)
    wsum = _jacobian(name, pts, 300)
    _check(name, pts, wsum, c)
    if case == "window equal to 2^c res":
        # the doubling path: the add of 2^c P and W_1 has H = R = 0 in
        # other Jacobian limbs than the running sum's
        _, curve = _curve(name)
        res = curve.map(lambda a: a[2:3], wsum)
        for _ in range(c):
            res = cuda_curve.double_plain(curve, res)
        w1 = curve.map(lambda a: a[1:2], wsum)
        assert not all(torch.equal(a, b) for a, b in
                       zip(curve.leaves(res), curve.leaves(w1)))
        _, H, R = cuda_curve._add_path(curve.F, res, w1)
        assert bool(curve.F.is_zero(H).all() & curve.F.is_zero(R).all())


@pytest.mark.parametrize("name", ["g1", "g2"])
def test_horner_wrapper_takes_the_plain_version_on_the_cpu(name):
    """cuda_curve.horner and JacobianCurve.horner on CPU tensors give
    horner_plain's limbs; an empty set of windows gives infinity; c < 0
    is refused."""
    _, curve = _curve(name)
    pts = _random_windows(name, 3, 7)
    wsum = _jacobian(name, pts, 8)
    want = curve.leaves(cuda_curve.horner_plain(curve, wsum, 2))
    for got in (cuda_curve.horner(curve, wsum, 2), curve.horner(wsum, 2)):
        assert all(torch.equal(a, b) for a, b in
                   zip(curve.leaves(got), want))
    empty = curve.map(lambda a: a[:0], wsum)
    assert all(int(a.abs().sum()) == 0 for a in
               curve.leaves(cuda_curve.horner(curve, empty, 2)))
    with pytest.raises(ValueError):
        cuda_curve.horner(curve, wsum, -1)


def test_msm_combines_through_one_horner(monkeypatch):
    """msm() calls curve.horner once, on its window sums at its c."""
    calls = []
    plain = cuda_curve.horner

    def counted(curve, wsum, c):
        calls.append((curve.leaves(wsum)[0].shape, c))
        return plain(curve, wsum, c)

    monkeypatch.setattr(cuda_curve, "horner", counted)
    mod, curve = _curve("g1")
    pts = _random_windows("g1", 16, 9)
    x, y, inf = mod.pack_affine_host(pts)
    table = (L.to_device(x, "cpu"), L.to_device(y, "cpu"),
             torch.from_numpy(inf))
    sc = [3, 5, 0, 1 << 20, 77, 12345, (1 << 24) - 1] + list(range(9))
    got = msm.msm(curve, table, L.to_device(L.ints_to_limbs(sc), "cpu"),
                  c=4, n_bits=24)
    assert calls == [((6, 16), 4)]     # 24 bits in windows of 4
    want = None
    for p, k in zip(pts, sc):
        want = tref.g1_add(want, tref.g1_mul(p, k) if k else None)
    assert mod.to_affine_host([a.reshape(1, 16) for a in got]) == [want]
