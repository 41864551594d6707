"""zkrollup_torch MSM against zkrollup.msm (JAX) and the native engine:
digits and table packing limb for limb, the fused 4-table G1 window sums
at c = 8 as affine points against msm._multi_window_sums, and final G1/G2
MSMs against engine.g1_msm_pip / g2_msm_pip. The general MSM
(msm(distinct=False), Horner on the device) runs over tables with duplicate
and infinity points, against msm.msm for G1 and the native engine and
zkrollup.ref for G1 and G2; against msm.msm for G2 in the slow tier (the
reference's G2 msm takes minutes to compile for the CPU). The window sums
over collision-heavy inputs against zkrollup.ref for G1 and G2, and window
by window against the reference's window_sums with its chunked scan
(msm._TREE_MODE "scan") in the slow tier (the reference compile takes
25-60 s for G1 on the CPU, minutes for G2). The window sums at chunk 16
over every edge of the padding and of the chunk (n from 1 to 33: one
point, one partial chunk, exactly one chunk, two and four chunks, the
clamped window of a tiny n), distinct=True against distinct=False, and
scalars below 2^n_bits, each against zkrollup_torch.ref.

Window sums are compared as affine points: the two packages sum the same
points in different orders, so their Jacobian representatives differ.
"""

import random
from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from zkrollup.curve import g1_jax
from zkrollup.msm import msm as jmsm
from zkrollup.native import engine
from zkrollup.curve import g2_jax
from zkrollup.ref import bn254 as ref
from zkrollup.ref.bn254 import R as FR_MOD
from zkrollup_torch.curve import g1, g2
from zkrollup_torch.fields import limbs as L
from zkrollup_torch.fields.mont import FQ
from zkrollup_torch.msm import msm
from zkrollup_torch.msm.combine import (combine_multi_window_sums_host,
                                        combine_window_sums_host_g2)

# One intra-op thread per process: the suite runs in several worker
# processes, whose torch thread pools would otherwise fight for the cores.
torch.set_num_threads(1)

C = 8
SIZES = (256, 70, 33, 97)     # the largest table keeps c = 8 unclamped


def _scalars(n, seed):
    """Mostly full-width scalars, with the skew of real witnesses: zeros,
    ones and small values."""
    rng = np.random.RandomState(seed)
    words = rng.randint(0, 1 << 32, size=(n, 8), dtype=np.uint64)
    vals = [sum(int(w) << (32 * i) for i, w in enumerate(row)) % FR_MOD
            for row in words]
    for i in range(0, n, 5):
        vals[i] = int(rng.randint(0, 3))
    return vals


def _tables(seed):
    """Four G1 tables of distinct points; table 1 shares points with
    table 0, as the a and b1 tables of a real key do."""
    ks = random.Random(seed).sample(range(1, 1 << 30), sum(SIZES))
    ks[256:266] = ks[0:10]
    x, y, inf = engine.g1_fixed_base_mont(engine.ints_to_fr_bytes(ks),
                                          len(ks))
    x[300:302] = 0                 # two infinity rows
    y[300:302] = 0
    inf[300:302] = True
    out, s = [], 0
    for n in SIZES:
        out.append((x[s:s + n], y[s:s + n], inf[s:s + n]))
        s += n
    return out


@pytest.fixture(scope="module")
def problem():
    tables = _tables(1)
    scalars = [_scalars(n, 10 + t) for t, n in enumerate(SIZES)]
    return tables, scalars


def _affine_grid(wsum):
    """(W, T, 16) Montgomery Jacobian leaves -> [[affine]] by window."""
    leaves = [np.asarray(a) for a in wsum]
    W, T = leaves[0].shape[:2]
    flat = g1.to_affine_host([a.reshape(-1, 16) for a in leaves])
    return [flat[w * T:(w + 1) * T] for w in range(W)]


def test_window_digits_match_jax():
    sc = L.ints_to_limbs(_scalars(40, 3) + [(1 << 254) - 1])
    for c, w in ((8, 32), (12, 22), (5, 52)):
        got = msm.window_digits(torch.from_numpy(sc.astype(np.int32)), c, w)
        want = jmsm.window_digits(jnp.asarray(sc), c, w)
        assert np.array_equal(got.numpy(), np.asarray(want))


def test_pack_tables_matches_jax(problem):
    tables, _ = problem
    (x, y, inf), bounds = msm.pack_tables(tables)
    (jx, jy, jinf), jbounds = jmsm.pack_tables(tables)
    assert bounds == jbounds
    assert np.array_equal(x, np.asarray(jx))
    assert np.array_equal(y, np.asarray(jy))
    assert np.array_equal(inf, np.asarray(jinf))


@pytest.fixture(scope="module")
def jax_window_sums(problem):
    tables, scalars = problem
    pts, bounds = jmsm.pack_tables(tables)
    sc = np.zeros((pts[0].shape[0], 16), np.uint32)
    for (s, n), vals in zip(bounds, scalars):
        sc[s:s + n] = L.ints_to_limbs(vals)
    wsum, c = jmsm._multi_window_sums_jit(g1_jax.G1)(
        tuple(pts), jnp.asarray(sc), c=C, bounds=tuple(bounds),
        distinct=True)
    return _affine_grid(wsum), c


def _port_window_sums(problem, chunk):
    tables, scalars = problem
    (x, y, inf), bounds = msm.pack_tables(tables, chunk=chunk)
    sc = np.zeros((x.shape[0], 16), np.uint32)
    for (s, n), vals in zip(bounds, scalars):
        sc[s:s + n] = L.ints_to_limbs(vals)
    pts = (L.to_device(x, "cpu"), L.to_device(y, "cpu"),
           torch.from_numpy(inf))
    return msm.multi_window_sums(g1.G1, pts, L.to_device(sc, "cpu"), C,
                                 bounds, distinct=True, chunk=chunk)


@pytest.mark.parametrize("chunk", [128, 16])
def test_multi_window_sums_match_jax(problem, jax_window_sums, chunk):
    """chunk 128 is the reference's; 16 runs a multi-level Blelloch scan
    over chunk totals."""
    wsum, c = _port_window_sums(problem, chunk)
    want, jc = jax_window_sums
    assert c == jc == C
    assert _affine_grid([a.numpy().astype(np.uint32) for a in wsum]) == want


def test_g1_msms_match_native_engine(problem):
    tables, scalars = problem
    wsum, c = _port_window_sums(problem, 64)
    std = tuple(FQ.from_mont(a) for a in wsum)
    got = combine_multi_window_sums_host(std, c)
    want = [engine.g1_msm_pip(engine.pack_g1_table_mont(t),
                              engine.ints_to_fr_bytes(s), len(s))
            for t, s in zip(tables, scalars)]
    assert got == want


def test_g2_msm_matches_native_engine():
    n = 40
    ks = random.Random(5).sample(range(1, 1 << 30), n)
    (x0, x1), (y0, y1), inf = engine.g2_fixed_base_mont(
        engine.ints_to_fr_bytes(ks), n)
    sc = _scalars(n, 6)
    d = lambda a: L.to_device(a, "cpu")
    pts = ((d(x0), d(x1)), (d(y0), d(y1)), torch.from_numpy(inf))
    wsum, c = msm.window_sums(g2.G2, pts, d(L.ints_to_limbs(sc)), c=4,
                              distinct=True, chunk=16)
    assert c == 4
    std = tuple((FQ.from_mont(a[0]), FQ.from_mont(a[1])) for a in wsum)
    got = combine_window_sums_host_g2(std, c)
    want = engine.g2_msm_pip(engine.pack_g2_table_mont(((x0, x1), (y0, y1),
                                                        inf)),
                             engine.ints_to_fr_bytes(sc), n)
    assert got == want


def test_clamp_window_matches_jax():
    for c, n in ((12, 1 << 17), (12, 300), (8, 40), (3, 2)):
        assert msm._clamp_window(c, n) == jmsm._clamp_window(c, n)


def _dup_table(name, n, seed):
    """n affine points with 4 duplicates and 2 infinity rows, as tensors
    (and as ref points), and scalars as plain limbs and ints."""
    ks = random.Random(seed).sample(range(1, 1 << 30), n)
    ks[n - 4:] = ks[:4]
    if name == "g1":
        x, y, inf = engine.g1_fixed_base_mont(engine.ints_to_fr_bytes(ks), n)
        planes = [x, y]
    else:
        (x0, x1), (y0, y1), inf = engine.g2_fixed_base_mont(
            engine.ints_to_fr_bytes(ks), n)
        planes = [x0, x1, y0, y1]
    for a in planes:
        a[1:3] = 0
    inf[1:3] = True
    mul = ref.g1_mul if name == "g1" else ref.g2_mul
    gen = ref.G1_GEN if name == "g1" else ref.G2_GEN
    pts = [None if i in (1, 2) else mul(gen, k) for i, k in enumerate(ks)]
    curve = g1.G1 if name == "g1" else g2.G2
    t = [L.to_device(a, "cpu") for a in planes]
    k = len(t) // 2
    table = (curve.F.from_leaves(t[:k]), curve.F.from_leaves(t[k:]),
             torch.from_numpy(inf))
    sc = _scalars(n, seed + 1)
    return table, pts, L.to_device(L.ints_to_limbs(sc), "cpu"), sc


@pytest.mark.parametrize("name", ["g1", "g2"])
def test_general_msm_matches_native_engine_and_ref(name):
    n = 40
    table, pts, sc_t, sc = _dup_table(name, n, 21)
    curve, mod = (g1.G1, g1) if name == "g1" else (g2.G2, g2)
    got = mod.to_affine_host(msm.msm(curve, table, sc_t, c=4,
                                     distinct=False))[0]
    tbl_np = tuple(np.asarray(c) if not isinstance(c, tuple)
                   else tuple(np.asarray(a) for a in c) for c in table)
    if name == "g1":
        want = engine.g1_msm_pip(engine.pack_g1_table_mont(tbl_np),
                                 engine.ints_to_fr_bytes(sc), n)
        acc = None
        for p, k in zip(pts, sc):
            acc = ref.g1_add(acc, ref.g1_mul(p, k) if p else None)
    else:
        want = engine.g2_msm_pip(engine.pack_g2_table_mont(tbl_np),
                                 engine.ints_to_fr_bytes(sc), n)
        acc = None
        for p, k in zip(pts, sc):
            acc = ref.g2_add(acc, ref.g2_mul(p, k) if p else None)
    assert got == want == acc


@pytest.mark.parametrize("name", [
    "g1", pytest.param("g2", marks=pytest.mark.slow)])
def test_general_msm_matches_jax(name):
    """8 points (two duplicates, two infinity rows) at c = 2. The
    reference's msm compiles in about half a minute for G1 at this size,
    and for minutes for G2 (slow tier)."""
    table, _, sc_t, _ = _dup_table(name, 8, 31)
    curve, mod, jcurve = ((g1.G1, g1, g1_jax.G1) if name == "g1"
                          else (g2.G2, g2, g2_jax.G2))
    got = mod.to_affine_host(msm.msm(curve, table, sc_t, c=2))
    u32 = lambda t: jnp.asarray(np.asarray(t).astype(np.uint32))
    jtable = tuple(u32(c) if name == "g1" else (u32(c[0]), u32(c[1]))
                   for c in table[:2]) + (jnp.asarray(table[2].numpy()),)
    jmsm_fn = jax.jit(lambda t, s: jmsm.msm(jcurve, t, s, c=2))
    want = jmsm_fn(jtable, u32(sc_t.numpy()))
    to_np = lambda c: (np.asarray(c) if name == "g1"
                       else (np.asarray(c[0]), np.asarray(c[1])))
    assert got == mod.to_affine_host([to_np(c) for c in want])


def _collision_input():
    """tests/test_ntt_curve_msm.py:150-167: runs of equal digits, scalars
    0, 1 and r - 1, and an infinity row."""
    sc = [5] * 6 + [0, 1, ref.R - 1] + [11] * 7
    pts = [ref.g1_mul(ref.G1_GEN, i + 2) for i in range(len(sc) - 1)]
    pts += [None]
    return pts, sc


def _g2_collision_input():
    """G2 points with duplicates (3, 3; 7, 7, 7), an infinity row and the
    scalars 0, 1, r - 1 beside random ones."""
    ks = [3, 3, 5, 7, 7, 7, 9, None]
    pts = [None if k is None else ref.g2_mul(ref.G2_GEN, k) for k in ks]
    rng = random.Random(17)
    sc = [0, 1, ref.R - 1] + [rng.randrange(ref.R) for _ in range(5)]
    return pts, sc


def _port_affine(points, curve_mod):
    x, y, inf = curve_mod.pack_affine_host(points)
    dev = lambda v: (L.to_device(v, "cpu") if not isinstance(v, tuple)
                     else tuple(L.to_device(a, "cpu") for a in v))
    return dev(x), dev(y), torch.from_numpy(inf)


def test_window_sums_match_ref():
    """G1 over the collision-heavy input and G2 over a table with
    duplicates, at c = 3: window sums on the port, Horner on the host,
    against zkrollup.ref."""
    pts, sc = _collision_input()
    got = msm.msm_host_combine(g1.G1, _port_affine(pts, g1),
                               L.to_device(L.ints_to_limbs(sc), "cpu"), c=3)
    want = ref.g1_msm(pts[:-1], sc[:-1])
    assert g1.to_affine_host([c.reshape(1, 16) for c in got]) == [want]

    pts, sc = _g2_collision_input()
    wsum, c = msm.window_sums(g2.G2, _port_affine(pts, g2),
                              L.to_device(L.ints_to_limbs(sc), "cpu"), c=3)
    std = tuple((FQ.from_mont(a[0]), FQ.from_mont(a[1])) for a in wsum)
    acc = None
    for p, k in zip(pts, sc):
        acc = ref.g2_add(acc, ref.g2_mul(p, k) if p else None)
    assert combine_window_sums_host_g2(std, c) == acc


def _small_table(name, n, seed, dups=True):
    """n affine points as tensors, with the ref points and scalars as
    limbs and ints. Row 0 takes the scalar r - 1; where n allows, row 1 is
    infinity, the last row repeats row 0 with its scalar (dups=True; else
    it is another point), and row 2 takes the scalar 0 and row 3 is
    infinity too."""
    ks = random.Random(seed).sample(range(1, 1 << 30), n + 1)
    sc = _scalars(n, seed + 1)
    sc[0] = FR_MOD - 1
    if n >= 3 and dups:
        ks[n - 1], sc[n - 1] = ks[0], sc[0]
    inf_rows = [i for i in (1, 3) if i < n and (i == 1 or n >= 5)]
    if n >= 5:
        sc[2] = 0
    ks = ks[:n]
    pts = [None if i in inf_rows else
           (ref.g1_mul(ref.G1_GEN, k) if name == "g1"
            else ref.g2_mul(ref.G2_GEN, k)) for i, k in enumerate(ks)]
    mod = g1 if name == "g1" else g2
    return _port_affine(pts, mod), pts, sc


def _ref_msm(name, pts, sc):
    add, mul = ((ref.g1_add, ref.g1_mul) if name == "g1"
                else (ref.g2_add, ref.g2_mul))
    acc = None
    for p, k in zip(pts, sc):
        acc = add(acc, mul(p, k) if p else None)
    return acc


def _combined(name, wsum, c):
    """The host Horner of window sums with (W, 16) Montgomery leaves ->
    an affine point | None."""
    if name == "g1":
        std = tuple(FQ.from_mont(a)[:, None] for a in wsum)
        return combine_multi_window_sums_host(std, c)[0]
    std = tuple((FQ.from_mont(a[0]), FQ.from_mont(a[1])) for a in wsum)
    return combine_window_sums_host_g2(std, c)


@pytest.mark.parametrize("name", ["g1", "g2"])
@pytest.mark.parametrize("n", [1, 2, 5, 15, 16, 17, 31, 33])
def test_window_sums_sizes_match_ref(name, n):
    """chunk 16, c = 3, distinct=False, over the edges of the padding to a
    power of two and of the chunk: n = 1 and 2 (K = N, c clamped to 2),
    5 (one partial chunk), 15 and 16 (exactly one chunk, with and without
    padding), 17 and 31 (two chunks), 33 (four chunks)."""
    curve = g1.G1 if name == "g1" else g2.G2
    table, pts, sc = _small_table(name, n, 40 + n)
    wsum, c = msm.window_sums(curve, table,
                              L.to_device(L.ints_to_limbs(sc), "cpu"), c=3,
                              chunk=16)
    assert c == msm._clamp_window(3, n) == (2 if n < 8 else 3)
    assert curve.leaves(wsum)[0].shape == (-(-256 // c), 16)
    assert _combined(name, wsum, c) == _ref_msm(name, pts, sc)


@pytest.mark.parametrize("name", ["g1", "g2"])
def test_window_sums_distinct_equals_general(name):
    """On a table of distinct points with infinity rows and zero scalars,
    the no-double kernels (distinct=True) give the same window sums as the
    complete ones, window by window as affine points, and their Horner is
    zkrollup_torch.ref's MSM."""
    curve, mod = (g1.G1, g1) if name == "g1" else (g2.G2, g2)
    table, pts, sc = _small_table(name, 24, 7, dups=False)
    sc_t = L.to_device(L.ints_to_limbs(sc), "cpu")
    got, c = msm.window_sums(curve, table, sc_t, c=3, distinct=True,
                             chunk=16)
    gen, c2 = msm.window_sums(curve, table, sc_t, c=3, distinct=False,
                              chunk=16)
    assert c == c2 == 3
    assert mod.to_affine_host(got) == mod.to_affine_host(gen)
    assert _combined(name, got, c) == _ref_msm(name, pts, sc)


@pytest.mark.parametrize("name", ["g1", "g2"])
def test_window_sums_take_n_bits(name):
    """Scalars below 2^130 at n_bits=130: ceil(130 / c) windows, whose
    Horner is zkrollup_torch.ref's MSM."""
    curve = g1.G1 if name == "g1" else g2.G2
    table, pts, _ = _small_table(name, 17, 3)
    rng = random.Random(9)
    sc = [(1 << 130) - 1, 0] + [rng.randrange(1 << 130) for _ in range(15)]
    wsum, c = msm.window_sums(curve, table,
                              L.to_device(L.ints_to_limbs(sc), "cpu"), c=3,
                              n_bits=130, chunk=16)
    assert c == 3
    assert curve.leaves(wsum)[0].shape == (-(-130 // 3), 16)
    assert _combined(name, wsum, c) == _ref_msm(name, pts, sc)


def _jax_window_sums(monkeypatch, jcurve, points, sc, c):
    monkeypatch.setattr(jmsm, "_TREE_MODE", "scan")
    fn = jax.jit(partial(jmsm.window_sums, jcurve, c=c))
    return fn(points, jnp.asarray(L.ints_to_limbs(sc)))


@pytest.mark.slow
def test_window_sums_match_jax(monkeypatch):
    """The port's G1 window sums against the reference's chunked scan,
    window by window as affine points (the two sum in other orders), on
    the collision-heavy input at c = 3."""
    pts, sc = _collision_input()
    x, y, inf = g1_jax.pack_affine_host(pts)
    want, jc = _jax_window_sums(monkeypatch, g1_jax.G1,
                                (jnp.asarray(x), jnp.asarray(y),
                                 jnp.asarray(inf)), sc, 3)
    got, c = msm.window_sums(g1.G1, _port_affine(pts, g1),
                             L.to_device(L.ints_to_limbs(sc), "cpu"), c=3)
    assert c == jc == 3
    assert g1.to_affine_host(got) == g1.to_affine_host(
        [np.asarray(a) for a in want])


@pytest.mark.slow
def test_g2_window_sums_match_jax(monkeypatch):
    """G2 window sums against the reference's (its G2 window_sums compiles
    for minutes on the CPU)."""
    pts, sc = _g2_collision_input()
    (x0, x1), (y0, y1), inf = g2_jax.pack_affine_host(pts)
    j = jnp.asarray
    want, _ = _jax_window_sums(monkeypatch, g2_jax.G2,
                               ((j(x0), j(x1)), (j(y0), j(y1)), j(inf)),
                               sc, 3)
    got, _ = msm.window_sums(g2.G2, _port_affine(pts, g2),
                             L.to_device(L.ints_to_limbs(sc), "cpu"), c=3)
    to_np = lambda p: tuple((np.asarray(c[0]), np.asarray(c[1])) for c in p)
    assert g2.to_affine_host(got) == g2.to_affine_host(to_np(want))
