"""The paired Fq2 product of csrc/fq2_pair.cuh, modelled word by word.

g2_add and g2_madd_nd compute each G2 lane on two threads: thread k holds
component ck of every Fq2 value. Fq2Pair::mul has thread 0 form
T = a0 b0 + a1 (q - b1) and thread 1 T = a1 b0 + a0 b1, two 256 x 256-bit
products summed without reduction, reduced by ONE Montgomery reduction
interleaved with the products in a 9-word window (32-bit words, the PTX
carry chains of mac_row9 and redc_step9), then one conditional
subtraction. Fq2Pair::sqr has thread 0 compute (a0 + a1)(a0 - a1) and
thread 1 2 a0 a1, one CIOS product each (Fp::mul).

The model below follows those steps on 32-bit words and asserts the bounds
the kernel relies on: no carry leaves the window's ninth word, T < q 2^256,
REDC(T) < 2q, and the interleaved reduction gives REDC(T) of the 512-bit
sum. Its results are held against Python-int Fq2 arithmetic, the port's
fields/fq2.py on the CPU and the reference's zkrollup/fields/fq2.py on the
CPU, fed the same limbs. The kernel itself is held against the plain
versions on the card (test_torch_cuda.py, chip_smoke.py phase 2).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from zkrollup.fields import fq2 as jfq2
from zkrollup_torch.fields import fq2, limbs as L
from zkrollup_torch.fields.mont import FQ

torch.set_num_threads(1)

Q = FQ.p
R = 1 << 256
R_INV = pow(R, -1, Q)
INV = (-pow(Q, -1, 1 << 32)) % (1 << 32)     # FqParams::INV
M32 = (1 << 32) - 1
NW = 8


def _words(x: int) -> list:
    return [(x >> (32 * i)) & M32 for i in range(NW)]


def _int(ws) -> int:
    return sum(w << (32 * i) for i, w in enumerate(ws))


Q_W = _words(Q)


def _mac_row9(t: list, a: list, b: int) -> None:
    """mac_row9: t[0..7] += lo(a_j b) with the carry into t[8], then
    t[1..8] += hi(a_j b); no carry may leave t[8]."""
    c = 0
    for j in range(NW):
        s = t[j] + ((a[j] * b) & M32) + c
        t[j], c = s & M32, s >> 32
    s = t[8] + c
    assert s <= M32, "carry out of the window's ninth word"
    t[8] = s
    c = 0
    for j in range(NW):
        s = t[j + 1] + ((a[j] * b) >> 32) + c
        t[j + 1], c = s & M32, s >> 32
    assert c == 0, "carry out of the window's ninth word"


def _redc_step9(t: list) -> None:
    """redc_step9: m = t0 (-q^-1) mod 2^32, t += m q, shift down a word."""
    m = (t[0] * INV) & M32
    _mac_row9(t, Q_W, m)
    assert t[0] == 0
    t[:] = t[1:] + [0]


def _cond_sub(x: int) -> int:
    return x - Q if x >= Q else x


def _redc512(T: int) -> int:
    """The textbook word-by-word REDC of a 512-bit T, before the final
    subtraction: (T + M q) / 2^256."""
    M = 0
    for i in range(NW):
        m = (((T + M * Q) >> (32 * i)) * INV) & M32
        M += m << (32 * i)
    assert (T + M * Q) % R == 0
    return (T + M * Q) // R


def _pair_mul_thread(xa: int, ya: int, b_own: int, b_other: int,
                     odd: bool) -> int:
    """One thread of Fq2Pair::mul: x_a, y_a its and its partner's component
    of a; B1 = b0, B2 = q - b1 (c0 thread) or b1 (c1 thread)."""
    T = xa * (b_other if odd else b_own) + ya * (b_own if odd else
                                                 Q - b_other)
    assert 0 <= T < Q * R
    t = [0] * (NW + 1)
    xw, yw, own, other = _words(xa), _words(ya), _words(b_own), \
        _words(b_other)
    borrow = 0
    for i in range(NW):
        # word i of q - b_other, with the borrow from the words below
        d = Q_W[i] - other[i] - borrow
        nb, borrow = d & M32, int(d < 0)
        _mac_row9(t, xw, other[i] if odd else own[i])
        _mac_row9(t, yw, own[i] if odd else nb)
        _redc_step9(t)
    assert borrow == 0
    red = _int(t)
    assert t[NW] == 0 and red < 2 * Q
    assert red == _redc512(T)
    return _cond_sub(red)


def pair_mul(a, b):
    """Fq2Pair::mul on Montgomery residues a = (a0, a1), b = (b0, b1)."""
    (a0, a1), (b0, b1) = a, b
    return (_pair_mul_thread(a0, a1, b0, b1, odd=False),
            _pair_mul_thread(a1, a0, b1, b0, odd=True))


def _cios(a: int, b: int) -> int:
    """Fp::mul, word for word: the 10-word CIOS window, result < 2q before
    its one subtraction."""
    t = [0] * (NW + 2)
    aw, bw = _words(a), _words(b)
    for i in range(NW):
        c = 0
        for j in range(NW):
            s = t[j] + aw[j] * bw[i] + c
            t[j], c = s & M32, s >> 32
        s = t[NW] + c
        t[NW], t[NW + 1] = s & M32, t[NW + 1] + (s >> 32)
        m = (t[0] * INV) & M32
        c = (t[0] + m * Q_W[0]) >> 32
        for j in range(1, NW):
            s = t[j] + m * Q_W[j] + c
            t[j - 1], c = s & M32, s >> 32
        s = t[NW] + c
        t[NW - 1], t[NW] = s & M32, t[NW + 1] + (s >> 32)
        t[NW + 1] = 0
    red = _int(t[:NW + 1])
    assert red < 2 * Q
    return _cond_sub(red)


def pair_sqr(a):
    """Fq2Pair::sqr: (a0 + a1)(a0 - a1) on the c0 thread, 2 a0 a1 on the
    c1 thread, the operands in Fq2::sqr's order."""
    a0, a1 = a
    c0 = _cios((a0 + a1) % Q, (a0 - a1) % Q)
    return c0, 2 * _cios(a0, a1) % Q


def _int_mul(a, b):
    (a0, a1), (b0, b1) = a, b
    return ((a0 * b0 - a1 * b1) * R_INV % Q, (a0 * b1 + a1 * b0) * R_INV % Q)


def _int_sqr(a):
    return _int_mul(a, a)


EDGES = [0, 1, Q - 1, R % Q]


def _operands(seed: int, n: int = 96):
    """Pairs (a, b) of Fq2 Montgomery residues: every pair of edge
    elements (components 0, 1, q - 1, R mod q; (q - 1, q - 1) among them),
    then n random ones."""
    edge = [(x, y) for x in EDGES for y in EDGES]
    pairs = [(u, v) for u in edge for v in edge]
    rng = np.random.RandomState(seed)
    words = rng.randint(0, 1 << 32, size=(n, 4, NW), dtype=np.uint64)
    rand = [tuple(_int(int(w) for w in row) % Q for row in r) for r in words]
    pairs += [((r[0], r[1]), (r[2], r[3])) for r in rand]
    return pairs


OPS = {"mul": (pair_mul, _int_mul), "sqr": (pair_sqr, _int_sqr)}


def _run(op, pairs):
    model, _ = OPS[op]
    return [model(a, b) if op == "mul" else model(a) for a, b in pairs]


@pytest.mark.parametrize("op", sorted(OPS))
def test_pair_model_matches_int_arithmetic(op):
    pairs = _operands(1)
    want = [OPS[op][1](a, b) if op == "mul" else OPS[op][1](a)
            for a, b in pairs]
    assert _run(op, pairs) == want


def test_pair_mul_bounds_on_extremes():
    """The largest T each thread can see: every component q - 1, and
    b1 = 0 on the c0 thread (B2 = q itself)."""
    top = (Q - 1, Q - 1)
    for a, b in [(top, top), (top, (Q - 1, 0)), (top, (0, 0)),
                 ((0, 0), (0, 0))]:
        assert pair_mul(a, b) == _int_mul(a, b)


def _limbs(vals):
    return L.ints_to_limbs(vals)


def _split(pairs, k):
    """Component k of the first (a) or second (b) operand of every pair,
    as (n, 16) limbs of the Montgomery residues."""
    return [_limbs([p[0][k] for p in pairs]), _limbs([p[1][k] for p in pairs])]


def _port(op, pairs):
    (a0, b0), (a1, b1) = _split(pairs, 0), _split(pairs, 1)
    t = lambda x: torch.from_numpy(x.astype(np.int32))
    out = (fq2.mul((t(a0), t(a1)), (t(b0), t(b1))) if op == "mul"
           else fq2.sqr((t(a0), t(a1))))
    return list(zip(L.limbs_to_ints(out[0]), L.limbs_to_ints(out[1])))


def _reference(op, pairs):
    (a0, b0), (a1, b1) = _split(pairs, 0), _split(pairs, 1)
    j = jnp.asarray
    out = (jfq2.mul((j(a0), j(a1)), (j(b0), j(b1))) if op == "mul"
           else jfq2.sqr((j(a0), j(a1))))
    return list(zip(L.limbs_to_ints(np.asarray(out[0])),
                    L.limbs_to_ints(np.asarray(out[1]))))


@pytest.mark.parametrize("op", sorted(OPS))
def test_pair_model_matches_port_fq2(op):
    pairs = _operands(2)
    assert _run(op, pairs) == _port(op, pairs)


@pytest.mark.parametrize("op", sorted(OPS))
def test_pair_model_matches_reference_fq2(op):
    pairs = _operands(3)
    assert _run(op, pairs) == _reference(op, pairs)
