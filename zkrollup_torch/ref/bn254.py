"""Pure-Python BN254 (alt_bn128) reference: Fq/Fr, tower fields, G1/G2, pairing.

This is the host ground truth the TPU kernels are differentially tested
against, and the pairing engine behind off-chain Groth16 verification
(replacing the EVM precompiles 0x6/0x7/0x8 the reference's verifier contracts
use — simple-zk-rollups/contracts/contracts/TxVerifier.sol:56-160 — and
snarkjs's `groth.isValid` self-check at
simple-zk-rollups/operator/src/snarks/common.ts:30-38).

Curve: y^2 = x^3 + 3 over Fq; r-torsion G2 on the sextic twist
y^2 = x^3 + 3/(9+u) over Fq2 = Fq[u]/(u^2+1).
"""

from __future__ import annotations

# Field moduli
Q = 21888242871839275222246405745257275088696311157297823662689037894645226208583
R = 21888242871839275222246405745257275088548364400416034343698204186575808495617

# BN parameter t: q = 36t^4 + 36t^3 + 24t^2 + 6t + 1
BN_T = 4965661367192848881
ATE_LOOP_COUNT = 6 * BN_T + 2  # 29793968203157093288


def inv_mod(a: int, m: int) -> int:
    # extgcd (CPython pow(-1)) — ~50x faster than Fermat at 254 bits.
    # inv_mod(0) = 0 preserved (Fermat's pow(0, m-2, m) behavior).
    a %= m
    return pow(a, -1, m) if a else 0


# ---------------------------------------------------------------------------
# Tower fields.  Elements are tuples of ints; all ops are module functions to
# keep this layer allocation-light and trivially portable.
# ---------------------------------------------------------------------------

# Fq2 = Fq[u] / (u^2 + 1), elements (a, b) = a + b*u

def fq2_add(x, y):
    return ((x[0] + y[0]) % Q, (x[1] + y[1]) % Q)


def fq2_sub(x, y):
    return ((x[0] - y[0]) % Q, (x[1] - y[1]) % Q)


def fq2_neg(x):
    return ((-x[0]) % Q, (-x[1]) % Q)


def fq2_mul(x, y):
    a, b = x
    c, d = y
    ac = a * c
    bd = b * d
    return ((ac - bd) % Q, ((a + b) * (c + d) - ac - bd) % Q)


def fq2_sqr(x):
    a, b = x
    return ((a + b) * (a - b) % Q, 2 * a * b % Q)


def fq2_scalar(x, k: int):
    return (x[0] * k % Q, x[1] * k % Q)


def fq2_conj(x):
    return (x[0], (-x[1]) % Q)


def fq2_inv(x):
    a, b = x
    t = inv_mod(a * a + b * b, Q)
    return (a * t % Q, -b * t % Q)


FQ2_ONE = (1, 0)
FQ2_ZERO = (0, 0)

# Non-residue for the 6th-degree extension: xi = 9 + u
XI = (9, 1)

# Fq6 = Fq2[v] / (v^3 - xi), elements (c0, c1, c2) of Fq2

def fq6_add(x, y):
    return tuple(fq2_add(a, b) for a, b in zip(x, y))


def fq6_sub(x, y):
    return tuple(fq2_sub(a, b) for a, b in zip(x, y))


def fq6_neg(x):
    return tuple(fq2_neg(a) for a in x)


def _mul_by_xi(a):
    return fq2_mul(a, XI)


def fq6_mul(x, y):
    a0, a1, a2 = x
    b0, b1, b2 = y
    t0 = fq2_mul(a0, b0)
    t1 = fq2_mul(a1, b1)
    t2 = fq2_mul(a2, b2)
    c0 = fq2_add(t0, _mul_by_xi(fq2_sub(fq2_mul(fq2_add(a1, a2), fq2_add(b1, b2)), fq2_add(t1, t2))))
    c1 = fq2_add(fq2_sub(fq2_mul(fq2_add(a0, a1), fq2_add(b0, b1)), fq2_add(t0, t1)), _mul_by_xi(t2))
    c2 = fq2_add(fq2_sub(fq2_mul(fq2_add(a0, a2), fq2_add(b0, b2)), fq2_add(t0, t2)), t1)
    return (c0, c1, c2)


def fq6_sqr(x):
    return fq6_mul(x, x)


def fq6_inv(x):
    a0, a1, a2 = x
    c0 = fq2_sub(fq2_sqr(a0), _mul_by_xi(fq2_mul(a1, a2)))
    c1 = fq2_sub(_mul_by_xi(fq2_sqr(a2)), fq2_mul(a0, a1))
    c2 = fq2_sub(fq2_sqr(a1), fq2_mul(a0, a2))
    t = fq2_inv(fq2_add(fq2_mul(a0, c0), _mul_by_xi(fq2_add(fq2_mul(a2, c1), fq2_mul(a1, c2)))))
    return (fq2_mul(c0, t), fq2_mul(c1, t), fq2_mul(c2, t))


FQ6_ZERO = (FQ2_ZERO, FQ2_ZERO, FQ2_ZERO)
FQ6_ONE = (FQ2_ONE, FQ2_ZERO, FQ2_ZERO)

# Fq12 = Fq6[w] / (w^2 - v), elements (c0, c1) of Fq6

def fq12_mul(x, y):
    a0, a1 = x
    b0, b1 = y
    t0 = fq6_mul(a0, b0)
    t1 = fq6_mul(a1, b1)
    # v * t1: multiply Fq6 element by v  ->  (xi*c2, c0, c1)
    vt1 = (_mul_by_xi(t1[2]), t1[0], t1[1])
    c0 = fq6_add(t0, vt1)
    c1 = fq6_sub(fq6_mul(fq6_add(a0, a1), fq6_add(b0, b1)), fq6_add(t0, t1))
    return (c0, c1)


def fq12_sqr(x):
    return fq12_mul(x, x)


def fq12_inv(x):
    a0, a1 = x
    t1 = fq6_sqr(a1)
    vt1 = (_mul_by_xi(t1[2]), t1[0], t1[1])
    t = fq6_inv(fq6_sub(fq6_sqr(a0), vt1))
    return (fq6_mul(a0, t), fq6_neg(fq6_mul(a1, t)))


def fq12_conj(x):
    return (x[0], fq6_neg(x[1]))


def fq12_pow(x, e: int):
    res = FQ12_ONE
    base = x
    while e:
        if e & 1:
            res = fq12_mul(res, base)
        base = fq12_sqr(base)
        e >>= 1
    return res


FQ12_ONE = (FQ6_ONE, FQ6_ZERO)
FQ12_ZERO = (FQ6_ZERO, FQ6_ZERO)

# Frobenius coefficients for Fq2: xi^((q-1)/6)^i precomputed at import
_FROB_C1 = [fq2_mul(FQ2_ONE, FQ2_ONE)] * 12


def _compute_frobenius_coeffs():
    # gamma_1,i = xi^(i*(q-1)/6) for i = 0..5 as Fq2 powers
    coeffs = []
    e = (Q - 1) // 6
    # xi^e in Fq2
    def fq2_pow(x, n):
        res = FQ2_ONE
        b = x
        while n:
            if n & 1:
                res = fq2_mul(res, b)
            b = fq2_sqr(b)
            n >>= 1
        return res
    g = fq2_pow(XI, e)
    acc = FQ2_ONE
    for _ in range(6):
        coeffs.append(acc)
        acc = fq2_mul(acc, g)
    return coeffs


_GAMMA1 = _compute_frobenius_coeffs()  # xi^(i(q-1)/6), i=0..5


def fq12_frobenius(x):
    """x -> x^q on Fq12."""
    (a0, a1, a2), (b0, b1, b2) = x
    a0 = fq2_conj(a0)
    a1 = fq2_mul(fq2_conj(a1), _GAMMA1[2])
    a2 = fq2_mul(fq2_conj(a2), _GAMMA1[4])
    b0 = fq2_mul(fq2_conj(b0), _GAMMA1[1])
    b1 = fq2_mul(fq2_conj(b1), _GAMMA1[3])
    b2 = fq2_mul(fq2_conj(b2), _GAMMA1[5])
    return ((a0, a1, a2), (b0, b1, b2))


# ---------------------------------------------------------------------------
# G1: affine/Jacobian over Fq.  Points are (x, y) tuples; None = infinity.
# ---------------------------------------------------------------------------

G1_GEN = (1, 2)
B1 = 3


def g1_is_on_curve(p) -> bool:
    if p is None:
        return True
    x, y = p
    return (y * y - x * x * x - B1) % Q == 0


def g1_add(p, r):
    if p is None:
        return r
    if r is None:
        return p
    x1, y1 = p
    x2, y2 = r
    if x1 == x2:
        if (y1 + y2) % Q == 0:
            return None
        return g1_double(p)
    lam = (y2 - y1) * inv_mod(x2 - x1, Q) % Q
    x3 = (lam * lam - x1 - x2) % Q
    y3 = (lam * (x1 - x3) - y1) % Q
    return (x3, y3)


def g1_double(p):
    if p is None:
        return None
    x, y = p
    if y == 0:
        return None
    lam = 3 * x * x * inv_mod(2 * y, Q) % Q
    x3 = (lam * lam - 2 * x) % Q
    y3 = (lam * (x - x3) - y) % Q
    return (x3, y3)


def g1_neg(p):
    if p is None:
        return None
    return (p[0], (-p[1]) % Q)


def g1_mul(p, k: int):
    k %= R
    res = None
    acc = p
    while k:
        if k & 1:
            res = g1_add(res, acc)
        acc = g1_double(acc)
        k >>= 1
    return res


def g1_msm(points, scalars):
    acc = None
    for p, s in zip(points, scalars):
        acc = g1_add(acc, g1_mul(p, s))
    return acc


# Jacobian host ops (X, Y, Z) python-int triples, Z == 0 = infinity.
# Inversion-free: used to combine the TPU MSM's per-window sums on the host
# (msm/glv.py) where the device Horner would be ~10^2 dispatch-bound tiny
# kernels; ~10^2 python-int muls instead.

def g1_jac_double(p):
    X, Y, Z = p
    if Z == 0 or Y == 0:
        return (0, 1, 0)
    A = X * X % Q
    Bv = Y * Y % Q
    C = Bv * Bv % Q
    D = 2 * ((X + Bv) * (X + Bv) - A - C) % Q
    E = 3 * A % Q
    F = E * E % Q
    X3 = (F - 2 * D) % Q
    Y3 = (E * (D - X3) - 8 * C) % Q
    Z3 = 2 * Y * Z % Q
    return (X3, Y3, Z3)


def g1_jac_add(p, q):
    X1, Y1, Z1 = p
    X2, Y2, Z2 = q
    if Z1 == 0:
        return q
    if Z2 == 0:
        return p
    Z1Z1 = Z1 * Z1 % Q
    Z2Z2 = Z2 * Z2 % Q
    U1 = X1 * Z2Z2 % Q
    U2 = X2 * Z1Z1 % Q
    S1 = Y1 * Z2 * Z2Z2 % Q
    S2 = Y2 * Z1 * Z1Z1 % Q
    H = (U2 - U1) % Q
    Rr = (S2 - S1) % Q
    if H == 0:
        if Rr == 0:
            return g1_jac_double(p)
        return (0, 1, 0)
    HH = H * H % Q
    HHH = H * HH % Q
    V = U1 * HH % Q
    X3 = (Rr * Rr - HHH - 2 * V) % Q
    Y3 = (Rr * (V - X3) - S1 * HHH) % Q
    Z3 = Z1 * Z2 * H % Q
    return (X3, Y3, Z3)


def g1_jac_to_affine(p):
    X, Y, Z = p
    if Z == 0:
        return None
    zi = inv_mod(Z, Q)
    zi2 = zi * zi % Q
    return (X * zi2 % Q, Y * zi2 * zi % Q)


# ---------------------------------------------------------------------------
# G2: points over Fq2 on y^2 = x^3 + 3/xi.  None = infinity.
# ---------------------------------------------------------------------------

B2 = fq2_mul((3, 0), fq2_inv(XI))

G2_GEN = (
    (10857046999023057135944570762232829481370756359578518086990519993285655852781,
     11559732032986387107991004021392285783925812861821192530917403151452391805634),
    (8495653923123431417604973247489272438418190587263600148770280649306958101930,
     4082367875863433681332203403145435568316851327593401208105741076214120093531),
)


def g2_is_on_curve(p) -> bool:
    if p is None:
        return True
    x, y = p
    return fq2_sub(fq2_sqr(y), fq2_add(fq2_mul(fq2_sqr(x), x), B2)) == FQ2_ZERO


def g2_add(p, r):
    if p is None:
        return r
    if r is None:
        return p
    x1, y1 = p
    x2, y2 = r
    if x1 == x2:
        if fq2_add(y1, y2) == FQ2_ZERO:
            return None
        return g2_double(p)
    lam = fq2_mul(fq2_sub(y2, y1), fq2_inv(fq2_sub(x2, x1)))
    x3 = fq2_sub(fq2_sub(fq2_sqr(lam), x1), x2)
    y3 = fq2_sub(fq2_mul(lam, fq2_sub(x1, x3)), y1)
    return (x3, y3)


def g2_double(p):
    if p is None:
        return None
    x, y = p
    if y == FQ2_ZERO:
        return None
    lam = fq2_mul(fq2_scalar(fq2_sqr(x), 3), fq2_inv(fq2_scalar(y, 2)))
    x3 = fq2_sub(fq2_sqr(lam), fq2_scalar(x, 2))
    y3 = fq2_sub(fq2_mul(lam, fq2_sub(x, x3)), y)
    return (x3, y3)


def g2_neg(p):
    if p is None:
        return None
    return (p[0], fq2_neg(p[1]))


def g2_mul(p, k: int):
    k %= R
    res = None
    acc = p
    while k:
        if k & 1:
            res = g2_add(res, acc)
        acc = g2_double(acc)
        k >>= 1
    return res


# ---------------------------------------------------------------------------
# Optimal ate pairing.
# ---------------------------------------------------------------------------

def _line(p1, p2, t):
    """Line through p1, p2 (G2 affine on the twist) evaluated at t in G1,
    as a full Fq12 element.

    Untwist for the D-type twist: G2 (x', y') -> (x' w^2, y' w^3) on E(Fq12).
    Fq12 basis over Fq2 is {1, v, v^2, w, v w, v^2 w} with w^2 = v, so an
    element ((a0,a1,a2),(b0,b1,b2)) carries w-powers {0,2,4,1,3,5}.

    Non-vertical line through untwisted points with twist-slope lam (Fq2):
        l(t) = yt + (-lam*xt) * w + (lam*x1 - y1) * w^3
    Vertical line (p2 == -p1):
        l(t) = xt + (-x1) * w^2
    """
    x1, y1 = p1
    x2, y2 = p2
    xt, yt = t
    if x1 != x2:
        lam = fq2_mul(fq2_sub(y2, y1), fq2_inv(fq2_sub(x2, x1)))
    elif fq2_add(y1, y2) == FQ2_ZERO:
        c0 = ((xt % Q, 0), fq2_neg(x1), FQ2_ZERO)
        return (c0, FQ6_ZERO)
    else:
        lam = fq2_mul(fq2_scalar(fq2_sqr(x1), 3), fq2_inv(fq2_scalar(y1, 2)))
    c0 = (((yt % Q), 0), FQ2_ZERO, FQ2_ZERO)
    c1 = (fq2_neg(fq2_scalar(lam, xt % Q)), fq2_sub(fq2_mul(lam, x1), y1), FQ2_ZERO)
    return (c0, c1)


def miller_loop(p, q_pt):
    """Optimal ate Miller loop for BN curves, f_{6t+2,Q}(P) with the two
    Frobenius correction lines."""
    if p is None or q_pt is None:
        return FQ12_ONE
    f = FQ12_ONE
    r_pt = q_pt
    # 6t+2 in binary, MSB-first skipping the top bit
    e = ATE_LOOP_COUNT
    bits = bin(e)[3:]
    for bit in bits:
        f = fq12_mul(fq12_sqr(f), _line(r_pt, r_pt, p))
        r_pt = g2_double(r_pt)
        if bit == "1":
            f = fq12_mul(f, _line(r_pt, q_pt, p))
            r_pt = g2_add(r_pt, q_pt)
    # Frobenius corrections: Q1 = pi(Q), Q2 = -pi^2(Q)
    q1 = _g2_frobenius(q_pt)
    q2 = g2_neg(_g2_frobenius(q1))
    f = fq12_mul(f, _line(r_pt, q1, p))
    r_pt = g2_add(r_pt, q1)
    f = fq12_mul(f, _line(r_pt, q2, p))
    return f


# Frobenius on twisted G2 coords: (x, y) -> (conj(x) * gamma12, conj(y) * gamma13)
_G2_FROB_X = _GAMMA1[2]  # xi^((q-1)/3)
_G2_FROB_Y = _GAMMA1[3]  # xi^((q-1)/2)


def _g2_frobenius(p):
    if p is None:
        return None
    x, y = p
    return (fq2_mul(fq2_conj(x), _G2_FROB_X), fq2_mul(fq2_conj(y), _G2_FROB_Y))


def final_exponentiation(f):
    """f^((q^12 - 1)/r)."""
    # easy part: f^(q^6-1)(q^2+1)
    f1 = fq12_conj(f)
    f2 = fq12_inv(f)
    f = fq12_mul(f1, f2)           # f^(q^6 - 1)
    f = fq12_mul(fq12_frobenius(fq12_frobenius(f)), f)  # ^(q^2 + 1)
    # hard part (q^4 - q^2 + 1)/r — use generic exponentiation for clarity;
    # replaced by the fast BN addition chain in the native (C++) verifier.
    e = (Q ** 4 - Q ** 2 + 1) // R
    return fq12_pow(f, e)


def pairing(p, q_pt):
    """e(P, Q) for P in G1, Q in G2 (affine tuples)."""
    return final_exponentiation(miller_loop(p, q_pt))


def pairing_check(pairs) -> bool:
    """prod e(P_i, Q_i) == 1, with a single final exponentiation."""
    f = FQ12_ONE
    for p, q_pt in pairs:
        f = fq12_mul(f, miller_loop(p, q_pt))
    return final_exponentiation(f) == FQ12_ONE
