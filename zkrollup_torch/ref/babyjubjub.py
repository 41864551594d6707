"""Pure-Python BabyJubJub (twisted Edwards curve embedded in BN254 Fr).

Parity target: circomlib's babyjub.js as used by the reference's key
derivation / EdDSA (simple-zk-rollups/operator/src/utils/crypto.ts:58-93) and
the in-circuit BASE8 constant (simple-zk-rollups/prover/circuits/eddsa.circom:87-90).

Curve: A x^2 + y^2 = 1 + D x^2 y^2 over Fr, A = 168700, D = 168696.
Identity is (0, 1); the addition law is complete on this curve.
"""

from .bn254 import R as P  # BabyJubJub lives in the BN254 scalar field Fr

A = 168700
D = 168696

# 8*Generator; the base point used for all key material
# (value pinned in simple-zk-rollups/prover/circuits/eddsa.circom:87-90)
BASE8 = (
    5299619240641551281634865583518297030282874472190772894086521144482721001553,
    16950150798460657717958625567821834550301663161624707787222815936182638968203,
)

GENERATOR = (
    995203441582195749578291179787384436505546430278305826713579947235728471134,
    5472060717959818805561601436314318772137091100104008585924551046643952123905,
)

ORDER = 21888242871839275222246405745257275088614511777268538073601725287587578984328
SUB_ORDER = ORDER >> 3

IDENTITY = (0, 1)


def is_on_curve(p) -> bool:
    x, y = p
    x2 = x * x % P
    y2 = y * y % P
    return (A * x2 + y2) % P == (1 + D * x2 % P * y2) % P


def add(p, q):
    x1, y1 = p
    x2, y2 = q
    x1x2 = x1 * x2 % P
    y1y2 = y1 * y2 % P
    dxy = D * x1x2 % P * y1y2 % P
    x3 = (x1 * y2 + y1 * x2) * pow(1 + dxy, -1, P) % P
    y3 = (y1y2 - A * x1x2) * pow(1 - dxy, -1, P) % P
    return (x3, y3)


def double(p):
    return add(p, p)


def mul_py(p, e: int):
    """Scalar multiplication, parity with babyjub.js mulPointEscalar
    (plain double-and-add on the raw integer scalar, no reduction).
    Pure-Python ground truth."""
    res = IDENTITY
    acc = p
    while e:
        if e & 1:
            res = add(res, acc)
        acc = add(acc, acc)
        e >>= 1
    return res


def mul(p, e: int):
    """mul_py, dispatched to the native C++ engine when available
    (bit-identical; differentially tested in tests/test_native.py)."""
    from ..native import engine
    if e > 0 and engine.available():
        return engine.bjj_mul(tuple(p), e)
    return mul_py(p, e)


def in_subgroup(p) -> bool:
    return is_on_curve(p) and mul(p, SUB_ORDER) == IDENTITY
