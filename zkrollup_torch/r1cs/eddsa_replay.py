"""Witness-only replay of the EdDSA gadget as straight-line field arithmetic.

In witness-only synthesis (Builder(record=False)) the circuit is fixed and
only the values matter: each signature must append exactly the values that
gadgets.verify_eddsa_signature allocates, in its order, and count its
rows. The gadget spends about 0.4 s a signature on linear-combination
dicts; the arithmetic under them is small. This module appends the same
values from plain ints:

  - the two MiMC multihashes (message and h), with the Feistel state's
    materialize variables wherever the gadget's state LC passes 8 terms
    (the term counts are followed, not the LCs);
  - num2bits of S and h, assert_lt_const against SUB_ORDER and p (with
    the products that constant operands fold away left out, as the
    gadget's Builder.mul leaves them);
  - the three doublings of A, is_zero(8A.x), both scalar multiplications
    with their muxes, the R8 add and the three is_equal.

Every Edwards addition of the gadget divides by 1 + f and 1 - f. Here each
point is projective, computed by the unified addition law with those
denominators cleared and no use of the curve equation, so that X/Z and
Y/Z are the gadget's affine quotients for any input, on the curve or not,
whenever its denominators are nonzero; Z is zero exactly where one of
them is. All Z of a signature are inverted together (Montgomery's trick,
one pow), and each step's products then cost a few modular products.

verify_eddsa_signature returns None, having touched nothing, where some
denominator is zero (no honest signature has one) or a point coordinate
is a constant LC; the caller then runs the LC gadget, so every value and
every AssertionError is the gadget's there by construction. Under
check=True the replay raises where the gadget would, with its message:
S >= 2^253, S >= SUB_ORDER, 8A at x = 0. Its writing of the witness runs
in the span synth.signature.replay; a signature without that span took
the LC gadget.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Sequence, Tuple

from ..ref import babyjubjub as bjj
from ..ref.bn254 import R as P
from ..ref.mimc import N_ROUNDS_SPONGE, mimcsponge_constants
from ..spans import span
from .builder import Builder, LC, _as_lc

A = bjj.A
D = bjj.D
S_BITS = 253          # num2bits(S, 253) and the fixed-base ladder's steps
H_BITS = 254          # num2bits_strict(h) and the variable-base ladder's
MAX_TERMS = 8         # mimc_feistel materializes a state LC beyond this


@functools.lru_cache(maxsize=None)
def base8_multiples() -> Tuple[Tuple[int, int], ...]:
    """2^i BASE8 for i < S_BITS: the fixed-base ladder's constant operands,
    which edwards_scalar_mul_fixed recomputes with bjj.double on every
    call. None has a zero coordinate (they lie in the prime-order
    subgroup), so every step past the first allocates its f."""
    out = [bjj.BASE8]
    for _ in range(S_BITS - 1):
        out.append(bjj.double(out[-1]))
    assert all(x and y for x, y in out)
    return tuple(out)


# -- MiMC -------------------------------------------------------------------

def _feistel(out: List[int], lv: int, rv: int, nl: int, nr: int):
    """mimc_feistel with key 0 on state values (lv, rv) whose LCs have nl
    and nr terms: appends its values, returns (lv, rv, nl, nr)."""
    cts = mimcsponge_constants(N_ROUNDS_SPONGE)
    append = out.append
    for i in range(N_ROUNDS_SPONGE - 1):
        t = (lv + cts[i]) % P
        t2 = t * t % P
        t4 = t2 * t2 % P
        t5 = t4 * t % P
        append(t2)
        append(t4)
        append(t5)
        # (x_l, x_r) <- (x_r + t5, x_l): t5 is a fresh term of the new x_l
        lv, rv = (rv + t5) % P, lv
        nl, nr = nr + 1, nl
        if nl > MAX_TERMS:
            append(lv)
            nl = 1
    t = (lv + cts[-1]) % P
    t2 = t * t % P
    t4 = t2 * t2 % P
    t5 = t4 * t % P
    append(t2)
    append(t4)
    append(t5)
    return lv, (rv + t5) % P, nl, nr + 1


def _multihash(out: List[int], inputs: Sequence[Tuple[int, int]]):
    """mimc_multihash(inputs, key=0) over (value, LC term count) pairs:
    appends its values, returns its output's value and term count. After
    220 rounds the state's terms are all variables the hash allocated
    itself, so an input's terms never merge with them."""
    rv = cv = nr = nc = 0
    for xv, xn in inputs:
        rv, cv, nr, nc = _feistel(out, (rv + xv) % P, cv, nr + xn, nc)
    return rv, nr


def _terms(x) -> int:
    return len(_as_lc(x).terms)


# -- bits and comparators ---------------------------------------------------

def _unsatisfied(row: int, va: int) -> AssertionError:
    """Builder.enforce's error for a failed enforce_equal at `row`."""
    return AssertionError(f"unsatisfied constraint #{row}: {va} * 1 != 0")


def _mul(out: List[int], a: Tuple[bool, int], b: Tuple[bool, int]):
    """Builder.mul on operands given as (is constant, value): appends the
    product where both are variables; returns it as (is constant, value)."""
    (a_const, av), (b_const, bv) = a, b
    v = av * bv % P
    if a_const:
        return b_const or av == 0, v
    if b_const:
        return bv == 0, v
    out.append(v)
    return False, v


def _assert_lt_const(out: List[int], bits: Sequence[int], n: int,
                     ct: int) -> int:
    """assert_lt_const over bits (LSB first) padded with constant zeros to
    n bits: appends the products it allocates; returns lt's value."""
    eq = (True, 1)
    lt = 0
    for k in range(n - 1, -1, -1):
        b = (True, 0) if k >= len(bits) else (False, bits[k])
        not_b = (b[0], (1 - b[1]) % P)
        if (ct >> k) & 1:
            lt = (lt + _mul(out, eq, not_b)[1]) % P
            eq = _mul(out, eq, b)
        else:
            eq = _mul(out, eq, not_b)
    return lt


# -- points -----------------------------------------------------------------

def _add(x1, y1, z1, x2, y2, z2):
    """edwards_add on projective points, its denominators 1 +- f cleared:
    Z3 = (Z1Z2)^4 (1 + f)(1 - f)."""
    a = z1 * z2 % P
    b = a * a % P
    c = x1 * x2 % P
    d = y1 * y2 % P
    e = D * c % P * d % P
    f, g = b - e, b + e
    return (a * f % P * ((x1 * y2 + y1 * x2) % P) % P,
            a * g % P * ((d - A * c) % P) % P,
            f * g % P)


def _double(x, y, z):
    """_add of a point and itself (edwards_double)."""
    a = z * z % P
    b = a * a % P
    c = x * x % P
    d = y * y % P
    e = D * c % P * d % P
    f, g = b - e, b + e
    return (a * f % P * (2 * x * y % P) % P,
            a * g % P * ((d - A * c) % P) % P,
            f * g % P)


def _invert_all(zs: List[int]) -> Optional[List[int]]:
    """The inverses of zs with one pow (Montgomery's trick); None if any
    is zero."""
    prefix = []
    acc = 1
    for z in zs:
        prefix.append(acc)
        acc = acc * z % P
    if acc == 0:
        return None
    inv = pow(acc, -1, P)
    out = [0] * len(zs)
    for i in range(len(zs) - 1, -1, -1):
        out[i] = inv * prefix[i] % P
        inv = inv * zs[i] % P
    return out


# where _points' list holds: 2A, 4A, then 2^i 8A from i = 0 at MULTS; the
# variable-base sums of steps 1 .. H_BITS - 1 at SUMS; R8 + h 8A at RIGHT;
# the fixed-base sums of steps 1 .. S_BITS - 1 at FIXED. (Each ladder's
# step 0 adds to the identity and divides by 1.)
MULTS = 2
SUMS = MULTS + H_BITS
RIGHT = SUMS + H_BITS - 1
FIXED = RIGHT + 1


def _points(ax: int, ay: int, rx: int, ry: int, h_bits: Sequence[int],
            s_bits: Sequence[int]) -> Optional[List[Tuple[int, int]]]:
    """The affine value of every point the gadget divides out, in the order
    above; None if a denominator is zero."""
    proj = []
    p = (ax, ay, 1)
    for _ in range(3):
        p = _double(*p)
        proj.append(p)
    mults = [p]
    for _ in range(H_BITS - 1):
        p = _double(*p)
        mults.append(p)
    proj += mults[1:]
    acc = mults[0] if h_bits[0] else (0, 1, 1)
    for i in range(1, H_BITS):
        p = _add(*acc, *mults[i])
        proj.append(p)
        if h_bits[i]:
            acc = p
    proj.append(_add(rx, ry, 1, *acc))
    consts = base8_multiples()
    acc = (*consts[0], 1) if s_bits[0] else (0, 1, 1)
    for i in range(1, S_BITS):
        p = _add(*acc, *consts[i], 1)
        proj.append(p)
        if s_bits[i]:
            acc = p
    invs = _invert_all([p[2] for p in proj])
    if invs is None:
        return None
    return [(x * zi % P, y * zi % P) for (x, y, _), zi in zip(proj, invs)]


def _is_zero(out: List[int], v: int) -> int:
    """is_zero's two values (inverse, out); returns out."""
    out.append(pow(v, -1, P) if v else 0)
    out.append(0 if v else 1)
    return out[-1]


# -- the gadget -------------------------------------------------------------

def verify_eddsa_signature(bld: Builder, from_x, from_y, r8x, r8y, s,
                           preimage: Sequence) -> Optional[LC]:
    """gadgets.verify_eddsa_signature's values and rows, appended to a
    witness-only builder; its `valid` LC. None, with the builder untouched,
    where the caller must run the gadget itself (see the module note)."""
    coords = [_as_lc(v) for v in (from_x, from_y, r8x, r8y)]
    if any(c.is_const() for c in coords):
        return None
    value = bld.value
    ax, ay, rx, ry = map(value, coords)
    # rows: one a value, and five checks that allocate none (the two
    # num2bits reconstructions, the two assert_lt_const, 8A.x != 0); a
    # check's row is n0 + len(out) + the checks before it
    n0 = len(bld.constraints)
    out: List[int] = []

    # m = H(preimage); S as 253 bits, S < SUB_ORDER
    m, m_terms = _multihash(out, [(value(x), _terms(x)) for x in preimage])
    sv = value(s)
    s_bits = [(sv >> i) & 1 for i in range(S_BITS)]
    out += s_bits
    low = sv & ((1 << S_BITS) - 1)
    if bld.check and low != sv:
        raise _unsatisfied(n0 + len(out), (low - sv) % P)
    lt = _assert_lt_const(out, s_bits, S_BITS + 1, bjj.SUB_ORDER)
    if bld.check and lt != 1:
        raise _unsatisfied(n0 + len(out) + 1, (lt - 1) % P)

    # h = H(R8, A, m) as 254 bits below p (h < p: neither check can fail)
    hv, _ = _multihash(out, [(rx, _terms(r8x)), (ry, _terms(r8y)),
                             (ax, _terms(from_x)), (ay, _terms(from_y)),
                             (m, m_terms)])
    h_bits = [(hv >> i) & 1 for i in range(H_BITS)]
    out += h_bits
    _assert_lt_const(out, h_bits, H_BITS, P)

    aff = _points(ax, ay, rx, ry, h_bits, s_bits)
    if aff is None:
        return None
    mults = aff[MULTS:SUMS]
    with span("synth.signature.replay"):
        # 8A: three doublings, then 8A.x != 0
        x, y = ax, ay
        for qx, qy in aff[:3]:
            xx, yy, xy = x * x % P, y * y % P, x * y % P
            out += (xx, yy, xy, xy, xx * yy % P, qx, qy)
            x, y = qx, qy
        if _is_zero(out, x) and bld.check:
            raise _unsatisfied(n0 + len(out) + 4, 1)

        # h 8A: acc + 2^i 8A, the muxes, the next double
        accx, accy = 0, 1
        for i in range(H_BITS):
            mx, my = mults[i]
            if i == 0:
                qx, qy = mx, my
                out += (qx, qy)
            else:
                qx, qy = aff[SUMS + i - 1]
                x1x2, y1y2 = accx * mx % P, accy * my % P
                out += (x1x2, y1y2, accx * my % P, accy * mx % P,
                        x1x2 * y1y2 % P, qx, qy)
            if h_bits[i]:
                out += ((qx - accx) % P, (qy - accy) % P)
                accx, accy = qx, qy
            else:
                out += (0, 0)
            if i != H_BITS - 1:
                xx, yy, xy = mx * mx % P, my * my % P, mx * my % P
                out += (xx, yy, xy, xy, xx * yy % P, *mults[i + 1])

        # right = R8 + h 8A
        qx, qy = right = aff[RIGHT]
        x1x2, y1y2 = rx * accx % P, ry * accy % P
        out += (x1x2, y1y2, rx * accy % P, ry * accx % P, x1x2 * y1y2 % P,
                qx, qy)

        # left = S BASE8: acc + 2^i BASE8 (a constant), the muxes
        consts = base8_multiples()
        accx, accy = 0, 1
        for i in range(S_BITS):
            cx, cy = consts[i]
            if i == 0:
                qx, qy = cx, cy
                out += (qx, qy)
            else:
                qx, qy = aff[FIXED + i - 1]
                out += (accx * cx % P * (accy * cy % P) % P, qx, qy)
            if s_bits[i]:
                out += ((qx - accx) % P, (qy - accy) % P)
                accx, accy = qx, qy
            else:
                out += (0, 0)

        # valid = [left == right]
        rv = _is_zero(out, (accx - right[0]) % P)
        lv = _is_zero(out, (accy - right[1]) % P)
        _is_zero(out, (rv + lv - 2) % P)

        bld._io_frozen = True
        bld.values += out
        bld.constraints.n += len(out) + 5
        return LC.var(len(bld.values) - 1)
