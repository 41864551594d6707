"""Constraint gadgets: bits, comparators, MiMC, BabyJubJub, Merkle, EdDSA.

Functional equivalents of the circomlib templates the reference circuits
instantiate (bitify/comparators/mux1/escalarmul*/mimcsponge — see
simple-zk-rollups/prover/circuits/*.circom) — designed fresh for this builder:
linear steps are free (LC algebra), products/bits/inverses allocate
witnesses. Semantics notes:

  - comparators are SOUND versions: the reference uses circomlib
    GreaterThan(256) over a 254-bit field (unsound shift); we range-check
    operands and compare at 252 bits. Honest inputs behave identically.
  - assert_lt_const replaces CompConstant: MSB-down equality chain,
    ~2 constraints/bit, used for S < subOrder and the Num2Bits_strict
    alias check (bits < p).
  - fixed-base scalar mul exploits constant base points: an Edwards add
    with one constant operand costs 3 constraints (vs 8 variable/variable).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

from ..ref.bn254 import R as P
from ..ref import babyjubjub as bjj
from ..ref.mimc import mimcsponge_constants, N_ROUNDS_SPONGE
from .builder import Builder, LC, _as_lc


# -- bits -------------------------------------------------------------------

def assert_bit(bld: Builder, b) -> None:
    bld.enforce(b, _as_lc(b) - 1, 0)


def num2bits(bld: Builder, x, n: int) -> List[LC]:
    """Decompose into n bits (LSB first); enforces reconstruction.
    Unique (alias-free) for n <= 253."""
    v = bld.value(x)
    bits = []
    acc = LC.const(0)
    for i in range(n):
        b = bld.alloc((v >> i) & 1)
        assert_bit(bld, b)
        bits.append(b)
        acc = acc + b * pow(2, i, P)
    bld.enforce_equal(acc, x)
    return bits


def bits2num(bld: Builder, bits: Sequence) -> LC:
    acc = LC.const(0)
    for i, b in enumerate(bits):
        acc = acc + _as_lc(b) * pow(2, i, P)
    return acc


def assert_lt_const(bld: Builder, bits_lsb: Sequence, ct: int) -> None:
    """Enforce (bits as integer) < ct, for constrained boolean bits.
    MSB-down scan: lt = OR_k [prefix-equal(k) AND b_k=0 AND ct_k=1]."""
    n = len(bits_lsb)
    assert 0 < ct < (1 << n)
    eq = LC.const(1)       # "all higher bits equal ct's bits"
    lt = LC.const(0)
    for k in range(n - 1, -1, -1):
        b = _as_lc(bits_lsb[k])
        c_k = (ct >> k) & 1
        if c_k:
            lt = lt + bld.mul(eq, LC.const(1) - b)
            eq = bld.mul(eq, b)
        else:
            eq = bld.mul(eq, LC.const(1) - b)
    bld.enforce_equal(lt, 1)


def num2bits_strict(bld: Builder, x) -> List[LC]:
    """254-bit decomposition with alias check (value < p)."""
    bits = num2bits(bld, x, 254)
    assert_lt_const(bld, bits, P)
    return bits


# -- arithmetic predicates --------------------------------------------------

def is_zero(bld: Builder, x) -> LC:
    x = _as_lc(x)
    v = bld.value(x)
    inv = bld.alloc(pow(v, -1, P) if v else 0)
    out = bld.alloc(0 if v else 1)
    bld.enforce(x, inv, LC.const(1) - out)
    bld.enforce(x, out, 0)
    return out


def is_equal(bld: Builder, a, b) -> LC:
    return is_zero(bld, _as_lc(a) - _as_lc(b))


def mux1(bld: Builder, c0, c1, s) -> LC:
    """s==0 -> c0, s==1 -> c1 (s boolean-constrained by caller)."""
    return _as_lc(c0) + bld.mul(s, _as_lc(c1) - _as_lc(c0))


def less_than(bld: Builder, a, b, n: int = 252) -> LC:
    """[a < b] for a, b < 2^n (caller range-checks). Standard shift trick."""
    bits = num2bits(bld, _as_lc(a) + pow(2, n, P) - _as_lc(b), n + 1)
    return LC.const(1) - bits[n]


def greater_than(bld: Builder, a, b, n: int = 252) -> LC:
    return less_than(bld, b, a, n)


# -- MiMCSponge (220-round Feistel; 3 constraints per round) ----------------

def mimc_feistel(bld: Builder, x_l, x_r, k) -> Tuple[LC, LC]:
    """220-round MiMC Feistel, 3 constraints/round (hasher.circom:3-30).

    Hand-rolled against the builder's raw lists instead of LC operator
    overloading: this gadget dominates synthesis (every tree level, leaf,
    tx hash and EdDSA h runs it — 3.7s of a 5s (2,6) synthesis profile),
    and its constraints are satisfied by construction, so the per-op
    check/coerce machinery is pure overhead here."""
    cts = mimcsponge_constants(N_ROUNDS_SPONGE)
    x_l, x_r, k = _as_lc(x_l), _as_lc(x_r), _as_lc(k)
    values = bld.values
    cons = bld.constraints
    bld._io_frozen = True

    kt = k.terms
    kv = sum(c * values[i] for i, c in kt.items()) % P
    lt, lv = dict(x_l.terms), bld.value(x_l)
    rt, rv = dict(x_r.terms), bld.value(x_r)

    last = N_ROUNDS_SPONGE - 1
    for i in range(N_ROUNDS_SPONGE):
        ct = cts[i]
        # t = x_l + k + ct
        tt = dict(lt)
        for idx, c in kt.items():
            nv = (tt.get(idx, 0) + c) % P
            if nv:
                tt[idx] = nv
            else:
                tt.pop(idx, None)
        if ct:
            nv = (tt.get(0, 0) + ct) % P
            if nv:
                tt[0] = nv
            else:
                tt.pop(0, None)
        tv = (lv + kv + ct) % P
        # t2 = t*t; t4 = t2*t2; t5 = t4*t
        t2v = tv * tv % P
        i2 = len(values)
        values.append(t2v)
        cons.append((tt, tt, {i2: 1}))
        t4v = t2v * t2v % P
        i4 = len(values)
        values.append(t4v)
        cons.append(({i2: 1}, {i2: 1}, {i4: 1}))
        t5v = t4v * tv % P
        i5 = len(values)
        values.append(t5v)
        cons.append(({i4: 1}, tt, {i5: 1}))

        if i < last:
            nlt = dict(rt)
            nlt[i5] = (nlt.get(i5, 0) + 1) % P
            nlv = (rv + t5v) % P
            rt, rv = lt, lv
            lt, lv = nlt, nlv
            if len(lt) > 8:   # bound Feistel-state LC growth (materialize)
                im = len(values)
                values.append(lv)
                d = {im: 1}
                for idx, c in lt.items():
                    nv = (d.get(idx, 0) - c) % P
                    if nv:
                        d[idx] = nv
                    else:
                        d.pop(idx, None)
                cons.append((d, {0: 1}, {}))
                lt = {im: 1}
        else:
            rt = dict(rt)
            rt[i5] = (rt.get(i5, 0) + 1) % P
            rv = (rv + t5v) % P

    return LC(lt), LC(rt)


def mimc_multihash(bld: Builder, inputs: Sequence, key=0) -> LC:
    """Hasher(length) parity (prover/circuits/hasher.circom:3-16)."""
    r, c = LC.const(0), LC.const(0)
    for x in inputs:
        r = r + _as_lc(x)
        r, c = mimc_feistel(bld, r, c, key)
    return r


def hash_left_right(bld: Builder, left, right) -> LC:
    return mimc_multihash(bld, [left, right])


# -- BabyJubJub (twisted Edwards in Fr) -------------------------------------

A_COEFF = bjj.A
D_COEFF = bjj.D


def edwards_add(bld: Builder, p1, p2) -> Tuple[LC, LC]:
    """Complete Edwards addition; 8 constraints."""
    x1, y1 = p1
    x2, y2 = p2
    x1x2 = bld.mul(x1, x2)
    y1y2 = bld.mul(y1, y2)
    x1y2 = bld.mul(x1, y2)
    y1x2 = bld.mul(y1, x2)
    f = bld.mul(x1x2, y1y2) * D_COEFF
    x3 = bld.div(x1y2 + y1x2, LC.const(1) + f)
    y3 = bld.div(y1y2 - x1x2 * A_COEFF, LC.const(1) - f)
    return x3, y3


def edwards_double(bld: Builder, p) -> Tuple[LC, LC]:
    return edwards_add(bld, p, p)


def edwards_add_const(bld: Builder, p, q_const: Tuple[int, int]) -> Tuple[LC, LC]:
    """p + constant point; x*const products are linear -> 3 constraints."""
    x1, y1 = p
    cx, cy = q_const[0] % P, q_const[1] % P
    x1x2 = _as_lc(x1) * cx
    y1y2 = _as_lc(y1) * cy
    x1y2 = _as_lc(x1) * cy
    y1x2 = _as_lc(y1) * cx
    f = bld.mul(x1x2, y1y2) * D_COEFF
    x3 = bld.div(x1y2 + y1x2, LC.const(1) + f)
    y3 = bld.div(y1y2 - x1x2 * A_COEFF, LC.const(1) - f)
    return x3, y3


def edwards_scalar_mul_fixed(bld: Builder, bits_lsb: Sequence,
                             base: Tuple[int, int]) -> Tuple[LC, LC]:
    """bits * base for a CONSTANT base (EscalarMulFix analog).
    Host-precomputed doubles; conditional constant-add per bit."""
    acc = (LC.const(0), LC.const(1))  # identity
    mult = base
    for b in bits_lsb:
        added = edwards_add_const(bld, acc, mult)
        acc = (mux1(bld, acc[0], added[0], b), mux1(bld, acc[1], added[1], b))
        mult = bjj.double(mult)
    return acc


def edwards_scalar_mul_any(bld: Builder, bits_lsb: Sequence, point) -> Tuple[LC, LC]:
    """bits * point for a variable point (EscalarMulAny analog)."""
    acc = (LC.const(0), LC.const(1))
    mult = point
    for i, b in enumerate(bits_lsb):
        added = edwards_add(bld, acc, mult)
        acc = (mux1(bld, acc[0], added[0], b), mux1(bld, acc[1], added[1], b))
        if i != len(bits_lsb) - 1:
            mult = edwards_double(bld, mult)
    return acc


# -- Merkle path (merkletree.circom parity) ---------------------------------

def path_selector(bld: Builder, inp, path_element, path_index):
    """pathIndex==0 -> (in, elem); ==1 -> (elem, in). Boolean-enforced.
    (merkletree.circom:5-28)"""
    idx = _as_lc(path_index)
    bld.enforce(idx, idx - 1, 0)
    left = mux1(bld, inp, path_element, idx)
    right = mux1(bld, path_element, inp, idx)
    return left, right


def merkle_root_from_path(bld: Builder, leaf, path_elements, path_indexes) -> LC:
    """MerkleTreeRootConstructor (merkletree.circom:33-64)."""
    cur = _as_lc(leaf)
    for elem, idx in zip(path_elements, path_indexes):
        left, right = path_selector(bld, cur, elem, idx)
        cur = hash_left_right(bld, left, right)
    return cur


def merkle_leaf_exists(bld: Builder, leaf, path_elements, path_indexes, root) -> None:
    """MerkleTreeLeafExists (merkletree.circom:67-84)."""
    computed = merkle_root_from_path(bld, leaf, path_elements, path_indexes)
    bld.enforce_equal(computed, root)


# -- EdDSA (eddsa.circom parity) --------------------------------------------

def eddsa_verify(bld: Builder, ax, ay, s, r8x, r8y, msg) -> LC:
    """EdDSAMiMCSpongeVerifierPatched (eddsa.circom:12-110): returns a
    `valid` signal (1 iff S*B8 == R8 + 8*hm*A); hard-asserts S < subOrder
    and 8*A != identity."""
    # S < subgroup order (compconstant check, eddsa.circom:29-38)
    s_bits = num2bits(bld, s, 253)
    assert_lt_const(bld, s_bits + [LC.const(0)], bjj.SUB_ORDER)

    # h = H(R8, A, M)
    hm = mimc_multihash(bld, [r8x, r8y, ax, ay, msg])
    h_bits = num2bits_strict(bld, hm)

    # 8*A via three doublings; must not be the identity (eddsa.circom:56-69)
    a8 = (ax, ay)
    for _ in range(3):
        a8 = edwards_double(bld, a8)
    bld.enforce_equal(is_zero(bld, a8[0]), 0)

    right2 = edwards_scalar_mul_any(bld, h_bits, a8)
    right = edwards_add(bld, (r8x, r8y), right2)
    left = edwards_scalar_mul_fixed(bld, s_bits, bjj.BASE8)

    rv = is_equal(bld, left[0], right[0])
    lv = is_equal(bld, left[1], right[1])
    return is_equal(bld, rv + lv, 2)


def verify_eddsa_signature(bld: Builder, from_x, from_y, r8x, r8y, s,
                           preimage: Sequence) -> LC:
    """VerifyEdDSASignature(k): hash preimage, then verify
    (eddsa.circom:113-139)."""
    m = mimc_multihash(bld, preimage)
    return eddsa_verify(bld, from_x, from_y, s, r8x, r8y, m)
