"""snarkjs / websnark interoperability: key + witness + proof formats.

The reference's proving stack speaks three serialization dialects
(SURVEY §2.2 "Binarify" row):

  1. snarkjs JSON (stringified bigints) — proving/verifying keys emitted by
     `snarkjs setup --protocol groth` (simple-zk-rollups/prover/package.json:35,38)
     and proofs consumed by `groth.isValid`.
  2. websnark packed binary — what binarifyWitness / binarifyProvingKey
     (simple-zk-rollups/operator/src/utils/binarify.ts:10-207) produce for the
     WASM prover: header {nVars, nPublic, domainSize}, a 7-entry pointer
     table, G1/G2 points in Montgomery form (x 2^256 mod q), sparse A/B
     polynomials as {constraint-row: coeff mod r (Montgomery)} lists, point
     tables A, B1, B2, C (skipping the first nPublic+1 entries), and
     hExps[domainSize].
  3. Solidity calldata — chain/calldata.py.

This module converts between those dialects and this framework's native key
containers (groth16/keys.py), in both directions, so snarkjs-format keys can
be loaded into the prover and our keys/proofs can be consumed by
reference-format tooling.

Counterpart of zkrollup/groth16/interop.py, the same code over the port's
own limbs, FQ / FR host codecs, ref.bn254, keys and qap.
"""

from __future__ import annotations

import json
import struct
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..fields import limbs as L
from ..fields.mont import FQ, FR
from ..ref.bn254 import Q, R as FR_MOD
from .keys import Proof, ProvingKey, VerifyingKey
from .qap import to_coo, domain_for

R256 = 1 << 256


# ---------------------------------------------------------------------------
# snarkjs bigint-string JSON helpers
# ---------------------------------------------------------------------------

def stringify_bigints(x):
    """ints -> decimal strings, recursively (snarkjs stringifyBigInts)."""
    if isinstance(x, bool) or x is None:
        return x
    if isinstance(x, int):
        return str(x)
    if isinstance(x, (list, tuple)):
        return [stringify_bigints(v) for v in x]
    if isinstance(x, dict):
        return {str(k): stringify_bigints(v) for k, v in x.items()}
    return x


def unstringify_bigints(x):
    if isinstance(x, str) and (x.isdigit() or (x[:1] == "-" and
                                               x[1:].isdigit())):
        return int(x)
    if isinstance(x, list):
        return [unstringify_bigints(v) for v in x]
    if isinstance(x, dict):
        return {k: unstringify_bigints(v) for k, v in x.items()}
    return x


# -- point <-> snarkjs 3-coordinate arrays ------------------------------------

def _g1_to_json(p) -> list:
    if p is None:
        return [0, 1, 0]  # projective infinity, snarkjs convention
    return [p[0], p[1], 1]


def _g1_from_json(p):
    if len(p) >= 3 and int(p[2]) == 0:
        return None
    return (int(p[0]), int(p[1]))


def _g2_to_json(p) -> list:
    if p is None:
        return [[0, 0], [1, 0], [0, 0]]
    return [[p[0][0], p[0][1]], [p[1][0], p[1][1]], [1, 0]]


def _g2_from_json(p):
    if len(p) >= 3 and int(p[2][0]) == 0 and int(p[2][1]) == 0:
        return None
    return ((int(p[0][0]), int(p[0][1])), (int(p[1][0]), int(p[1][1])))


# -- packed device tables <-> plain-int points --------------------------------

def _unpack_g1_table(tbl) -> List[Optional[Tuple[int, int]]]:
    x, y, inf = tbl
    xs = FQ.from_mont_host(np.asarray(x))
    ys = FQ.from_mont_host(np.asarray(y))
    infs = np.asarray(inf).reshape(-1)
    return [None if i else (a, b) for a, b, i in zip(xs, ys, infs)]


def _unpack_g2_table(tbl) -> List[Optional[tuple]]:
    (x0, x1), (y0, y1), inf = tbl
    x0s = FQ.from_mont_host(np.asarray(x0))
    x1s = FQ.from_mont_host(np.asarray(x1))
    y0s = FQ.from_mont_host(np.asarray(y0))
    y1s = FQ.from_mont_host(np.asarray(y1))
    infs = np.asarray(inf).reshape(-1)
    return [None if i else ((a, b), (c, d))
            for a, b, c, d, i in zip(x0s, x1s, y0s, y1s, infs)]


def _pack_g1_table(pts) -> tuple:
    n = len(pts)
    xs = [0 if p is None else p[0] for p in pts]
    ys = [0 if p is None else p[1] for p in pts]
    inf = np.asarray([[p is None] for p in pts], bool)
    return (FQ.to_mont_host(xs), FQ.to_mont_host(ys), inf.reshape(n, 1))


def _pack_g2_table(pts) -> tuple:
    n = len(pts)
    sel = lambda f: [0 if p is None else f(p) for p in pts]
    inf = np.asarray([[p is None] for p in pts], bool)
    return ((FQ.to_mont_host(sel(lambda p: p[0][0])),
             FQ.to_mont_host(sel(lambda p: p[0][1]))),
            (FQ.to_mont_host(sel(lambda p: p[1][0])),
             FQ.to_mont_host(sel(lambda p: p[1][1]))),
            inf.reshape(n, 1))


# ---------------------------------------------------------------------------
# sparse QAP polynomials (snarkjs polsA/polsB: per-variable {row: coeff})
# ---------------------------------------------------------------------------

def qap_pols(r1cs) -> Tuple[List[Dict[int, int]], List[Dict[int, int]]]:
    """Transpose the R1CS (with the public-signal binding rows, matching
    snarkjs setup) into per-variable sparse polynomials."""
    nv = r1cs.n_vars
    pols_a: List[Dict[int, int]] = [{} for _ in range(nv)]
    pols_b: List[Dict[int, int]] = [{} for _ in range(nv)]
    for j, (A, B, _) in enumerate(r1cs.constraints):
        for v, coeff in A.items():
            pols_a[v][j] = coeff
        for v, coeff in B.items():
            pols_b[v][j] = coeff
    nc = r1cs.n_constraints
    for s in range(r1cs.n_public):  # binding rows (qap.py docstring)
        pols_a[s][nc + s] = (pols_a[s].get(nc + s, 0) + 1) % FR_MOD
    return pols_a, pols_b


# ---------------------------------------------------------------------------
# snarkjs proving-key JSON
# ---------------------------------------------------------------------------

def proving_key_to_snarkjs(pk: ProvingKey, r1cs) -> dict:
    """Our ProvingKey + its R1CS -> snarkjs groth proving-key JSON dict
    (stringified bigints, ready for json.dump / binarify)."""
    pols_a, pols_b = qap_pols(r1cs)
    a_pts = _unpack_g1_table(pk.a_g1)
    b1_pts = _unpack_g1_table(pk.b1_g1)
    b2_pts = _unpack_g2_table(pk.b2_g2)
    c_pts = _unpack_g1_table(pk.c_g1)
    h_pts = _unpack_g1_table(pk.h_g1)
    npub_snark = pk.n_public - 1  # snarkjs nPublic excludes the ONE wire
    # C table is indexed by variable; entries 0..nPublic are never read
    c_full = [None] * pk.n_public + c_pts
    # hExps is domainSize long in the websnark layout; h has m-1 coeffs so
    # the last entry is never multiplied by a nonzero scalar
    h_full = h_pts + [None] * (pk.domain_size - len(h_pts))
    return stringify_bigints({
        "protocol": "groth",
        "nVars": pk.n_vars,
        "nPublic": npub_snark,
        "domainBits": (pk.domain_size - 1).bit_length(),
        "domainSize": pk.domain_size,
        "polsA": [dict(p) for p in pols_a],
        "polsB": [dict(p) for p in pols_b],
        "A": [_g1_to_json(p) for p in a_pts],
        "B1": [_g1_to_json(p) for p in b1_pts],
        "B2": [_g2_to_json(p) for p in b2_pts],
        "C": [_g1_to_json(p) for p in c_full],
        "hExps": [_g1_to_json(p) for p in h_full],
        "vk_alfa_1": _g1_to_json(pk.alpha1),
        "vk_beta_1": _g1_to_json(pk.beta1),
        "vk_delta_1": _g1_to_json(pk.delta1),
        "vk_beta_2": _g2_to_json(pk.beta2),
        "vk_delta_2": _g2_to_json(pk.delta2),
    })


def proving_key_from_snarkjs(pkj: dict, vk: Optional[VerifyingKey] = None
                             ) -> ProvingKey:
    """snarkjs groth proving-key JSON -> device-ready ProvingKey. The
    verifying key lives in a separate snarkjs file; pass it via `vk` (or
    load it with verifying_key_from_snarkjs) if self-verification is
    wanted."""
    p = unstringify_bigints(pkj)
    n_vars = p["nVars"]
    n_public = p["nPublic"] + 1  # include the ONE wire
    m = p["domainSize"]
    a_pts = [_g1_from_json(x) for x in p["A"]][:n_vars]
    b1_pts = [_g1_from_json(x) for x in p["B1"]][:n_vars]
    b2_pts = [_g2_from_json(x) for x in p["B2"]][:n_vars]
    c_pts = [_g1_from_json(x) for x in p["C"]][n_public:n_vars]
    h_pts = [_g1_from_json(x) for x in p["hExps"]][:m - 1]
    if vk is None:
        vk = VerifyingKey(alpha1=_g1_from_json(p["vk_alfa_1"]),
                          beta2=_g2_from_json(p["vk_beta_2"]),
                          gamma2=None, delta2=_g2_from_json(p["vk_delta_2"]),
                          ic=[])
    return ProvingKey(
        n_vars=n_vars, n_public=n_public, domain_size=m,
        alpha1=_g1_from_json(p["vk_alfa_1"]),
        beta1=_g1_from_json(p["vk_beta_1"]),
        delta1=_g1_from_json(p["vk_delta_1"]),
        beta2=_g2_from_json(p["vk_beta_2"]),
        delta2=_g2_from_json(p["vk_delta_2"]),
        a_g1=_pack_g1_table(a_pts), b1_g1=_pack_g1_table(b1_pts),
        b2_g2=_pack_g2_table(b2_pts), c_g1=_pack_g1_table(c_pts),
        h_g1=_pack_g1_table(h_pts), vk=vk)


# ---------------------------------------------------------------------------
# snarkjs verifying-key + proof JSON
# ---------------------------------------------------------------------------

def verifying_key_to_snarkjs(vk: VerifyingKey) -> dict:
    return stringify_bigints({
        "protocol": "groth",
        "nPublic": len(vk.ic) - 1,
        "IC": [_g1_to_json(p) for p in vk.ic],
        "vk_alfa_1": _g1_to_json(vk.alpha1),
        "vk_beta_2": _g2_to_json(vk.beta2),
        "vk_gamma_2": _g2_to_json(vk.gamma2),
        "vk_delta_2": _g2_to_json(vk.delta2),
    })


def verifying_key_from_snarkjs(vkj: dict) -> VerifyingKey:
    v = unstringify_bigints(vkj)
    return VerifyingKey(
        alpha1=_g1_from_json(v["vk_alfa_1"]),
        beta2=_g2_from_json(v["vk_beta_2"]),
        gamma2=_g2_from_json(v["vk_gamma_2"]),
        delta2=_g2_from_json(v["vk_delta_2"]),
        ic=[_g1_from_json(p) for p in v["IC"]])


def proof_to_snarkjs(proof: Proof) -> dict:
    return stringify_bigints({
        "protocol": "groth",
        "pi_a": _g1_to_json(proof.a),
        "pi_b": _g2_to_json(proof.b),
        "pi_c": _g1_to_json(proof.c),
    })


def proof_from_snarkjs(pj: dict) -> Proof:
    p = unstringify_bigints(pj)
    return Proof(a=_g1_from_json(p["pi_a"]), b=_g2_from_json(p["pi_b"]),
                 c=_g1_from_json(p["pi_c"]))


# ---------------------------------------------------------------------------
# websnark packed binary (binarify.ts layout), both directions
# ---------------------------------------------------------------------------

def _w_u32(buf: bytearray, v: int) -> None:
    buf += struct.pack("<I", v)


def _w_bigint(buf: bytearray, v: int) -> None:
    buf += int(v).to_bytes(32, "little")


def binarify_witness(witness: Sequence[int]) -> bytes:
    """binarifyWitness (binarify.ts:10-48): 32-byte LE limbs, in order."""
    buf = bytearray()
    for w in witness:
        _w_bigint(buf, w % FR_MOD)
    return bytes(buf)


def parse_websnark_witness(data: bytes) -> List[int]:
    assert len(data) % 32 == 0
    return [int.from_bytes(data[i:i + 32], "little")
            for i in range(0, len(data), 32)]


def binarify_proving_key(pkj: dict) -> bytes:
    """binarifyProvingKey (binarify.ts:50-207): snarkjs JSON key -> the
    websnark WASM prover's packed binary. Points are converted to Montgomery
    form (x 2^256 mod q; poly coeffs mod r)."""
    p = unstringify_bigints(pkj)
    n_vars, n_public, m = p["nVars"], p["nPublic"], p["domainSize"]

    def mont_q(x: int) -> int:
        return x * R256 % Q

    def mont_r(x: int) -> int:
        return x * R256 % FR_MOD

    def w_point(buf, pt):
        x, y = (0, 0) if pt is None else pt
        _w_bigint(buf, mont_q(x))
        _w_bigint(buf, mont_q(y))

    def w_point2(buf, pt):
        (x0, x1), (y0, y1) = ((0, 0), (0, 0)) if pt is None else pt
        for c in (x0, x1, y0, y1):
            _w_bigint(buf, mont_q(c))

    def w_poly(buf, pol: dict):
        # JS Object.keys enumerates integer-like keys in ASCENDING NUMERIC
        # order (spec: integer indices first, ascending) — not insertion
        # order; pinned by the golden fixture in tests/test_interop.py
        _w_u32(buf, len(pol))
        for k in sorted(pol, key=int):
            _w_u32(buf, int(k))
            _w_bigint(buf, mont_r(pol[k]))

    buf = bytearray()
    _w_u32(buf, n_vars)
    _w_u32(buf, n_public)
    _w_u32(buf, m)
    ptr_table = len(buf)
    buf += b"\x00" * 28  # 7 pointers, patched below

    def patch(i: int) -> None:
        struct.pack_into("<I", buf, ptr_table + 4 * i, len(buf))

    w_point(buf, _g1_from_json(p["vk_alfa_1"]))
    w_point(buf, _g1_from_json(p["vk_beta_1"]))
    w_point(buf, _g1_from_json(p["vk_delta_1"]))
    w_point2(buf, _g2_from_json(p["vk_beta_2"]))
    w_point2(buf, _g2_from_json(p["vk_delta_2"]))

    patch(0)
    for i in range(n_vars):
        w_poly(buf, p["polsA"][i])
    patch(1)
    for i in range(n_vars):
        w_poly(buf, p["polsB"][i])
    patch(2)
    for i in range(n_vars):
        w_point(buf, _g1_from_json(p["A"][i]))
    patch(3)
    for i in range(n_vars):
        w_point(buf, _g1_from_json(p["B1"][i]))
    patch(4)
    for i in range(n_vars):
        w_point2(buf, _g2_from_json(p["B2"][i]))
    patch(5)
    for i in range(n_public + 1, n_vars):
        w_point(buf, _g1_from_json(p["C"][i]))
    patch(6)
    for i in range(m):
        w_point(buf, _g1_from_json(p["hExps"][i]))
    return bytes(buf)


def parse_websnark_proving_key(data: bytes) -> dict:
    """Inverse of binarify_proving_key: packed binary -> snarkjs-JSON-shaped
    dict (plain ints). Montgomery forms are decoded back to standard."""
    rinv_q = pow(R256, -1, Q)
    rinv_r = pow(R256, -1, FR_MOD)
    off = 0

    def r_u32() -> int:
        nonlocal off
        (v,) = struct.unpack_from("<I", data, off)
        off += 4
        return v

    def r_bigint() -> int:
        nonlocal off
        v = int.from_bytes(data[off:off + 32], "little")
        off += 32
        return v

    def r_point():
        x = r_bigint() * rinv_q % Q
        y = r_bigint() * rinv_q % Q
        return None if x == 0 and y == 0 else (x, y)

    def r_point2():
        cs = [r_bigint() * rinv_q % Q for _ in range(4)]
        if all(c == 0 for c in cs):
            return None
        return ((cs[0], cs[1]), (cs[2], cs[3]))

    def r_poly() -> dict:
        n = r_u32()
        out = {}
        for _ in range(n):
            k = r_u32()
            # string keys, like the JSON the binary was packed from
            out[str(k)] = r_bigint() * rinv_r % FR_MOD
        return out

    n_vars, n_public, m = r_u32(), r_u32(), r_u32()
    off += 28  # pointer table (offsets are implied by the fixed layout)
    out = {"protocol": "groth", "nVars": n_vars, "nPublic": n_public,
           "domainSize": m}
    out["vk_alfa_1"] = _g1_to_json(r_point())
    out["vk_beta_1"] = _g1_to_json(r_point())
    out["vk_delta_1"] = _g1_to_json(r_point())
    out["vk_beta_2"] = _g2_to_json(r_point2())
    out["vk_delta_2"] = _g2_to_json(r_point2())
    out["polsA"] = [r_poly() for _ in range(n_vars)]
    out["polsB"] = [r_poly() for _ in range(n_vars)]
    out["A"] = [_g1_to_json(r_point()) for _ in range(n_vars)]
    out["B1"] = [_g1_to_json(r_point()) for _ in range(n_vars)]
    out["B2"] = [_g2_to_json(r_point2()) for _ in range(n_vars)]
    out["C"] = ([_g1_to_json(None)] * (n_public + 1)
                + [_g1_to_json(r_point())
                   for _ in range(n_vars - n_public - 1)])
    out["hExps"] = [_g1_to_json(r_point()) for _ in range(m)]
    assert off == len(data), "trailing bytes in websnark key"
    return out


# -- file helpers --------------------------------------------------------------

def save_json(obj: dict, path: str) -> None:
    with open(path, "w") as f:
        json.dump(obj, f)


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)
