"""Groth16 key / proof containers + persistence (jax-free).

Counterpart of zkrollup/groth16/keys.py, with the same dataclasses and the
SAME npz format: a key written by zkrollup's setup loads here unchanged and
the reverse holds too. Packed G1 table: (x, y, inf) with x, y (n, 16) uint32
Montgomery limbs and inf (n, 1) bool; packed G2 table: ((x0, x1), (y0, y1),
inf). Device copies of the tables are cached on the key by the prover.
"""

from __future__ import annotations

import hashlib

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

from ..fields import limbs as L


@dataclass
class Proof:
    """Affine proof points as plain ints: a, c in G1 ((x, y)); b in G2
    (((x0, x1), (y0, y1))) — the (pi_a, pi_b, pi_c) triple snarkjs emits
    (operator/src/snarks/common.ts:29-51 formats the same shape for the
    EVM)."""
    a: Tuple[int, int]
    b: Tuple[Tuple[int, int], Tuple[int, int]]
    c: Tuple[int, int]


@dataclass
class VerifyingKey:
    """vk_alpha1/beta2/gamma2/delta2 + IC — the embedded constants of
    TxVerifier.sol:176-257 / WithdrawVerifier.sol."""
    alpha1: Tuple[int, int]
    beta2: Tuple[Tuple[int, int], Tuple[int, int]]
    gamma2: Tuple[Tuple[int, int], Tuple[int, int]]
    delta2: Tuple[Tuple[int, int], Tuple[int, int]]
    ic: List[Tuple[int, int]]


@dataclass
class ProvingKey:
    n_vars: int
    n_public: int       # 1 + outputs + public inputs (the bound section)
    domain_size: int
    alpha1: Tuple[int, int]
    beta1: Tuple[int, int]
    delta1: Tuple[int, int]
    beta2: Tuple
    delta2: Tuple
    a_g1: Tuple     # (n_vars) packed G1: A_i(tau) * G1
    b1_g1: Tuple    # (n_vars) packed G1: B_i(tau) * G1
    b2_g2: Tuple    # (n_vars) packed G2: B_i(tau) * G2
    c_g1: Tuple     # (n_vars - n_public): ((beta A + alpha B + C)/delta) * G1
    h_g1: Tuple     # (domain_size - 1): (tau^j Z(tau)/delta) * G1
    vk: VerifyingKey
    r1cs_digest: bytes = b""   # sha256 of the bound constraint system

    # -- persistence (npz; ints round-trip through 16-limb arrays) ----------

    def save(self, path: str) -> None:
        g1s = {"alpha1": self.alpha1, "beta1": self.beta1,
               "delta1": self.delta1, "vk_alpha1": self.vk.alpha1}
        g2s = {"beta2": self.beta2, "delta2": self.delta2,
               "vk_beta2": self.vk.beta2, "vk_gamma2": self.vk.gamma2,
               "vk_delta2": self.vk.delta2}
        arrs = {
            "meta": np.asarray(
                [self.n_vars, self.n_public, self.domain_size], np.int64),
            "ic": _pts_to_arr(self.vk.ic),
            "r1cs_digest": np.frombuffer(self.r1cs_digest or b"\0",
                                         dtype=np.uint8).copy(),
        }
        for name, p in g1s.items():
            arrs[name] = _pts_to_arr([p])
        for name, p in g2s.items():
            arrs[name] = _g2pts_to_arr([p])
        for name, t in (("a_g1", self.a_g1), ("b1_g1", self.b1_g1),
                        ("c_g1", self.c_g1), ("h_g1", self.h_g1)):
            x, y, inf = t
            arrs[f"{name}_x"], arrs[f"{name}_y"] = x, y
            arrs[f"{name}_inf"] = inf
        (x0, x1), (y0, y1), inf = self.b2_g2
        arrs.update(b2_x0=x0, b2_x1=x1, b2_y0=y0, b2_y1=y1, b2_inf=inf)
        np.savez_compressed(path, **arrs)

    @classmethod
    def load(cls, path: str) -> "ProvingKey":
        z = np.load(path)
        n_vars, n_public, domain_size = (int(v) for v in z["meta"])
        digest = (bytes(z["r1cs_digest"].tobytes())
                  if "r1cs_digest" in z.files else b"")
        if digest == b"\0":
            digest = b""
        g1 = lambda k: _arr_to_pts(z[k])[0]
        g2 = lambda k: _arr_to_g2pts(z[k])[0]
        tbl = lambda k: (z[f"{k}_x"], z[f"{k}_y"], z[f"{k}_inf"])
        vk = VerifyingKey(
            alpha1=g1("vk_alpha1"), beta2=g2("vk_beta2"),
            gamma2=g2("vk_gamma2"), delta2=g2("vk_delta2"),
            ic=_arr_to_pts(z["ic"]))
        return cls(
            n_vars=n_vars, n_public=n_public, domain_size=domain_size,
            alpha1=g1("alpha1"), beta1=g1("beta1"), delta1=g1("delta1"),
            beta2=g2("beta2"), delta2=g2("delta2"),
            a_g1=tbl("a_g1"), b1_g1=tbl("b1_g1"),
            b2_g2=((z["b2_x0"], z["b2_x1"]), (z["b2_y0"], z["b2_y1"]),
                   z["b2_inf"]),
            c_g1=tbl("c_g1"), h_g1=tbl("h_g1"), vk=vk,
            r1cs_digest=digest)


# -- int <-> array helpers (points as plain-int coords; None = infinity) -----

def _pts_to_arr(pts) -> np.ndarray:
    flat = []
    for p in pts:
        if p is None:
            flat += [0, 0, 1]
        else:
            flat += [p[0], p[1], 0]
    return L.ints_to_limbs(flat)


def _arr_to_pts(a) -> list:
    vals = L.limbs_to_ints(a)
    out = []
    for i in range(0, len(vals), 3):
        x, y, inf = vals[i:i + 3]
        out.append(None if inf else (x, y))
    return out


def _g2pts_to_arr(pts) -> np.ndarray:
    flat = []
    for p in pts:
        if p is None:
            flat += [0, 0, 0, 0, 1]
        else:
            flat += [p[0][0], p[0][1], p[1][0], p[1][1], 0]
    return L.ints_to_limbs(flat)


def _arr_to_g2pts(a) -> list:
    vals = L.limbs_to_ints(a)
    out = []
    for i in range(0, len(vals), 5):
        x0, x1, y0, y1, inf = vals[i:i + 5]
        out.append(None if inf else ((x0, x1), (y0, y1)))
    return out


def r1cs_digest(r1cs) -> bytes:
    """Structural fingerprint of a constraint system: setup binds keys to
    the EXACT rows, so key caches must compare this — var/constraint
    counts alone can collide across gadget rewrites (observed: a Feistel
    gadget rework kept n_vars while moving coefficients)."""
    h = hashlib.sha256()
    h.update(f"{r1cs.n_vars},{r1cs.n_public},"
             f"{r1cs.n_constraints}".encode())
    for A, B, C in r1cs.constraints:
        for mat in (A, B, C):
            h.update(len(mat).to_bytes(4, "little"))
            for k in sorted(mat):
                h.update(int(k).to_bytes(4, "little"))
                h.update(int(mat[k]).to_bytes(32, "little", signed=False))
    return h.digest()
