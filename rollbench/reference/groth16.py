"""Groth16 proofs worked out from the setup seed, with no key tables.

The setup seed is the deployment's ceremony, and the benchmark hands it to
the program and to this reference alike. From it the reference derives the
toxic scalars (alpha, beta, gamma, delta, tau) by the derivation the
program's setup states (SHA-512 of seed | tag | counter, mod r; tau drawn
again while it lands in the domain), evaluates the QAP of its own R1CS at
tau (domain rows: the constraints, then one binding row per public
variable that gives A an extra 1), and forms each proof point as ONE scalar
times the generator:

    A = (alpha + U + r delta) G1
    B = (beta + V + s delta) G2
    C = ((K_priv + U V - W) / delta + s a + r b - r s delta) G1

with U, V, W the witness's A, B, C polynomials at tau, K_priv the private
variables' share of beta U + alpha V + W, and a, b the scalars of A and B.
U V - W = h(tau) Z(tau) holds because the witness satisfies every row
(the frozen builder checks each constraint as it synthesizes), so the
quotient's NTTs, the MSMs over the key's tables, the merging of duplicate
points and the blinding all reduce to these scalars.
A proof of the program that equals this one, point for point, is the
Groth16 proof of this witness under this key with this (r, s).
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

from . import bn254
from .bn254 import R as FR

TWO_ADICITY = 28
GENERATOR = 5


def derive_scalar(seed: bytes, tag: bytes, ctr: int = 0) -> int:
    while True:
        h = hashlib.sha512(seed + b"|" + tag + b"|" + ctr.to_bytes(4, "big"))
        v = int.from_bytes(h.digest(), "big") % FR
        if v > 1:
            return v
        ctr += 1


def domain(n_constraints: int, n_public: int) -> int:
    """The smallest power of two holding the constraints and one binding
    row per public variable."""
    rows = n_constraints + n_public
    return 1 << max((rows - 1).bit_length(), 1)


def _batch_inv(xs: List[int]) -> List[int]:
    prefix = [1] * (len(xs) + 1)
    for i, x in enumerate(xs):
        prefix[i + 1] = prefix[i] * x % FR
    acc = pow(prefix[-1], FR - 2, FR)
    out = [0] * len(xs)
    for i in range(len(xs) - 1, -1, -1):
        out[i] = prefix[i] * acc % FR
        acc = acc * xs[i] % FR
    return out


def lagrange_at(tau: int, m: int) -> Optional[List[int]]:
    """L_j(tau) over the m-th roots of unity, or None if tau is one."""
    z_tau = (pow(tau, m, FR) - 1) % FR
    if z_tau == 0:
        return None
    w = pow(GENERATOR, (FR - 1) >> TWO_ADICITY, FR)
    omega = pow(w, 1 << (TWO_ADICITY - (m.bit_length() - 1)), FR)
    pw = [1] * m
    for j in range(1, m):
        pw[j] = pw[j - 1] * omega % FR
    dinv = _batch_inv([(tau - p) % FR for p in pw])
    scale = z_tau * pow(m, FR - 2, FR) % FR
    return [scale * pw[j] % FR * dinv[j] % FR for j in range(m)]


@dataclass
class Toxic:
    alpha: int
    beta: int
    gamma: int
    delta: int
    tau: int
    lag: List[int]


def toxic(seed: bytes, m: int) -> Toxic:
    alpha, beta, gamma, delta = (derive_scalar(seed, t) for t in
                                 (b"alpha", b"beta", b"gamma", b"delta"))
    ctr = 0
    while True:
        tau = derive_scalar(seed, b"tau", ctr)
        lag = lagrange_at(tau, m)
        if lag is not None:
            return Toxic(alpha, beta, gamma, delta, tau, lag)
        ctr += 1


class ProofReference:
    """Proofs of one circuit (its R1CS: constraints as (A, B, C) dicts of
    variable -> coefficient, n_public variables bound) under the key of
    `setup_seed`."""

    def __init__(self, r1cs, setup_seed: bytes):
        self.n_vars, self.n_public = r1cs.n_vars, r1cs.n_public
        self.constraints = r1cs.constraints
        self.m = domain(r1cs.n_constraints, r1cs.n_public)
        self.t = toxic(setup_seed, self.m)
        lag = self.t.lag
        nv = self.n_vars
        a_t, b_t, c_t = [0] * nv, [0] * nv, [0] * nv
        for j, (a, b, c) in enumerate(self.constraints):
            lj = lag[j]
            for v, k in a.items():
                a_t[v] = (a_t[v] + k * lj) % FR
            for v, k in b.items():
                b_t[v] = (b_t[v] + k * lj) % FR
            for v, k in c.items():
                c_t[v] = (c_t[v] + k * lj) % FR
        nc = len(self.constraints)
        for s in range(self.n_public):
            a_t[s] = (a_t[s] + lag[nc + s]) % FR
        self.a_t, self.b_t, self.c_t = a_t, b_t, c_t

    def scalars(self, witness: Sequence[int], quotient: bool = True
                ) -> Tuple[int, int, int, int]:
        """(U, V, W, K_priv) of a witness; quotient=False leaves the
        quotient's U V - W out of the returned W (the control: the proof
        the program would give if it skipped the quotient)."""
        if len(witness) != self.n_vars:
            raise ValueError(f"witness of {len(witness)} variables, the "
                             f"circuit has {self.n_vars}")
        w = [x % FR for x in witness]
        npub = self.n_public
        sums = []
        for tab in (self.a_t, self.b_t, self.c_t):
            pub = sum(x * y for x, y in zip(w[:npub], tab[:npub])) % FR
            tot = (pub + sum(x * y for x, y in zip(w[npub:], tab[npub:]))) % FR
            sums.append((tot, pub))
        (u, u_pub), (v, v_pub), (wc, w_pub) = sums
        t = self.t
        k_priv = (t.beta * (u - u_pub) + t.alpha * (v - v_pub) + wc - w_pub) % FR
        if not quotient:
            wc = (u * v) % FR  # U V - W becomes 0
        return u, v, wc, k_priv

    def proof(self, sc: Tuple[int, int, int, int], r: int, s: int):
        """(A, B, C) affine points, None for infinity, as the program's
        Proof holds them."""
        u, v, wc, k_priv = sc
        t = self.t
        a = (t.alpha + u + r * t.delta) % FR
        b = (t.beta + v + s * t.delta) % FR
        inv_delta = pow(t.delta, FR - 2, FR)
        c = ((k_priv + u * v - wc) * inv_delta + s * a + r * b
             - r * s % FR * t.delta) % FR
        return (bn254.g1_mul(bn254.G1_GEN, a), bn254.g2_mul(bn254.G2_GEN, b),
                bn254.g1_mul(bn254.G1_GEN, c))
