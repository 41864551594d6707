"""R1CS -> QAP: domain layout, Lagrange evaluation at tau (setup), and the
COO matrices the prover's sparse mat-vec consumes.

Counterpart of zkrollup/groth16/qap.py (same conventions): evaluation rows
are the constraints, padded to a power-of-two domain, plus one binding row
per public signal s giving A_s an extra evaluation of 1 at domain point
n_constraints + s.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

from ..ref.bn254 import R as FR_MOD
from ..fields.mont import FR

TWO_ADICITY = 28
GENERATOR = 5


def domain_for(r1cs) -> Tuple[int, int]:
    """(log_m, m): smallest power-of-two domain holding constraints +
    binding rows."""
    rows = r1cs.n_constraints + r1cs.n_public
    log_m = max((rows - 1).bit_length(), 1)
    if log_m > TWO_ADICITY:
        raise ValueError("circuit exceeds Fr 2-adicity")
    return log_m, 1 << log_m


def domain_omega(log_m: int) -> int:
    w = pow(GENERATOR, (FR_MOD - 1) >> TWO_ADICITY, FR_MOD)
    return pow(w, 1 << (TWO_ADICITY - log_m), FR_MOD)


def batch_inv_host(xs: List[int]) -> List[int]:
    """Montgomery-trick batch inversion over host ints (one pow total)."""
    n = len(xs)
    prefix = [1] * (n + 1)
    for i, x in enumerate(xs):
        prefix[i + 1] = prefix[i] * x % FR_MOD
    inv_all = pow(prefix[n], FR_MOD - 2, FR_MOD)
    out = [0] * n
    for i in range(n - 1, -1, -1):
        out[i] = prefix[i] * inv_all % FR_MOD
        inv_all = inv_all * xs[i] % FR_MOD
    return out


def eval_at_tau(r1cs, tau: int):
    """Evaluate all QAP polynomials at tau.

    Returns (a_t, b_t, c_t, m, z_tau): per-variable evaluations A_i(tau),
    B_i(tau), C_i(tau) (host ints), the domain size, and Z(tau) = tau^m - 1.
    Raises ValueError if tau lies in the domain (Z(tau) == 0) so the caller
    can re-derive."""
    log_m, m = domain_for(r1cs)
    omega = domain_omega(log_m)
    z_tau = (pow(tau, m, FR_MOD) - 1) % FR_MOD
    if z_tau == 0:
        raise ValueError("tau in evaluation domain")

    # L_j(tau) = Z(tau) * omega^j / (m * (tau - omega^j))
    pw = [1] * m
    for j in range(1, m):
        pw[j] = pw[j - 1] * omega % FR_MOD
    denoms = [(tau - pw[j]) % FR_MOD for j in range(m)]
    dinv = batch_inv_host(denoms)
    m_inv = pow(m, FR_MOD - 2, FR_MOD)
    lag = [z_tau * pw[j] % FR_MOD * dinv[j] % FR_MOD * m_inv % FR_MOD
           for j in range(m)]

    nv = r1cs.n_vars
    a_t, b_t, c_t = [0] * nv, [0] * nv, [0] * nv
    for j, (A, B, C) in enumerate(r1cs.constraints):
        lj = lag[j]
        for v, coeff in A.items():
            a_t[v] = (a_t[v] + coeff * lj) % FR_MOD
        for v, coeff in B.items():
            b_t[v] = (b_t[v] + coeff * lj) % FR_MOD
        for v, coeff in C.items():
            c_t[v] = (c_t[v] + coeff * lj) % FR_MOD
    nc = r1cs.n_constraints
    for s in range(r1cs.n_public):  # binding rows (see module docstring)
        a_t[s] = (a_t[s] + lag[nc + s]) % FR_MOD
    return a_t, b_t, c_t, m, z_tau


@dataclass
class CooMatrices:
    """Device-ready sparse evaluation matrices: eval_row[j] = sum_k
    coeff_k * w[var_k] for every domain row j (constraints then binding
    rows). Limb layout: coeff in Montgomery form so one mont_mul per term
    yields a Montgomery-form product."""
    log_m: int
    m: int
    max_row_nnz: int
    a_row: np.ndarray   # (nnz,) int32
    a_var: np.ndarray
    a_coeff: np.ndarray  # (nnz, 16) uint32 mont
    b_row: np.ndarray
    b_var: np.ndarray
    b_coeff: np.ndarray
    c_row: np.ndarray
    c_var: np.ndarray
    c_coeff: np.ndarray


def to_coo(r1cs) -> CooMatrices:
    """Flatten the padded R1CS (with binding rows) into COO per matrix.
    Cached on the r1cs object (synthesis recreates structurally identical
    systems; the cache is per-instance)."""
    cached = getattr(r1cs, "_torch_coo", None)
    if cached is not None:
        return cached
    log_m, m = domain_for(r1cs)

    def flatten(mats):
        rows, vars_, coeffs = [], [], []
        nnz_per_row = []
        for j, terms in mats:
            nnz_per_row.append(len(terms))
            for v, coeff in terms.items():
                rows.append(j)
                vars_.append(v)
                coeffs.append(coeff)
        max_nnz = max(nnz_per_row) if nnz_per_row else 0
        return (np.asarray(rows, np.int32), np.asarray(vars_, np.int32),
                FR.to_mont_host(coeffs), max_nnz)

    a_mats = [(j, A) for j, (A, _, _) in enumerate(r1cs.constraints)]
    nc = r1cs.n_constraints
    a_mats += [(nc + s, {s: 1}) for s in range(r1cs.n_public)]
    b_mats = [(j, B) for j, (_, B, _) in enumerate(r1cs.constraints)]
    c_mats = [(j, C) for j, (_, _, C) in enumerate(r1cs.constraints)]

    a_row, a_var, a_coeff, na = flatten(a_mats)
    b_row, b_var, b_coeff, nb = flatten(b_mats)
    c_row, c_var, c_coeff, ncx = flatten(c_mats)
    coo = CooMatrices(
        log_m=log_m, m=m, max_row_nnz=max(na, nb, ncx),
        a_row=a_row, a_var=a_var, a_coeff=a_coeff,
        b_row=b_row, b_var=b_var, b_coeff=b_coeff,
        c_row=c_row, c_var=c_var, c_coeff=c_coeff)
    try:
        r1cs._torch_coo = coo
    except AttributeError:
        pass
    return coo
