"""Groth16 trusted setup.

Counterpart of zkrollup/groth16/setup.py: the same scalar derivation from
the seed, so the same seed and R1CS give the same key bytes. `setup` makes
the fixed-base tables on a torch device (msm/fixed_base.py: the g1_madd /
g2_madd kernels and the mont_mul kernel on a CUDA device); only the O(m)
host field arithmetic (Lagrange evaluation at tau) stays on the host.
`setup_host` makes the same key with the native engine's fixed-base tables;
it is the independent check, called by name, and never taken in place of
the device.
"""

from __future__ import annotations

import hashlib
import secrets
from typing import List, Optional

from ..native import engine
from ..ref import bn254 as ref
from ..ref.bn254 import R as FR_MOD
from ..fields.mont import FQ
from ..msm.fixed_base import g1_points_from_scalars, g2_points_from_scalars
from .keys import ProvingKey, VerifyingKey, r1cs_digest
from .qap import eval_at_tau


def _derive_scalar(seed: bytes, tag: bytes, ctr: int = 0) -> int:
    while True:
        h = hashlib.sha512(seed + b"|" + tag + b"|" + ctr.to_bytes(4, "big"))
        v = int.from_bytes(h.digest(), "big") % FR_MOD
        if v > 1:
            return v
        ctr += 1


def _toxic_scalars(r1cs, seed: bytes) -> dict:
    """The toxic waste from the seed and the per-table scalars."""
    alpha = _derive_scalar(seed, b"alpha")
    beta = _derive_scalar(seed, b"beta")
    gamma = _derive_scalar(seed, b"gamma")
    delta = _derive_scalar(seed, b"delta")
    ctr = 0
    while True:  # re-derive tau if it lands in the evaluation domain
        tau = _derive_scalar(seed, b"tau", ctr)
        try:
            a_t, b_t, c_t, m, z_tau = eval_at_tau(r1cs, tau)
            break
        except ValueError:
            ctr += 1

    npub = r1cs.n_public
    nv = r1cs.n_vars
    inv_delta = pow(delta, FR_MOD - 2, FR_MOD)
    inv_gamma = pow(gamma, FR_MOD - 2, FR_MOD)

    k_scalars = [(beta * a_t[i] + alpha * b_t[i] + c_t[i]) % FR_MOD
                 for i in range(nv)]
    ic_scalars = [k_scalars[i] * inv_gamma % FR_MOD for i in range(npub)]
    c_scalars = [k_scalars[i] * inv_delta % FR_MOD for i in range(npub, nv)]
    # h table: tau^j * Z(tau) / delta, j = 0..m-2
    h_scalars: List[int] = [z_tau * inv_delta % FR_MOD] * (m - 1)
    for j in range(1, m - 1):
        h_scalars[j] = h_scalars[j - 1] * tau % FR_MOD
    return {"alpha": alpha, "beta": beta, "gamma": gamma, "delta": delta,
            "m": m, "b_t": b_t,
            # one concatenated fixed-base pass for every G1 table
            "all_g1": a_t + b_t + c_scalars + h_scalars + ic_scalars}


def _key(r1cs, sc: dict, g1_packed, b2_g2) -> ProvingKey:
    """Cut the concatenated G1 tables and add the single points."""
    x, y, inf = g1_packed
    nv, npub, m = r1cs.n_vars, r1cs.n_public, sc["m"]
    cuts = {}
    start = 0
    for name, n in (("a", nv), ("b1", nv), ("c", nv - npub), ("h", m - 1),
                    ("ic", npub)):
        cuts[name] = (x[start:start + n], y[start:start + n],
                      inf[start:start + n])
        start += n

    g1m = lambda k: ref.g1_mul(ref.G1_GEN, k)
    g2m = lambda k: ref.g2_mul(ref.G2_GEN, k)
    icx, icy, icinf = cuts["ic"]
    ic = [None if i else (a, b) for a, b, i in
          zip(FQ.from_mont_host(icx), FQ.from_mont_host(icy), icinf[:, 0])]
    vk = VerifyingKey(alpha1=g1m(sc["alpha"]), beta2=g2m(sc["beta"]),
                      gamma2=g2m(sc["gamma"]), delta2=g2m(sc["delta"]), ic=ic)
    return ProvingKey(
        n_vars=nv, n_public=npub, domain_size=m,
        alpha1=g1m(sc["alpha"]), beta1=g1m(sc["beta"]),
        delta1=g1m(sc["delta"]), beta2=g2m(sc["beta"]),
        delta2=g2m(sc["delta"]),
        a_g1=cuts["a"], b1_g1=cuts["b1"], b2_g2=b2_g2, c_g1=cuts["c"],
        h_g1=cuts["h"], vk=vk, r1cs_digest=r1cs_digest(r1cs))


def setup(r1cs, seed: Optional[bytes] = None, device="cuda") -> ProvingKey:
    """R1CS -> ProvingKey (with embedded VerifyingKey); the fixed-base
    tables are computed on `device`."""
    if seed is None:
        seed = secrets.token_bytes(32)
    sc = _toxic_scalars(r1cs, seed)
    return _key(r1cs, sc, g1_points_from_scalars(sc["all_g1"], device=device),
                g2_points_from_scalars(sc["b_t"], device=device))


def setup_host(r1cs, seed: Optional[bytes] = None) -> ProvingKey:
    """The same key with the native engine's fixed-base tables (host)."""
    if not engine.available():
        raise RuntimeError("setup_host needs the native engine")
    if seed is None:
        seed = secrets.token_bytes(32)
    sc = _toxic_scalars(r1cs, seed)
    g1s, b_t = sc["all_g1"], sc["b_t"]
    return _key(r1cs, sc,
                engine.g1_fixed_base_mont(engine.ints_to_fr_bytes(g1s),
                                          len(g1s)),
                engine.g2_fixed_base_mont(engine.ints_to_fr_bytes(b_t),
                                          len(b_t)))
