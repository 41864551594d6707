"""Groth16 trusted setup (host).

Counterpart of zkrollup/groth16/setup.py: the same scalar derivation from
the seed, so the same seed and R1CS give the same key bytes. Fixed-base
tables come from the native engine (engine.g1_fixed_base_mont /
g2_fixed_base_mont), the path zkrollup/msm/fixed_base.py prefers whenever
the engine is built; setup on the GPU is later work. Key setup is one-time
host work.
"""

from __future__ import annotations

import hashlib
import secrets
from typing import List, Optional

from zkrollup.native import engine
from zkrollup.ref import bn254 as ref
from zkrollup.ref.bn254 import R as FR_MOD
from ..fields.mont import FQ
from .keys import ProvingKey, VerifyingKey, r1cs_digest
from .qap import eval_at_tau


def _derive_scalar(seed: bytes, tag: bytes, ctr: int = 0) -> int:
    while True:
        h = hashlib.sha512(seed + b"|" + tag + b"|" + ctr.to_bytes(4, "big"))
        v = int.from_bytes(h.digest(), "big") % FR_MOD
        if v > 1:
            return v
        ctr += 1


def setup(r1cs, seed: Optional[bytes] = None) -> ProvingKey:
    """R1CS -> ProvingKey (with embedded VerifyingKey)."""
    if not engine.available():
        raise RuntimeError("setup needs the native engine (make -C native)")
    if seed is None:
        seed = secrets.token_bytes(32)

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

    # one concatenated fixed-base pass for every G1 table
    all_g1 = a_t + b_t + c_scalars + h_scalars + ic_scalars
    x, y, inf = engine.g1_fixed_base_mont(engine.ints_to_fr_bytes(all_g1),
                                          len(all_g1))
    cuts = {}
    start = 0
    for name, n in (("a", nv), ("b1", nv), ("c", nv - npub), ("h", m - 1),
                    ("ic", npub)):
        cuts[name] = (x[start:start + n], y[start:start + n],
                      inf[start:start + n])
        start += n
    b2_g2 = engine.g2_fixed_base_mont(engine.ints_to_fr_bytes(b_t), len(b_t))

    g1m = lambda k: ref.g1_mul(ref.G1_GEN, k)
    g2m = lambda k: ref.g2_mul(ref.G2_GEN, k)
    icx, icy, icinf = cuts["ic"]
    ic = [None if i else (a, b) for a, b, i in
          zip(FQ.from_mont_host(icx), FQ.from_mont_host(icy), icinf[:, 0])]
    vk = VerifyingKey(alpha1=g1m(alpha), beta2=g2m(beta), gamma2=g2m(gamma),
                      delta2=g2m(delta), ic=ic)
    return ProvingKey(
        n_vars=nv, n_public=npub, domain_size=m,
        alpha1=g1m(alpha), beta1=g1m(beta), delta1=g1m(delta),
        beta2=g2m(beta), delta2=g2m(delta),
        a_g1=cuts["a"], b1_g1=cuts["b1"], b2_g2=b2_g2, c_g1=cuts["c"],
        h_g1=cuts["h"], vk=vk, r1cs_digest=r1cs_digest(r1cs))
