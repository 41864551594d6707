"""Groth16 verification (host pairing).

Counterpart of zkrollup/groth16/verify.py: the native engine's pairing
check when it is built, the pure-Python ref pairing otherwise.
This is host code; nothing here runs on the GPU.
"""

from __future__ import annotations

from typing import Sequence

from ..native import engine
from ..ref import bn254 as ref
from ..ref.bn254 import Q, R as FR_MOD
from .keys import Proof, VerifyingKey


def _g1_valid(p) -> bool:
    if p is None:
        return True
    x, y = p
    return 0 <= x < Q and 0 <= y < Q and ref.g1_is_on_curve(p)


def _g2_valid(p) -> bool:
    if p is None:
        return True
    (x0, x1), (y0, y1) = p
    if not all(0 <= v < Q for v in (x0, x1, y0, y1)):
        return False
    return ref.g2_is_on_curve(p)


def verify(vk: VerifyingKey, proof: Proof, public_signals: Sequence[int]
           ) -> bool:
    """e(-A, B) * e(alpha, beta) * e(vk_x, gamma) * e(C, delta) == 1."""
    if len(public_signals) != len(vk.ic) - 1:
        return False
    if engine.available():
        return engine.groth16_verify(vk, proof, public_signals) == 1
    return _verify_py(vk, proof, public_signals)


def _verify_py(vk: VerifyingKey, proof: Proof,
               public_signals: Sequence[int]) -> bool:
    if not (_g1_valid(proof.a) and _g1_valid(proof.c)
            and _g2_valid(proof.b)):
        return False
    if proof.a is None or proof.b is None or proof.c is None:
        return False
    vk_x = vk.ic[0]
    for s, pt in zip(public_signals, vk.ic[1:]):
        vk_x = ref.g1_add(vk_x, ref.g1_mul(pt, s % FR_MOD))
    return ref.pairing_check([
        (ref.g1_neg(proof.a), proof.b),
        (vk.alpha1, vk.beta2),
        (vk_x, vk.gamma2),
        (proof.c, vk.delta2),
    ])
