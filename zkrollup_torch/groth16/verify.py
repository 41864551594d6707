"""Groth16 verification (host pairing).

Counterpart of zkrollup/groth16/verify.py, with its verdicts. Where the
native engine is built, vk_x = IC_0 + sum s_i IC_{i+1} is one Pippenger
multi-scalar product (engine.g1_msm_pip, its window from the input count)
over the raw-Montgomery planes of the key's IC table, packed once a key,
and the four pairs go to engine.pairing_check; otherwise the pure-Python
ref fold and pairing. The spans groth16.verify.fold and
groth16.verify.pairing time the two parts. This is host code; nothing
here runs on the GPU.
"""

from __future__ import annotations

import threading
from typing import Sequence

from ..native import engine
from ..ref import bn254 as ref
from ..ref.bn254 import Q, R as FR_MOD
from ..spans import span
from .keys import Proof, VerifyingKey

# the folds verify() made and the public inputs they folded, by route: the
# engine's Pippenger ("native") or, without the engine, the ref's
# double-and-adds ("python"); summed over this process's calls;
# reset_folds() zeroes them
FOLDS = {"native": 0, "native_inputs": 0, "python": 0, "python_inputs": 0}
_folds_lock = threading.Lock()


def reset_folds() -> None:
    with _folds_lock:
        for k in FOLDS:
            FOLDS[k] = 0


def _count_fold(route: str, n: int) -> None:
    with _folds_lock:
        FOLDS[route] += 1
        FOLDS[route + "_inputs"] += n


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


def _proof_valid(proof: Proof) -> bool:
    """A, B and C in range, on their curves and not at infinity."""
    return (_g1_valid(proof.a) and _g1_valid(proof.c) and _g2_valid(proof.b)
            and proof.a is not None and proof.b is not None
            and proof.c is not None)


def ic_planes(vk: VerifyingKey) -> tuple:
    """The raw-Montgomery planes of vk.ic[1:] that engine.g1_msm_pip reads,
    kept on the key (outside its dataclass fields, so out of its eq, repr
    and npz) and packed again when vk.ic is another list than the one they
    came from. Raises ValueError where a coordinate of vk.ic lies outside
    [0, q), which engine.groth16_verify rejects too."""
    cached = vk.__dict__.get("_ic_planes")
    if cached is None or cached[0] is not vk.ic:
        if not all(p is None or (0 <= p[0] < Q and 0 <= p[1] < Q)
                   for p in vk.ic):
            raise ValueError("IC coordinate outside [0, q)")
        cached = (vk.ic, engine.pack_g1_points_mont(vk.ic[1:]))
        vk.__dict__["_ic_planes"] = cached
    return cached[1]


def fold(vk: VerifyingKey, public_signals: Sequence[int]):
    """vk_x = IC_0 + sum s_i IC_{i+1} on the engine: one Pippenger over
    ic_planes(vk), each s_i taken as (s_i mod 2^256) mod r, as
    engine.groth16_verify takes its inputs. None at infinity."""
    n = len(public_signals)
    planes = ic_planes(vk)
    scalars = b"".join((s % (1 << 256) % FR_MOD).to_bytes(32, "little")
                       for s in public_signals)
    vk_x = engine.g1_add(vk.ic[0], engine.g1_msm_pip(planes, scalars, n))
    _count_fold("native", n)
    return vk_x


def _pairs(vk: VerifyingKey, proof: Proof, vk_x) -> list:
    return [(ref.g1_neg(proof.a), proof.b), (vk.alpha1, vk.beta2),
            (vk_x, vk.gamma2), (proof.c, vk.delta2)]


def verify(vk: VerifyingKey, proof: Proof, public_signals: Sequence[int]
           ) -> bool:
    """e(-A, B) * e(alpha, beta) * e(vk_x, gamma) * e(C, delta) == 1."""
    if len(public_signals) != len(vk.ic) - 1:
        return False
    if not engine.available():
        return _verify_py(vk, proof, public_signals)
    if not _proof_valid(proof):
        return False
    try:
        with span("groth16.verify.fold"):
            vk_x = fold(vk, public_signals)
        with span("groth16.verify.pairing"):
            return engine.pairing_check(_pairs(vk, proof, vk_x))
    except ValueError:          # a key point out of range or off its curve
        return False


def _verify_py(vk: VerifyingKey, proof: Proof,
               public_signals: Sequence[int]) -> bool:
    if not _proof_valid(proof):
        return False
    with span("groth16.verify.fold"):
        vk_x = vk.ic[0]
        for s, pt in zip(public_signals, vk.ic[1:]):
            vk_x = ref.g1_add(vk_x, ref.g1_mul(pt, s % FR_MOD))
    _count_fold("python", len(public_signals))
    with span("groth16.verify.pairing"):
        return ref.pairing_check(_pairs(vk, proof, vk_x))
