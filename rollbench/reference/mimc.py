# Frozen copy of zkrollup_torch/ref/mimc.py (commit f14ca18), imports made
# local; the benchmark's reference uses it and later changes to the program
# do not reach it.
"""Pure-Python MiMCSponge and MiMC7 over BN254 Fr.

Parity targets (circomlib 0.0.20 JS semantics, as consumed by the reference):
  - mimcsponge.multiHash: the rollup's universal hash — tree nodes, leaves,
    tx serialization, EdDSA internals (simple-zk-rollups/operator/src/utils/crypto.ts:28-38,
    simple-zk-rollups/operator/src/utils/helpers.ts:75-82).
  - Round constants: iterated keccak256 from ASCII seed, first/last rounds
    zeroed — the same generator that emits the on-chain MiMCSponge bytecode
    (simple-zk-rollups/contracts/migrations/2_deploy_mimcsponge.js:9-24,
    seed "mimcsponge", 220 rounds).
  - mimc7: used only by the operator's ECDH stream cipher
    (simple-zk-rollups/operator/src/utils/crypto.ts:95-141); seed "mimc",
    91 rounds, exponent 7.
"""

from functools import lru_cache

from .keccak import keccak256
from .bn254 import R as P

N_ROUNDS_SPONGE = 220
N_ROUNDS_MIMC7 = 91


@lru_cache(maxsize=None)
def mimcsponge_constants(n_rounds: int = N_ROUNDS_SPONGE):
    """cts[0] = 0, cts[i] = keccak^(i+1)("mimcsponge") mod p, cts[-1] = 0."""
    cts = [0] * n_rounds
    c = keccak256(b"mimcsponge")
    for i in range(1, n_rounds):
        c = keccak256(c)
        cts[i] = int.from_bytes(c, "big") % P
    cts[0] = 0
    cts[n_rounds - 1] = 0
    return tuple(cts)


def mimcsponge_permute(x_l: int, x_r: int, k: int, n_rounds: int = N_ROUNDS_SPONGE):
    """The 220-round MiMC-Feistel permutation (xL, xR) -> (xL', xR')."""
    cts = mimcsponge_constants(n_rounds)
    x_l %= P
    x_r %= P
    k %= P
    for i in range(n_rounds):
        t = (x_l + k + cts[i]) % P
        t2 = t * t % P
        t5 = t2 * t2 % P * t % P
        if i < n_rounds - 1:
            x_l, x_r = (x_r + t5) % P, x_l
        else:
            x_r = (x_r + t5) % P
    return x_l, x_r


def multi_hash_py(values, key: int = 0, n_rounds: int = N_ROUNDS_SPONGE) -> int:
    """Sponge over a list of field elements; returns one output (R).

    Absorb: R += v; (R, C) = permute(R, C, key). Matches circomlib
    mimcsponge.multiHash with numOutputs=1. Pure-Python ground truth.
    """
    r, c = 0, 0
    for v in values:
        r = (r + v) % P
        r, c = mimcsponge_permute(r, c, key, n_rounds)
    return r


def multi_hash(values, key: int = 0, n_rounds: int = N_ROUNDS_SPONGE) -> int:
    """multi_hash_py (the frozen copy keeps no native dispatch)."""
    return multi_hash_py(values, key, n_rounds)


def hash_one(v: int) -> int:
    return multi_hash([v])


def hash_left_right(left: int, right: int) -> int:
    return multi_hash([left, right])


@lru_cache(maxsize=None)
def mimc7_constants(n_rounds: int = N_ROUNDS_MIMC7):
    """cts[0] = 0, cts[i] = keccak^(i+1)("mimc") mod p."""
    cts = [0] * n_rounds
    c = keccak256(b"mimc")
    for i in range(1, n_rounds):
        c = keccak256(c)
        cts[i] = int.from_bytes(c, "big") % P
    cts[0] = 0
    return tuple(cts)


def mimc7_hash(x: int, k: int, n_rounds: int = N_ROUNDS_MIMC7) -> int:
    cts = mimc7_constants(n_rounds)
    x %= P
    k %= P
    r = 0
    for i in range(n_rounds):
        t = (x + k) % P if i == 0 else (r + k + cts[i]) % P
        r = pow(t, 7, P)
    return (r + k) % P


def mimc7_multi_hash(values, key: int = 0) -> int:
    r = key % P
    for v in values:
        r = (r + v + mimc7_hash(v, r)) % P
    return r
