"""MiMC7-CTR stream cipher + ECDH envelope.

Parity target: simple-zk-rollups/operator/src/utils/crypto.ts:95-141 and its
tests (simple-zk-rollups/operator/__tests__/utils/__tests__/crypto.test.ts:22-64).

Semantics quirks preserved from the reference (snarkjs bigInt is arbitrary
precision and the reference never reduces the ciphertext):
  - iv = mimc7.multiHash(msg, key=0)  (field-reduced, circomlib 0.0.20)
  - keystream_i = mimc7.hash(priv, iv + i) — the hash reduces its inputs
    mod p internally, but `iv + i` is formed as a plain integer sum
  - ciphertext_i = msg_i + keystream_i as a PLAIN integer (no mod p);
    decrypt subtracts the identical keystream, so any integer message
    round-trips exactly, field element or not
  - ecdh_encrypt/ecdh_decrypt wrap the cipher with the shared key
    ecdh(priv, pub) = (formatPrivKeyForBabyJub(priv) * pub).x
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

from .mimc import mimc7_hash, mimc7_multi_hash
from .eddsa import ecdh


@dataclass
class EncryptedMessage:
    iv: int
    msg: List[int]


def encrypt(msg: Sequence[int], priv: int) -> EncryptedMessage:
    """crypto.ts:95-109 — MiMC7 in counter mode keyed by `priv`."""
    iv = mimc7_multi_hash(list(msg), 0)
    return EncryptedMessage(
        iv=iv, msg=[e + mimc7_hash(priv, iv + i) for i, e in enumerate(msg)])


def decrypt(enc: EncryptedMessage, priv: int) -> List[int]:
    """crypto.ts:111-122 — exact inverse of encrypt under the same key."""
    return [e - mimc7_hash(priv, enc.iv + i) for i, e in enumerate(enc.msg)]


def ecdh_encrypt(msg: Sequence[int], priv: int, pub) -> EncryptedMessage:
    """crypto.ts:124-131 — encrypt under the ECDH shared key."""
    return encrypt(msg, ecdh(priv, pub))


def ecdh_decrypt(enc: EncryptedMessage, priv: int, pub) -> List[int]:
    """crypto.ts:133-141 — decrypt under the ECDH shared key."""
    return decrypt(enc, ecdh(priv, pub))
