"""The reference rollup's EdDSA variant (MiMCSponge everywhere) + key derivation.

This mirrors simple-zk-rollups/operator/src/utils/crypto.ts exactly, including
its quirky byte handling:
  - `bigInt2Buffer(i)` is the ASCII bytes of `i.toString(16)` (lowercase hex,
    no padding, no 0x) — NOT the binary big-endian encoding (crypto.ts:20-22).
  - key pruning (RFC-8032 style) operates on those ASCII bytes, then the
    scalar is `leBuff2int(pruned) >> 3` (crypto.ts:58-76, 143-150).
  - nonce r = leBuff2int(ascii-hex of MiMC hash) mod subOrder (crypto.ts:154-159).

All hashing is MiMCSponge multiHash — the reference never uses blake here.
"""

from __future__ import annotations

import secrets
from dataclasses import dataclass

from . import babyjubjub as bjj
from .bn254 import R as FR
from .mimc import multi_hash, hash_one


def _bigint_to_ascii_hex(i: int) -> bytes:
    """JS `Buffer.from(i.toString(16))` — ASCII bytes of the bare hex string."""
    return format(i, "x").encode("ascii")


def _le_buff_to_int(b: bytes) -> int:
    return int.from_bytes(b, "little")


def _le_int_to_buff(i: int, length: int) -> bytes:
    return i.to_bytes(length, "little")


def _prune_buffer(b: bytes) -> bytes:
    """circomlib eddsa.pruneBuffer on a copy; JS out-of-range writes are no-ops."""
    buf = bytearray(b)
    if len(buf) > 0:
        buf[0] &= 0xF8
    if len(buf) > 31:
        buf[31] &= 0x7F
        buf[31] |= 0x40
    return bytes(buf)


def gen_private_key() -> int:
    """Uniform private key in [0, r).

    Deviation from crypto.ts:40-56 (noted): the reference's rejection loop is
    biased (it accepts only 256-bit samples below (2^256 - r) mod r); we use
    unbiased rejection sampling instead. Any integer < r is a valid key.
    """
    while True:
        k = secrets.randbits(256)
        if k < FR:
            return k


def format_priv_key_for_babyjub(priv_key: int) -> int:
    """crypto.ts:58-76 — hash, ASCII-hex, prune, little-endian, >> 3."""
    s_buff = _prune_buffer(_bigint_to_ascii_hex(hash_one(priv_key))[:32])
    return _le_buff_to_int(s_buff) >> 3


def gen_public_key(priv_key: int):
    assert priv_key < FR
    pub = bjj.mul(bjj.BASE8, format_priv_key_for_babyjub(priv_key))
    return (pub[0] % FR, pub[1] % FR)


def ecdh(priv: int, pub) -> int:
    s = format_priv_key_for_babyjub(priv)
    return bjj.mul(tuple(pub), s)[0]


@dataclass
class Signature:
    R8: tuple  # (x, y)
    S: int


def sign(priv: int, msg) -> Signature:
    """crypto.ts:143-168. `msg` is a list of field elements (formatTx output)."""
    msg_hash = multi_hash(list(msg))

    h1 = _bigint_to_ascii_hex(hash_one(priv))
    s_buff = _prune_buffer(h1[:32])
    s = _le_buff_to_int(s_buff)
    a_pt = bjj.mul(bjj.BASE8, s >> 3)

    msg_buff = _le_int_to_buff(msg_hash, 32)
    r_seed = int.from_bytes(h1[32:64] + msg_buff, "big")  # buffer2BigInt(concat)
    r_buff = _bigint_to_ascii_hex(hash_one(r_seed))
    r = _le_buff_to_int(r_buff) % bjj.SUB_ORDER

    r8 = bjj.mul(bjj.BASE8, r)
    hm = multi_hash([r8[0], r8[1], a_pt[0], a_pt[1], msg_hash])
    # pruning zeroes the low 3 bits of s, so hm*s == 8*hm*(s>>3): the verify
    # equation S*B8 == R8 + 8*hm*A holds (crypto.ts:162)
    s_sig = (r + hm * s) % bjj.SUB_ORDER
    return Signature(R8=r8, S=s_sig)


def verify(msg, sig: Signature, pub_key) -> bool:
    """circomlib eddsa.verifyMiMCSponge semantics (crypto.ts:170-177):
    S*B8 == R8 + 8*hm*A."""
    r8 = tuple(sig.R8)
    a_pt = tuple(pub_key)
    if not bjj.is_on_curve(r8) or not bjj.is_on_curve(a_pt):
        return False
    if sig.S >= bjj.SUB_ORDER:
        return False
    msg_hash = multi_hash(list(msg))
    hm = multi_hash([r8[0], r8[1], a_pt[0], a_pt[1], msg_hash])
    left = bjj.mul(bjj.BASE8, sig.S)
    right = bjj.add(r8, bjj.mul(a_pt, hm * 8))
    return left == right
