"""The traffic's inputs, drawn from --seed: accounts, signed transfers,
withdraw keys and each proof's blinding (r, s).

One general generator for every mix: a traffic file (rollbench/traffic/
<mix>.json) gives the counts and ranges, and the seed draws the values.
Each stream of values has its own random.Random, seeded by the string
"<seed>/<stream>" (Python hashes a str seed with SHA-512, so any whole
number, however large, seeds the same way on every machine). The keys,
hashes and signatures come from the reference's frozen copies (signing
through bjj_mul, the same points faster), never from the program: the
benchmark makes the inputs and hands the same ones to the program and to
the reference.

Every value is a plain int or a dict of ints; the entries turn them into
the program's types.
"""

from __future__ import annotations

import random
from functools import lru_cache
from typing import Dict, List

from .reference import babyjubjub as bjj
from .reference import eddsa
from .reference.bn254 import R as FR
from .reference.mimc import hash_one, multi_hash


def stream(seed: int, name: str) -> random.Random:
    return random.Random(f"{seed}/{name}")


def draw(rng: random.Random, lo_hi) -> int:
    lo, hi = (int(v) for v in lo_hi)
    return rng.randint(lo, hi)


def bjj_mul(p, e: int):
    """e * p on BabyJubJub: the frozen copy's double-and-add (bjj.mul_py)
    in projective coordinates, one inversion at the end (the addition law
    is complete); the same affine point."""
    a, d = bjj.A, bjj.D
    rx, ry, rz = 0, 1, 1
    px, py, pz = p[0] % FR, p[1] % FR, 1

    def add(x1, y1, z1, x2, y2, z2):
        za = z1 * z2 % FR
        zb = za * za % FR
        c = x1 * x2 % FR
        dd = y1 * y2 % FR
        ee = d * c % FR * dd % FR
        f, g = (zb - ee) % FR, (zb + ee) % FR
        x3 = za * f % FR * (((x1 + y1) * (x2 + y2) - c - dd) % FR) % FR
        y3 = za * g % FR * ((dd - a * c) % FR) % FR
        return x3, y3, f * g % FR

    while e:
        if e & 1:
            rx, ry, rz = add(rx, ry, rz, px, py, pz)
        px, py, pz = add(px, py, pz, px, py, pz)
        e >>= 1
    zi = pow(rz, FR - 2, FR)
    return (rx * zi % FR, ry * zi % FR)


@lru_cache(maxsize=None)
def _secret(priv: int):
    """(the pruned secret scalar, its public point A, the hash's high half)
    of a private key, as eddsa.sign derives them."""
    h1 = eddsa._bigint_to_ascii_hex(hash_one(priv))
    s = eddsa._le_buff_to_int(eddsa._prune_buffer(h1[:32]))
    return s, bjj_mul(bjj.BASE8, s >> 3), h1


def sign_msg(priv: int, msg) -> eddsa.Signature:
    """eddsa.sign (the frozen copy's steps) with bjj_mul and the key's
    secret cached: the same signature."""
    s, a_pt, h1 = _secret(priv)
    msg_hash = multi_hash(list(msg))
    r_seed = int.from_bytes(h1[32:64] + eddsa._le_int_to_buff(msg_hash, 32),
                            "big")
    r = eddsa._le_buff_to_int(eddsa._bigint_to_ascii_hex(hash_one(r_seed))) \
        % bjj.SUB_ORDER
    r8 = bjj_mul(bjj.BASE8, r)
    hm = multi_hash([r8[0], r8[1], a_pt[0], a_pt[1], msg_hash])
    return eddsa.Signature(R8=r8, S=(r + hm * s) % bjj.SUB_ORDER)


def accounts(seed: int, n: int, deposit_wei) -> List[Dict]:
    """n accounts: private key, public key and the deposit that opens its
    leaf (leaf index = position)."""
    rng = stream(seed, "accounts")
    out = []
    for _ in range(n):
        priv = rng.randrange(2, FR)
        pub = _secret(priv)[1]
        out.append({"priv": priv, "pub": (pub[0] % FR, pub[1] % FR),
                    "deposit": int(deposit_wei)})
    return out


def sign(acct: Dict, frm: int, to: int, amount: int, fee: int,
         nonce: int) -> Dict:
    sig = sign_msg(acct["priv"], [frm, to, amount, fee, nonce])
    return {"from": frm, "to": to, "amount": amount, "fee": fee,
            "nonce": nonce, "R8": tuple(sig.R8), "S": sig.S}


def transfer_values(rng: random.Random, mix: Dict, min_fee) -> tuple:
    amount = draw(rng, mix["amount_wei"])
    fee = min_fee(amount) + draw(rng, mix["extra_fee_wei"])
    return amount, fee


def transfers(seed: int, accts: List[Dict], n: int, mix: Dict,
              min_fee) -> List[Dict]:
    """n signed transfers in queue order: senders and recipients drawn
    among accts (never a self-send), each sender's nonces counting up from
    1, amounts from mix["amount_wei"], fees at the minimum fee rule plus
    mix["extra_fee_wei"]. Deposits large enough that no sender runs dry."""
    rng = stream(seed, "transfers")
    nonce = [0] * len(accts)
    out = []
    for _ in range(n):
        frm, to = rng.sample(range(len(accts)), 2)
        amount, fee = transfer_values(rng, mix, min_fee)
        nonce[frm] += 1
        out.append(sign(accts[frm], frm, to, amount, fee, nonce[frm]))
    return out


def batch_pool(seed: int, accts: List[Dict], pool: int, batch_size: int,
               mix: Dict, min_fee) -> List[List[Dict]]:
    """`pool` batches, each valid on the freshly deposited state alone:
    batch_size transfers from distinct senders, each at nonce 1."""
    rng = stream(seed, "pool")
    out = []
    for _ in range(pool):
        senders = rng.sample(range(len(accts)), batch_size)
        batch = []
        for frm in senders:
            to = rng.choice([i for i in range(len(accts)) if i != frm])
            amount, fee = transfer_values(rng, mix, min_fee)
            batch.append(sign(accts[frm], frm, to, amount, fee, 1))
        out.append(batch)
    return out


def withdraw_keys(seed: int, pool: int) -> List[int]:
    """`pool` formatted BabyJubJub private keys (the withdraw circuit's
    private input)."""
    rng = stream(seed, "withdraw_keys")
    return [eddsa.format_priv_key_for_babyjub(rng.randrange(2, FR))
            for _ in range(pool)]


def blinding(seed: int):
    """An endless stream of (r, s), one pair a proof."""
    rng = stream(seed, "blinding")
    while True:
        yield rng.randrange(1, FR), rng.randrange(1, FR)


def nullifiers(seed: int):
    """An endless stream of fresh withdraw nullifiers."""
    rng = stream(seed, "nullifiers")
    while True:
        yield rng.randrange(1, FR)
