"""Limb layout of field elements, host codec and carry helpers (torch).

Counterpart of zkrollup/fields/limbs.py. A 254-bit element is 16
little-endian limbs of 16 bits along the LAST axis. On the device the limbs
are held as int32 (n, 16) tensors, the reference's storage with a signed
dtype; the plain PyTorch code computes in int64, because torch's CPU uint32
has no add or shift, and int64 leaves room for lazy limb sums.
"""

from __future__ import annotations

import numpy as np
import torch

N_LIMBS = 16
LIMB_BITS = 16
MASK = 0xFFFF
DTYPE = torch.int32


# -- host codec (numpy, the reference's uint32 arrays) ------------------------

def int_to_limbs(x: int) -> np.ndarray:
    """Python int -> (16,) uint32 limb vector (little-endian 16-bit limbs)."""
    return np.array([(x >> (LIMB_BITS * i)) & MASK for i in range(N_LIMBS)],
                    dtype=np.uint32)


def ints_to_limbs(xs) -> np.ndarray:
    """Iterable of ints -> (n, 16) uint32 (values taken mod 2^256)."""
    xs = list(xs)
    mask = (1 << 256) - 1
    raw = b"".join((x & mask).to_bytes(32, "little") for x in xs)
    return np.frombuffer(raw, dtype="<u2").reshape(
        len(xs), N_LIMBS).astype(np.uint32)


def limbs_to_ints(a) -> list:
    """(..., 16) array or tensor of canonical or lazy limbs -> list of ints."""
    if isinstance(a, torch.Tensor):
        a = a.cpu().numpy()
    flat = np.asarray(a, dtype=np.int64).reshape(-1, N_LIMBS)
    if flat.size and flat.min() >= 0 and flat.max() <= MASK:
        raw = np.ascontiguousarray(flat.astype("<u2")).tobytes()
        return [int.from_bytes(raw[i * 32:(i + 1) * 32], "little")
                for i in range(flat.shape[0])]
    out = []
    for row in flat:
        v = 0
        for i in range(N_LIMBS - 1, -1, -1):
            v = (v << LIMB_BITS) + int(row[i])
        out.append(v)
    return out


def to_device(a: np.ndarray, device) -> torch.Tensor:
    """Host uint32/bool limb array -> int32 tensor on `device`."""
    return torch.from_numpy(np.ascontiguousarray(a).astype(np.int32)).to(device)


# -- carry / borrow ------------------------------------------------------------

def normalize(t: torch.Tensor):
    """Signed lazy int64 limbs -> (canonical limbs, signed carry out of the
    top limb), with value(t) = value(limbs) + carry * 2^(16 L). Carries move
    one limb per pass over the whole tensor; passes repeat until none is
    left (a few for random data, at most L + 1 for a long borrow chain)."""
    t = t.to(torch.int64).clone()
    carry = torch.zeros_like(t[..., 0])
    while True:
        c = t >> LIMB_BITS                 # floor division by 2^16
        if not bool(c.any()):
            return t, carry
        t &= MASK
        t[..., 1:] += c[..., :-1]
        carry += c[..., -1]


def propagate_carries(t: torch.Tensor) -> torch.Tensor:
    """Canonicalise lazy limbs (each >= 0); the carry out of the top limb
    is dropped (the caller sizes the limb count to the value)."""
    return normalize(t)[0]


def sub_with_borrow(a: torch.Tensor, b: torch.Tensor):
    """a - b over canonical limbs -> (difference limbs, borrow (..., 1))."""
    d, carry = normalize(a.to(torch.int64) - b.to(torch.int64))
    return d, (carry < 0).to(torch.int64)[..., None]


def is_zero(a: torch.Tensor) -> torch.Tensor:
    return torch.all(a == 0, dim=-1, keepdim=True)


def select(cond: torch.Tensor, a: torch.Tensor, b: torch.Tensor):
    """where(cond, a, b) limbwise; cond is (..., 1)."""
    return torch.where(cond != 0, a, b)
