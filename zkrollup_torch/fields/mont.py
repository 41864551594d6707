"""Batched Montgomery arithmetic over BN254 Fr and Fq (torch).

Counterpart of zkrollup/fields/mont.py: R = 2^256, values are (..., 16)
limb tensors in Montgomery form. Every op takes int32 or int64 limb
tensors on one device and returns int32. `mont_mul` goes through the CUDA
kernel wrapper in cuda_mont.py (its plain PyTorch version on CPU tensors);
add, sub and neg are plain tensor code on every device.
"""

from __future__ import annotations

import numpy as np
import torch

from . import cuda_mont, limbs as L
from .limbs import N_LIMBS, LIMB_BITS

R_BITS = N_LIMBS * LIMB_BITS  # 256


class FieldCtx:
    """Per-field constants and batched field ops (Montgomery domain)."""

    def __init__(self, modulus: int, name: str):
        self.p = modulus
        self.name = name
        self.r = 1 << R_BITS
        self.r_mod_p = self.r % modulus
        self.r2 = (self.r * self.r) % modulus
        self.n0inv = (-pow(modulus, -1, 1 << LIMB_BITS)) & 0xFFFF
        self.mod_np = L.int_to_limbs(modulus)
        self.r2_np = L.int_to_limbs(self.r2)
        self.one_mont_np = L.int_to_limbs(self.r_mod_p)
        self._consts = {}

    def __repr__(self):
        return f"FieldCtx({self.name})"

    # -- constants on a device -----------------------------------------------

    def _const(self, name: str, arr: np.ndarray, device) -> torch.Tensor:
        key = (name, str(torch.device(device)))
        t = self._consts.get(key)
        if t is None:
            t = L.to_device(arr, device)
            self._consts[key] = t
        return t

    def mod_limbs(self, device) -> torch.Tensor:
        return self._const("mod", self.mod_np, device)

    def r2_limbs(self, device) -> torch.Tensor:
        return self._const("r2", self.r2_np, device)

    def one_mont(self, device) -> torch.Tensor:
        return self._const("one", self.one_mont_np, device)

    def const_mont(self, x: int, device) -> torch.Tensor:
        """Host int -> (16,) Montgomery-form constant on `device`."""
        return L.to_device(L.int_to_limbs(x % self.p * self.r % self.p),
                           device)

    # -- host encode/decode --------------------------------------------------

    def to_mont_host(self, xs) -> np.ndarray:
        """list[int] -> (n, 16) Montgomery-form limbs, computed on host."""
        return L.ints_to_limbs([(x % self.p) * self.r % self.p for x in xs])

    def from_mont_host(self, a) -> list:
        rinv = pow(self.r, -1, self.p)
        return [v * rinv % self.p for v in L.limbs_to_ints(a)]

    # -- batched ops ---------------------------------------------------------

    def add(self, a, b):
        """(a + b) mod p: normalise a + b and a + b - p together and keep
        the difference unless it borrowed."""
        s = a.to(torch.int64) + b.to(torch.int64)
        both, carry = L.normalize(
            torch.stack([s, s - self.mod_limbs(s.device)]))
        return L.select((carry[1] < 0)[..., None], both[0],
                        both[1]).to(L.DTYPE)

    def sub(self, a, b):
        """(a - b) mod p: normalise a - b and a - b + p together and keep
        the sum where the difference borrowed."""
        d = a.to(torch.int64) - b.to(torch.int64)
        both, carry = L.normalize(
            torch.stack([d, d + self.mod_limbs(d.device)]))
        return L.select((carry[0] < 0)[..., None], both[1],
                        both[0]).to(L.DTYPE)

    def neg(self, a):
        d, _ = L.sub_with_borrow(self.mod_limbs(a.device), a)
        return L.select(L.is_zero(a), a.to(torch.int64), d).to(L.DTYPE)

    def mont_mul(self, a, b):
        """Montgomery product a*b*2^-256 mod p. a < 2^256 and b < p as
        canonical 16-bit limbs; the CUDA kernel takes same-shape operands
        or a single broadcast b."""
        return cuda_mont.mont_mul(self, a, b)

    def mont_pow_const(self, a, e: int):
        """a^e (Montgomery domain) for a host exponent e, batched:
        square-and-multiply over e's bits, low to high, every product on
        mont_mul. The reference multiplies under a mask at every bit
        (zkrollup/fields/mont.py:159); skipping the zero bits gives the
        same canonical limbs."""
        acc = None
        base = a
        for i in range(e.bit_length()):
            if (e >> i) & 1:
                acc = base if acc is None else self.mont_mul(acc, base)
            if i + 1 < e.bit_length():
                base = self.mont_mul(base, base)
        if acc is None:
            return self.one_mont(a.device).expand(a.shape).contiguous()
        return acc

    def mont_inv(self, a):
        """a^-1 via Fermat (a^(p-2)), batched; 0 maps to 0."""
        return self.mont_pow_const(a, self.p - 2)

    def to_mont(self, a):
        return self.mont_mul(a, self.r2_limbs(a.device))

    def from_mont(self, a):
        return self.mont_mul(a, self._const("unit", L.int_to_limbs(1),
                                            a.device))


# BN254 scalar field (circuit field)
FR = FieldCtx(
    21888242871839275222246405745257275088548364400416034343698204186575808495617,
    "fr")
# BN254 base field (G1 coordinates)
FQ = FieldCtx(
    21888242871839275222246405745257275088696311157297823662689037894645226208583,
    "fq")
