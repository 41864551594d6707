"""Batched Montgomery arithmetic over BN254 Fr and Fq (torch).

Counterpart of zkrollup/fields/mont.py: R = 2^256, values are (..., 16)
limb tensors in Montgomery form. Every op takes int32 or int64 limb
tensors on one device and returns int32. `mont_mul`, `mont_inv`, `add`
and `sub` go through the CUDA kernel wrappers in cuda_mont.py (their
plain PyTorch versions on CPU tensors), and so does neg, a product by -1.
The add and sub kernels take canonical operands (< p) only, as the
reference's carry chains do; their plain versions are broader.
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
        """(a + b) mod p of canonical limbs: on CUDA one add[fr|fq]
        launch with no read-back; on the CPU its plain version."""
        return cuda_mont.add(self, a, b)

    def sub(self, a, b):
        """(a - b) mod p of canonical limbs: on CUDA one sub[fr|fq]
        launch with no read-back; on the CPU its plain version."""
        return cuda_mont.sub(self, a, b)

    def neg(self, a):
        """(-a) mod p as one Montgomery product by -1 in Montgomery form,
        (p - a) R R^-1: canonical, 0 for 0, and on CUDA one mont_mul
        launch with no carry loop."""
        return self.mont_mul(a.to(L.DTYPE).contiguous(),
                             self._const("neg_one", L.int_to_limbs(
                                 self.p - self.r_mod_p), a.device))

    def mont_mul(self, a, b, idx=None):
        """Montgomery product a*b*2^-256 mod p (a*b[idx]*2^-256 with an
        int64 row index idx). a < 2^256 and b < p as canonical 16-bit
        limbs; the CUDA kernel takes same-shape operands, a single
        broadcast b, or b gathered by idx."""
        return cuda_mont.mont_mul(self, a, b, idx)

    def mont_pow_const(self, a, e: int, mul=None):
        """a^e (Montgomery domain) for a host exponent e, batched:
        square-and-multiply over e's bits, low to high, every product on
        `mul` (mont_mul, the kernel wrapper, by default: one launch a
        product on CUDA). The reference multiplies under a mask at every
        bit (zkrollup/fields/mont.py:159); skipping the zero bits gives the
        same canonical limbs."""
        mul = mul or self.mont_mul
        acc = None
        base = a
        for i in range(e.bit_length()):
            if (e >> i) & 1:
                acc = base if acc is None else mul(acc, base)
            if i + 1 < e.bit_length():
                base = mul(base, base)
        if acc is None:
            return self.one_mont(a.device).expand(a.shape).contiguous()
        return acc

    def mont_inv(self, a):
        """a^-1 (a^(p-2)), batched; 0 maps to 0. On CUDA one launch of the
        inv[fq] kernel (Fq only); on the CPU its plain version, Fermat over
        the plain product."""
        return cuda_mont.inv(self, a)

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
