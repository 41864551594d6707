"""Batched short-Weierstrass (y^2 = x^3 + b) Jacobian points, generic over
the coordinate field (Fq for G1, Fq2 for G2).

Counterpart of zkrollup/curve/weierstrass.py. A point is (X, Y, Z) of
field elements, Z == 0 encodes infinity. `add`, `double` and `madd_z01` go
through the CUDA kernel wrappers in cuda_curve.py, which run the plain
PyTorch formulas on CPU tensors. The field ops below serve those plain
formulas and `mixed_add` only: their product is the plain PyTorch
Montgomery multiply on every device, so a plain point op launches no
kernel.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from ..fields.mont import FQ
from ..fields import limbs as L
from ..fields import fq2
from ..fields.cuda_mont import mont_mul_plain
from . import cuda_curve


def _fq_mul(a, b):
    return mont_mul_plain(FQ, a, b)


class FqOps:
    """Plain-Fq limb tensors behind the interface fq2 exposes."""
    add = staticmethod(FQ.add)
    sub = staticmethod(FQ.sub)
    neg = staticmethod(FQ.neg)
    mul = staticmethod(_fq_mul)
    is_zero = staticmethod(L.is_zero)
    select = staticmethod(L.select)

    @staticmethod
    def sqr(a):
        return _fq_mul(a, a)

    @staticmethod
    def zeros(batch, device):
        return torch.zeros(tuple(batch) + (L.N_LIMBS,), dtype=L.DTYPE,
                           device=device)

    @staticmethod
    def one(batch, device):
        return FQ.one_mont(device).expand(tuple(batch) + (L.N_LIMBS,))

    @staticmethod
    def leaves(a):
        return [a]

    @staticmethod
    def from_leaves(ls):
        return ls[0]


class Fq2Ops:
    add = staticmethod(fq2.add)
    sub = staticmethod(fq2.sub)
    neg = staticmethod(fq2.neg)
    is_zero = staticmethod(fq2.is_zero)
    select = staticmethod(fq2.select)

    @staticmethod
    def mul(a, b):
        return fq2.mul(a, b, _fq_mul)

    @staticmethod
    def sqr(a):
        return fq2.sqr(a, _fq_mul)

    @staticmethod
    def zeros(batch, device):
        z = FqOps.zeros(batch, device)
        return (z, z)

    @staticmethod
    def one(batch, device):
        return (FqOps.one(batch, device), FqOps.zeros(batch, device))

    @staticmethod
    def leaves(a):
        return [a[0], a[1]]

    @staticmethod
    def from_leaves(ls):
        return (ls[0], ls[1])


@dataclass
class JacobianCurve:
    F: Any       # FqOps or Fq2Ops
    name: str    # "g1" or "g2": selects the kernel instantiations

    def infinity(self, batch_shape, device):
        z = self.F.zeros(batch_shape, device)
        return (z, z, z)

    def is_infinity(self, p):
        return self.F.is_zero(p[2])

    def select(self, cond, p, q):
        return tuple(self.F.select(cond, a, b) for a, b in zip(p, q))

    def neg(self, p):
        return (p[0], self.F.neg(p[1]), p[2])

    def leaves(self, p):
        """Point -> list of (..., 16) limb tensors (3 for G1, 6 for G2)."""
        return [leaf for c in p for leaf in self.F.leaves(c)]

    def from_leaves(self, ls):
        k = len(ls) // 3
        return tuple(self.F.from_leaves(ls[i * k:(i + 1) * k])
                     for i in range(3))

    def map(self, fn, *ps):
        """Apply fn leafwise over points of the same structure."""
        return self.from_leaves(
            [fn(*xs) for xs in zip(*(self.leaves(p) for p in ps))])

    def double(self, p):
        """dbl-2007-bl for a = 0 (g1_double / g2_double kernel); infinity
        stays Z = 0."""
        return cuda_curve.double(self, p)

    def add(self, p, q):
        """Unified complete addition (g1_add / g2_add kernel)."""
        return cuda_curve.add(self, p, q)

    def madd_z01(self, p, q, distinct: bool = False):
        """p Jacobian + q with Z in {0, 1} exactly (affine or infinity):
        the g1_madd / g2_madd kernel, correct for every pair. distinct=True
        drops the doubling path (g1_madd_nd / g2_madd_nd kernel): p and q
        must never be the same point."""
        if distinct:
            return cuda_curve.madd_nd(self, p, q)
        return cuda_curve.madd(self, p, q)

    def mixed_add(self, p, q_affine):
        """p (Jacobian) + q (affine (x, y) with a (..., 1) infinity mask):
        the generic shape of zkrollup/curve/weierstrass.py:mixed_add, whose
        doubling branch doubles p. Same affine result as madd_z01, other
        Jacobian limbs on P == Q; kept for comparisons on the CPU."""
        F = self.F
        x2, y2, q_inf = q_affine
        added, H, R = cuda_curve.madd_add_path(F, p, q_affine)
        h_zero, r_zero = F.is_zero(H), F.is_zero(R)
        p_inf = self.is_infinity(p)
        out = self.select(h_zero & r_zero, self.double(p), added)
        bshape = self.leaves(out)[0].shape[:-1]
        dev = self.leaves(out)[0].device
        out = self.select(h_zero & ~r_zero & ~p_inf,
                          self.infinity(bshape, dev), out)
        out = self.select(p_inf, (x2, y2, F.one(bshape, dev)), out)
        return self.select(q_inf, p, out)
