"""Batched short-Weierstrass (y^2 = x^3 + b) Jacobian points, generic over
the coordinate field (Fq for G1, Fq2 for G2).

Counterpart of zkrollup/curve/weierstrass.py. A point is (X, Y, Z) of
field elements, Z == 0 encodes infinity. `add`, `add_nd`, `add_z01`,
`double` and `madd_z01` go through the CUDA kernel wrappers in
cuda_curve.py, which run the plain PyTorch formulas on CPU tensors. The
field ops `mul` and `sqr` below serve those plain formulas: their product
is the plain PyTorch Montgomery multiply on every device, so a plain point
op launches no product kernel (its adds and subs are FieldCtx.add / sub:
the add and sub kernels on CUDA tensors). `kmul` takes the mont_mul
kernel wrapper instead, and `inv` the inversion kernel's (inv[fq],
inv[fq2]); they serve the batched inversion (`batch_inverse`,
`batch_inverse_tree`).
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

    # on the mont_mul and inv[fq] kernels (their plain versions on CPU
    # tensors)
    kmul = staticmethod(FQ.mont_mul)
    inv = staticmethod(FQ.mont_inv)

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

    # on the mont_mul and inv[fq2] kernels (their plain versions on CPU
    # tensors)
    kmul = staticmethod(fq2.mul)
    inv = staticmethod(fq2.inv)

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


def _fmap(F, fn, *xs):
    """Apply fn leafwise over field elements of F."""
    return F.from_leaves([fn(*ls) for ls in zip(*(F.leaves(x) for x in xs))])


def batch_inverse(F, d):
    """Batched field inversion (weierstrass.py:batch_inverse). d: a batch
    (m, 16) of nonzero field elements (callers set zero lanes to one). On
    CUDA one launch of the inversion kernel over the m lanes (F.inv:
    inv[fq] or inv[fq2], Montgomery's trick inside each thread, no padding);
    on the CPU its plain version, batch_inverse_tree. The inverse is unique,
    so the two give the same canonical limbs."""
    if F.leaves(d)[0].device.type == "cpu":
        return batch_inverse_tree(F, d)
    return F.inv(_fmap(F, lambda a: a.contiguous(), d))


def batch_inverse_tree(F, d):
    """batch_inverse with ONE inversion at the root of a log-depth product
    tree, m - 1 products up and 2(m - 1) down, Montgomery's trick made
    parallel (the reference's shape); a length that is not a power of two
    is padded with ones. Every product is F.kmul over a level, the root's
    inversion F.inv."""
    m = F.leaves(d)[0].shape[0]
    dev = F.leaves(d)[0].device
    m_pad = 1 << max((m - 1).bit_length(), 0)
    if m_pad != m:
        d = _fmap(F, lambda a, o: torch.cat([a, o]), d,
                  F.one((m_pad - m,), dev))
    levels = []
    cur = d
    while F.leaves(cur)[0].shape[0] > 1:
        levels.append(cur)
        cur = F.kmul(_fmap(F, lambda a: a[0::2].contiguous(), cur),
                     _fmap(F, lambda a: a[1::2].contiguous(), cur))
    inv = F.inv(_fmap(F, lambda a: a.contiguous(), cur))
    for lvl in reversed(levels):
        half = F.leaves(lvl)[0].shape[0] // 2
        # inv is the inverse of each pair's product: 1/l = inv r, 1/r = inv l
        left = _fmap(F, lambda a: a[0::2].contiguous(), lvl)
        right = _fmap(F, lambda a: a[1::2].contiguous(), lvl)
        inv_l = F.kmul(inv, right)
        inv_r = F.kmul(inv, left)
        inv = _fmap(F, lambda l, r: torch.stack([l, r], dim=1).reshape(
            2 * half, L.N_LIMBS), inv_l, inv_r)
    if m_pad != m:
        inv = _fmap(F, lambda a: a[:m].contiguous(), inv)
    return inv


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

    def horner(self, wsum, c: int):
        """The MSM's Horner combine of window sums (leaves (W, 16)), from
        the top window down, res = 2^c res + W_w: one g1_horner /
        g2_horner launch. Returns one point with (16,) leaves."""
        return cuda_curve.horner(self, wsum, c)

    def add_nd(self, p, q):
        """Jacobian add for p and q that are never the same point (the
        g1_add_nd / g2_add_nd kernel, weierstrass.py:add_nd): no doubling
        path; infinity on either side and p == -q stay exact."""
        return cuda_curve.add_nd(self, p, q)

    def add_z01(self, p, q):
        """Unified add for p and q with Z in {0, 1} exactly (affine or
        infinity): the g1_add_z01 / g2_add_z01 kernel, ~1.9x fewer
        products than `add`."""
        return cuda_curve.add_z01(self, p, q)

    def madd_z01(self, p, q, distinct: bool = False):
        """p Jacobian + q with Z in {0, 1} exactly (affine or infinity):
        the g1_madd / g2_madd kernel, correct for every pair. distinct=True
        drops the doubling path (g1_madd_nd / g2_madd_nd kernel): p and q
        must never be the same point."""
        if distinct:
            return cuda_curve.madd_nd(self, p, q)
        return cuda_curve.madd(self, p, q)
