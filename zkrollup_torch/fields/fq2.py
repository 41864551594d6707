"""Batched Fq2 = Fq[u]/(u^2+1) arithmetic on limb tensors (for BN254 G2).

Counterpart of zkrollup/fields/fq2.py: an element is a pair (c0, c1) of
(..., 16) Montgomery-form Fq limb tensors. Multiplication is Karatsuba in
3 Montgomery products, squaring takes 2.
"""

from __future__ import annotations

import torch

from .mont import FQ
from . import limbs as L


def add(a, b):
    return (FQ.add(a[0], b[0]), FQ.add(a[1], b[1]))


def sub(a, b):
    return (FQ.sub(a[0], b[0]), FQ.sub(a[1], b[1]))


def neg(a):
    return (FQ.neg(a[0]), FQ.neg(a[1]))


def mul(a, b, mont_mul=FQ.mont_mul):
    """(a0 + a1 u)(b0 + b1 u), u^2 = -1; Karatsuba. `mont_mul` is the Fq
    product to use (the kernel wrapper by default)."""
    t0 = mont_mul(a[0], b[0])
    t1 = mont_mul(a[1], b[1])
    t01 = mont_mul(FQ.add(a[0], a[1]), FQ.add(b[0], b[1]))
    return (FQ.sub(t0, t1), FQ.sub(FQ.sub(t01, t0), t1))


def sqr(a, mont_mul=FQ.mont_mul):
    """(a0+a1)(a0-a1) + 2 a0 a1 u: 2 Montgomery products."""
    t0 = mont_mul(FQ.add(a[0], a[1]), FQ.sub(a[0], a[1]))
    t1 = mont_mul(a[0], a[1])
    return (t0, FQ.add(t1, t1))


def inv(a):
    """1/(a0 + a1 u) = conj(a)/(a0^2 + a1^2): one Fermat inversion in Fq,
    every product on the mont_mul kernel wrapper."""
    norm = FQ.add(FQ.mont_mul(a[0], a[0]), FQ.mont_mul(a[1], a[1]))
    ninv = FQ.mont_inv(norm)
    return (FQ.mont_mul(a[0], ninv), FQ.neg(FQ.mont_mul(a[1], ninv)))


def is_zero(a):
    return torch.logical_and(L.is_zero(a[0]), L.is_zero(a[1]))


def select(cond, a, b):
    return (L.select(cond, a[0], b[0]), L.select(cond, a[1], b[1]))


# host encode/decode -----------------------------------------------------------

def to_mont_host(pairs):
    """list[(int, int)] -> ((n, 16), (n, 16)) numpy arrays."""
    return (FQ.to_mont_host([p[0] for p in pairs]),
            FQ.to_mont_host([p[1] for p in pairs]))


def from_mont_host(a):
    """((n, 16), (n, 16)) arrays or tensors -> list[(int, int)]."""
    return list(zip(FQ.from_mont_host(a[0]), FQ.from_mont_host(a[1])))
