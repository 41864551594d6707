"""BN254 G2 batched points (Jacobian over Fq2) + host packing.

Counterpart of zkrollup/curve/g2_jax.py.
"""

from __future__ import annotations

import numpy as np

from ..fields.mont import FQ
from ..fields import limbs as L, fq2
from ..ref import bn254 as ref
from .weierstrass import JacobianCurve, Fq2Ops

G2 = JacobianCurve(Fq2Ops, "g2")


def pack_affine_host(points) -> tuple:
    """list of affine ((x0, x1), (y0, y1)) | None -> ((x0, x1), (y0, y1),
    inf) host arrays, Montgomery form."""
    xs, ys, inf = [], [], []
    for p in points:
        xs.append((0, 0) if p is None else p[0])
        ys.append((0, 0) if p is None else p[1])
        inf.append(p is None)
    return (fq2.to_mont_host(xs), fq2.to_mont_host(ys),
            np.asarray(inf, bool)[:, None])


def pack_jacobian_host(points, device="cpu"):
    x, y, inf = pack_affine_host(points)
    z0 = np.broadcast_to(FQ.one_mont_np, x[0].shape).copy()
    z0[inf[:, 0]] = 0
    z1 = np.zeros_like(z0)
    dev = lambda a: L.to_device(a, device)
    return ((dev(x[0]), dev(x[1])), (dev(y[0]), dev(y[1])),
            (dev(z0), dev(z1)))


def to_affine_host(p) -> list:
    X, Y, Z = (fq2.from_mont_host(c) for c in p)
    out = []
    for x, y, z in zip(X, Y, Z):
        if z == (0, 0):
            out.append(None)
        else:
            zinv = ref.fq2_inv(z)
            zi2 = ref.fq2_sqr(zinv)
            out.append((ref.fq2_mul(x, zi2),
                        ref.fq2_mul(ref.fq2_mul(y, zi2), zinv)))
    return out
