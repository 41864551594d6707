"""BN254 G1 batched points (Jacobian over Fq limbs) + host packing.

Counterpart of zkrollup/curve/g1_jax.py.
"""

from __future__ import annotations

import numpy as np

from ..fields.mont import FQ
from ..fields import limbs as L
from ..ref import bn254 as ref
from .weierstrass import JacobianCurve, FqOps

G1 = JacobianCurve(FqOps, "g1")


def pack_affine_host(points) -> tuple:
    """list of affine (x, y) | None -> (x, y, inf) host arrays, Montgomery
    form; infinity packed as (0, 0, True)."""
    xs, ys, inf = [], [], []
    for p in points:
        xs.append(0 if p is None else p[0])
        ys.append(0 if p is None else p[1])
        inf.append(p is None)
    return (FQ.to_mont_host(xs), FQ.to_mont_host(ys),
            np.asarray(inf, bool)[:, None])


def pack_jacobian_host(points, device="cpu"):
    """list of affine points | None -> Jacobian (X, Y, Z) tensors with
    Z = 1 (Montgomery) or 0 for infinity."""
    x, y, inf = pack_affine_host(points)
    z = np.broadcast_to(FQ.one_mont_np, x.shape).copy()
    z[inf[:, 0]] = 0
    return tuple(L.to_device(a, device) for a in (x, y, z))


def to_affine_host(p) -> list:
    """Batched Jacobian -> list of affine (x, y) | None, via host ints."""
    X, Y, Z = (FQ.from_mont_host(c) for c in p)
    out = []
    for x, y, z in zip(X, Y, Z):
        if z == 0:
            out.append(None)
        else:
            zinv = pow(z, -1, ref.Q)
            zi2 = zinv * zinv % ref.Q
            out.append((x * zi2 % ref.Q, y * zi2 % ref.Q * zinv % ref.Q))
    return out
