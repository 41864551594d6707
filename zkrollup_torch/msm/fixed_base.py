"""Fixed-base batched scalar multiplication for BN254 G1/G2 on a torch
device: the tables of the Groth16 setup.

Counterpart of zkrollup/msm/fixed_base.py. The setup is a few hundred
thousand scalar multiplications of the two fixed generators. A fixed base
makes Pippenger unnecessary: per-window multiples of the generator are
computed once on the host (32 windows of 2^8 points), and every key point
is 32 gathers and 32 mixed adds, batched over a chunk of the table. The
step's q is affine or infinity, which is madd_z01's contract, so each
window is one launch of the g1_madd / g2_madd kernel (its doubling path
makes it correct for every pair). The batch is then normalised to packed
affine form with one Fermat inversion per point on the mont_mul kernel.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..fields.mont import FQ
from ..fields import limbs as L, fq2
from ..ref import bn254 as ref
from ..curve import g1, g2
from .msm import window_digits

WINDOW_C = 8
N_WINDOWS = (256 + WINDOW_C - 1) // WINDOW_C  # 32


@lru_cache(maxsize=None)
def _g1_table_host():
    """(W, 2^c) multiples d * 2^(c*w) * G1_GEN, packed affine mont limbs."""
    pts = []
    base = ref.G1_GEN
    for _ in range(N_WINDOWS):
        acc = None
        row = [None]
        for _ in range(1, 1 << WINDOW_C):
            acc = ref.g1_add(acc, base)
            row.append(acc)
        pts.extend(row)
        base = ref.g1_add(acc, base)  # 2^c * base
    x, y, inf = g1.pack_affine_host(pts)
    shape = (N_WINDOWS, 1 << WINDOW_C)
    return (x.reshape(shape + (L.N_LIMBS,)), y.reshape(shape + (L.N_LIMBS,)),
            inf.reshape(shape + (1,)))


@lru_cache(maxsize=None)
def _g2_table_host():
    pts = []
    base = ref.G2_GEN
    for _ in range(N_WINDOWS):
        acc = None
        row = [None]
        for _ in range(1, 1 << WINDOW_C):
            acc = ref.g2_add(acc, base)
            row.append(acc)
        pts.extend(row)
        base = ref.g2_add(acc, base)
    (x0, x1), (y0, y1), inf = g2.pack_affine_host(pts)
    shape = (N_WINDOWS, 1 << WINDOW_C)
    rs = lambda a: a.reshape(shape + (L.N_LIMBS,))
    return (rs(x0), rs(x1), rs(y0), rs(y1), inf.reshape(shape + (1,)))


def _z01(curve, inf, device):
    """Z = 1 (Montgomery) off infinity, 0 on it, for a (..., 1) mask."""
    shape = tuple(inf.shape[:-1])
    return curve.F.select(inf, curve.F.zeros(shape, device),
                          curve.F.one(shape, device))


@lru_cache(maxsize=None)
def _g1_table(device: str):
    """The G1 window table on `device` as Jacobian (X, Y, Z) leaves of shape
    (W, 2^c, 16), Z in {0, 1}."""
    x, y, inf = _g1_table_host()
    inf_t = torch.from_numpy(inf).to(device)
    return (L.to_device(x, device), L.to_device(y, device),
            _z01(g1.G1, inf_t, device))


@lru_cache(maxsize=None)
def _g2_table(device: str):
    x0, x1, y0, y1, inf = _g2_table_host()
    d = lambda a: L.to_device(a, device)
    inf_t = torch.from_numpy(inf).to(device)
    return ((d(x0), d(x1)), (d(y0), d(y1)), _z01(g2.G2, inf_t, device))


def _fixed_base(curve, table, scalars):
    """Shared loop: digits -> per window, a gather from the table and one
    madd_z01(distinct=False) launch."""
    n = scalars.shape[0]
    digits = window_digits(scalars, WINDOW_C, N_WINDOWS)  # (W, n)
    acc = curve.infinity((n,), scalars.device)
    for w in range(N_WINDOWS):
        d = digits[w]
        q = curve.map(lambda a: a[w].index_select(0, d).contiguous(), table)
        acc = curve.madd_z01(acc, q, distinct=False)
    return acc


def fixed_base_g1(scalars: torch.Tensor):
    """scalars: (n, 16) PLAIN-form limbs -> batched Jacobian G1 points
    scalar_i * G1_GEN, on the scalars' device."""
    return _fixed_base(g1.G1, _g1_table(str(scalars.device)), scalars)


def fixed_base_g2(scalars: torch.Tensor):
    return _fixed_base(g2.G2, _g2_table(str(scalars.device)), scalars)


# -- device Jacobian -> packed affine (batch-normalized) ---------------------

def g1_normalize_packed(p):
    """Batched Jacobian -> (x, y, inf) packed affine on the device;
    infinity as x = y = 0 with the flag set."""
    X, Y, Z = p
    inf = L.is_zero(Z)
    zsafe = L.select(inf, FQ.one_mont(Z.device).expand(Z.shape), Z)
    zi = FQ.mont_inv(zsafe)
    zi2 = FQ.mont_mul(zi, zi)
    x = FQ.mont_mul(X, zi2)
    y = FQ.mont_mul(Y, FQ.mont_mul(zi2, zi))
    zero = torch.zeros_like(x)
    return (L.select(inf, zero, x), L.select(inf, zero, y), inf)


def g2_normalize_packed(p):
    X, Y, Z = p
    inf = fq2.is_zero(Z)
    one = g2.G2.F.one(tuple(Z[0].shape[:-1]), Z[0].device)
    zsafe = tuple(t.contiguous() for t in fq2.select(inf, one, Z))
    zi = fq2.inv(zsafe)
    zi2 = fq2.sqr(zi)
    x = fq2.mul(X, zi2)
    y = fq2.mul(Y, fq2.mul(zi2, zi))
    zero = torch.zeros_like(Z[0])
    x = fq2.select(inf, (zero, zero), x)
    y = fq2.select(inf, (zero, zero), y)
    return (x, y, inf)


def _host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy().astype(np.uint32)


def _scalar_chunk(scalars_int, i: int, chunk: int, device) -> torch.Tensor:
    return L.to_device(L.ints_to_limbs(
        [x % ref.R for x in scalars_int[i:i + chunk]]), device)


def g1_points_from_scalars(scalars_int, chunk: int = 1 << 15,
                           device="cuda"):
    """Host int scalars -> packed affine (x, y, inf) numpy arrays of
    scalar_i * G1, computed on `device`. Chunked so device memory stays
    bounded."""
    device = torch.device(device)
    xs, ys, infs = [], [], []
    for i in range(0, len(scalars_int), chunk):
        sc = _scalar_chunk(scalars_int, i, chunk, device)
        x, y, inf = g1_normalize_packed(fixed_base_g1(sc))
        xs.append(_host(x))
        ys.append(_host(y))
        infs.append(inf.cpu().numpy())
    return (np.concatenate(xs), np.concatenate(ys), np.concatenate(infs))


def g2_points_from_scalars(scalars_int, chunk: int = 1 << 14,
                           device="cuda"):
    device = torch.device(device)
    out = None
    for i in range(0, len(scalars_int), chunk):
        sc = _scalar_chunk(scalars_int, i, chunk, device)
        (x0, x1), (y0, y1), inf = g2_normalize_packed(fixed_base_g2(sc))
        part = [_host(a) for a in (x0, x1, y0, y1)] + [inf.cpu().numpy()]
        out = part if out is None else [
            np.concatenate([a, b]) for a, b in zip(out, part)]
    x0, x1, y0, y1, inf = out
    return ((x0, x1), (y0, y1), inf)
