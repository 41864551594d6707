"""GLV endomorphism MSM for BN254 G1, and the host Horner combines.

Counterpart of zkrollup/msm/glv.py. BN254 has CM discriminant -3: the
automorphism phi(x, y) = (beta x, y), beta a primitive cube root of unity
in Fq, acts on G1 as multiplication by lambda, a cube root of unity mod r.
Every scalar splits as k = k1 + k2 lambda with |k1|, |k2| < 2^128 (Babai
rounding on a reduced lattice basis), so the MSM runs over twice the points
with about half the windows. The decomposition runs on the host (the
native engine's zkh_glv_decompose, or the Python ground truth); the
endomorphism table phi(P) is one mont_mul kernel launch over the x column
with beta broadcast; the signs are folded into the points (-P = (x, -y));
the window sums come from msm.window_sums with any bucket strategy; and
the Horner combine over the ~11 window sums runs on the host in Python
ints.

The combines of the default prover's window sums are here too:
combine_multi_window_sums_host and combine_window_sums_host_g2 take the
window sums in STANDARD (not Montgomery) form: the prover converts them on
the device (FQ.from_mont) before the one device-to-host copy.
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import numpy as np
import torch

from ..curve.g1 import G1
from ..fields import limbs as L
from ..fields.mont import FQ
from ..ref import bn254 as ref
from ..ref.bn254 import R as FR_MOD
from .msm import window_sums, _clamp_window

# lambda^2 + lambda + 1 = 0 mod r;  phi(P) = lambda * P with
# phi(x, y) = (BETA * x, y), beta^2 + beta + 1 = 0 mod q.
LAMBDA = 4407920970296243842393367215006156084916469457145843978461
BETA = 2203960485148121921418603742825762020974279258880205651966

# reduced lattice basis of {(a, b) : a + b*lambda = 0 mod r}
_V1 = (9931322734385697763, -147946756881789319000765030803803410728)
_V2 = (147946756881789319010696353538189108491, 9931322734385697763)

# decomposed halves are < 2^128; 130 bits leaves sign-fold headroom
GLV_BITS = 130


def decompose(k: int) -> Tuple[int, int]:
    """k (mod r) -> (k1, k2), signed, with k = k1 + k2*lambda (mod r)."""
    k %= FR_MOD
    a1, b1 = _V1
    a2, b2 = _V2
    # Babai rounding: (c1, c2) = round( (k, 0) * B^-1 )
    c1 = (b2 * k + FR_MOD // 2) // FR_MOD
    c2 = (-b1 * k + FR_MOD // 2) // FR_MOD
    k1 = k - c1 * a1 - c2 * a2
    k2 = -c1 * b1 - c2 * b2
    return k1, k2


def decompose_batch(scalars: Union[Sequence[int], np.ndarray]):
    """-> (abs_limbs (2n, 16) uint32, neg (2n, 1) bool). The first n rows
    are |k1| (for P), the last n rows |k2| (for phi(P)). Takes host ints or
    an (n, 16) limb array of canonical scalars (no Python-int packing);
    goes to the native engine (zkh_glv_decompose) when it is built."""
    from ..native import engine
    if isinstance(scalars, np.ndarray):
        limbs = np.asarray(scalars, dtype=np.uint32)
        if limbs.ndim != 2 or limbs.shape[1] != L.N_LIMBS:
            raise ValueError(f"expected (n, 16) limbs, got {limbs.shape}")
        if engine.available():
            return engine.glv_decompose_limbs(limbs)
        return decompose_batch_py(L.limbs_to_ints(limbs))
    if engine.available():
        return engine.glv_decompose_batch([k % FR_MOD for k in scalars])
    return decompose_batch_py(scalars)


def decompose_batch_py(scalars: Sequence[int]):
    """Pure-Python ground truth for the native decomposition."""
    k1s, k2s, negs = [], [], []
    for k in scalars:
        k1, k2 = decompose(k)
        k1s.append(abs(k1))
        k2s.append(abs(k2))
        negs.append((k1 < 0, k2 < 0))
    abs_limbs = L.ints_to_limbs(k1s + k2s)
    neg = np.asarray([s for s, _ in negs] + [s for _, s in negs],
                     bool).reshape(-1, 1)
    return abs_limbs, neg


_BETA_MONT_NP = L.int_to_limbs(BETA * (1 << 256) % FQ.p)


def _glv_window_sums_device(points_affine, abs_scalars, neg, c: int,
                            tree: str = "scan"):
    """points (x, y, inf) tensors, n rows; abs_scalars (2n, 16); neg
    (2n, 1) bool, all on one device. Returns the per-window Jacobian sums,
    leaves (W, 16) with W = ceil(130 / c)."""
    x, y, inf = points_affine
    beta = L.to_device(_BETA_MONT_NP, x.device)
    # the endomorphism table: phi(P) = (beta x, y)
    x2 = torch.cat([x, FQ.mont_mul(x.contiguous(), beta)])
    y2 = torch.cat([y, y])
    inf2 = torch.cat([inf, inf])
    # fold the decomposition signs into the points: -P = (x, -y); FQ.neg
    # keeps the zero y of an infinity row at 0
    y2 = L.select(neg, FQ.neg(y2), y2)
    wsum, _ = window_sums(G1, (x2, y2, inf2), abs_scalars, c=c,
                          n_bits=GLV_BITS, tree=tree)
    return wsum


def combine_window_sums_host(wsum, c: int):
    """Horner combine of per-window Jacobian sums on the host in Python
    ints. wsum: (X, Y, Z) with (W, 16) Montgomery limb leaves. Returns the
    Jacobian point with (16,) Montgomery leaves on wsum's device."""
    X, Y, Z = (FQ.from_mont_host(a) for a in wsum)
    res = (0, 1, 0)
    for w in range(len(X) - 1, -1, -1):
        for _ in range(c):
            res = ref.g1_jac_double(res)
        res = ref.g1_jac_add(res, (X[w], Y[w], Z[w]))
    dev = wsum[0].device
    return tuple(L.to_device(FQ.to_mont_host([v])[0], dev) for v in res)


def msm_glv(points_affine, scalars, c: int = 10, tree: str = "scan"):
    """GLV MSM over G1 (glv.py:msm_glv). points_affine: (x, y, inf)
    tensors on the device that runs it; scalars: host ints, or an (n, 16)
    limb array (numpy or tensor) of canonical scalars. tree: the bucket
    strategy of the window sums (msm.TREES). Returns a Jacobian point with
    (16,) leaves, as msm.msm."""
    if isinstance(scalars, torch.Tensor):
        scalars = scalars.cpu().numpy()
    abs_limbs, neg = decompose_batch(scalars)
    dev = points_affine[0].device
    c_eff = _clamp_window(c, abs_limbs.shape[0])
    wsum = _glv_window_sums_device(points_affine,
                                   L.to_device(abs_limbs, dev),
                                   torch.from_numpy(neg).to(dev), c_eff,
                                   tree)
    return combine_window_sums_host(wsum, c_eff)


def combine_multi_window_sums_host(wsum, c: int) -> list:
    """wsum: (X, Y, Z) with (W, T, 16) standard-form limb leaves (arrays or
    tensors). Returns T affine points (x, y) | None, sum_w 2^(c w) W_{w,t}."""
    xs, ys, zs = (np.asarray(a.cpu() if hasattr(a, "cpu") else a)
                  for a in wsum)
    if xs.ndim != 3:
        raise ValueError(f"expected (W, T, 16) window sums, got {xs.shape}")
    W, T = xs.shape[:2]
    X, Y, Z = (L.limbs_to_ints(a.reshape(-1, L.N_LIMBS)) for a in (xs, ys, zs))
    out = []
    for t in range(T):
        res = (0, 1, 0)
        for w in range(W - 1, -1, -1):
            for _ in range(c):
                res = ref.g1_jac_double(res)
            k = w * T + t
            res = ref.g1_jac_add(res, (X[k], Y[k], Z[k]))
        out.append(ref.g1_jac_to_affine(res))
    return out


def combine_window_sums_host_g2(wsum, c: int):
    """wsum: ((X0, X1), (Y0, Y1), (Z0, Z1)) with (W, 16) standard-form limb
    leaves. Returns the affine point ((x0, x1), (y0, y1)) | None."""
    X, Y, Z = ([tuple(v) for v in zip(*(L.limbs_to_ints(a) for a in coord))]
               for coord in wsum)
    res = None
    for w in range(len(X) - 1, -1, -1):
        if res is not None:
            res = ref.g2_mul(res, 1 << c)
        if Z[w] != (0, 0):
            zinv = ref.fq2_inv(Z[w])
            zi2 = ref.fq2_sqr(zinv)
            pt = (ref.fq2_mul(X[w], zi2),
                  ref.fq2_mul(ref.fq2_mul(Y[w], zi2), zinv))
            res = pt if res is None else ref.g2_add(res, pt)
    return res
