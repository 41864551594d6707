"""Horner combine of MSM window sums on the host.

Counterpart of combine_multi_window_sums_host and
combine_window_sums_host_g2 in zkrollup/msm/glv.py, on numpy and
ref.bn254. The window sums arrive in STANDARD (not Montgomery)
form: the prover converts them on the device (FQ.from_mont) before the one
device-to-host copy.
"""

from __future__ import annotations

import numpy as np

from ..fields import limbs as L
from ..ref import bn254 as ref


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
