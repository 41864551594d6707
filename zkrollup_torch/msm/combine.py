"""The host Horner combines of the prover's window sums.

Counterpart of the combines in zkrollup/msm/glv.py. The window sums of
an MSM (msm.window_sums, msm.multi_window_sums) are few, about 22 a table
at c = 12; the prover combines them, res = 2^c res + W_w from the highest
window down, on the host in Python ints (zkrollup_torch.ref), as the
reference does, while msm.msm combines on the card in one launch of the
Horner kernel:

  combine_window_sums_host        G1, Montgomery leaves, back on the
                                  device as a Jacobian point (msm.py:
                                  msm_host_combine)
  combine_multi_window_sums_host  G1, (W, T, 16) window sums of T tables
                                  in STANDARD form, T affine points
  combine_window_sums_host_g2     G2, STANDARD form, one affine point

The prover converts its window sums to standard form on the device
(FQ.from_mont) before the one device-to-host copy.
"""

from __future__ import annotations

import numpy as np

from ..fields import limbs as L
from ..fields.mont import FQ
from ..ref import bn254 as ref


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
