"""Differential check of the G2 point kernels against zkrollup_torch.ref.

Counterpart of tools/g2_kernel_check.py, which runs the Pallas G2 kernels
in interpret mode. Here every G2 kernel (g2_madd_nd, g2_double, g2_add,
g2_madd, g2_add_nd, g2_add_z01) runs once on the device it is given, over
the reference tool's mixed-case lanes: generic adds, P + P, P + (-P),
infinities and non-unit Z. Each affine result must equal ref.bn254's. The
kernels are reached through the curve's own methods (JacobianCurve.add_nd
and the others), so on a CUDA device every launch counts on the path that
runs this check.

    python -m zkrollup_torch.tools.g2_kernel_check [--device cuda]

Prints "G2KERNELS OK" on success.
"""

from __future__ import annotations

import argparse

import torch

from ..curve import g2
from ..ref import bn254 as ref


def run(device="cuda", log=print) -> None:
    """Every G2 point kernel on `device` over the mixed-case lanes; raises
    AssertionError on the first mismatch."""
    curve = g2.G2
    dev = torch.device(device)
    add, neg = ref.g2_add, ref.g2_neg
    pts = lambda ks: [None if k is None else ref.g2_mul(ref.G2_GEN, k)
                      for k in ks]
    jac = lambda ps: curve.map(lambda a: a.to(dev),
                               g2.pack_jacobian_host(ps))
    expected = lambda pa, qa: [add(a, b) for a, b in zip(pa, qa)]

    def check(name, got, want):
        got = g2.to_affine_host(got)
        if got != want:
            raise AssertionError(f"g2_{name}: mismatch\n got={got}"
                                 f"\nwant={want}")
        log(f"g2_{name}: ok")

    # the no-double adds: no P + P lane; P + (-P) and infinities stay exact
    pa2 = pts([5, 77, None, 31, 12, None])
    qa2 = pts([11, 900, 31, None, None, None])
    qa2[4] = neg(pa2[4])
    check("madd_nd", curve.madd_z01(jac(pa2), jac(qa2), distinct=True),
          expected(pa2, qa2))
    dd = pts([5, 77, 123, None])
    check("double", curve.double(jac(dd)),
          [None if a is None else add(a, a) for a in dd])

    # mixed-case lanes: P + P, P + (-P), infinities on either side
    pa = pts([5, 77, 123, 9, 9, 10, None, 31, None])
    qa = pts([11, 900, 124, 9, None, None, 31, None, None])
    qa[5] = neg(pa[5])
    check("add", curve.add(jac(pa), jac(qa)), expected(pa, qa))
    check("madd", curve.madd_z01(jac(pa), jac(qa)), expected(pa, qa))
    check("add_z01", curve.add_z01(jac(pa), jac(qa)), expected(pa, qa))
    check("add_nd", curve.add_nd(jac(pa2), jac(qa2)), expected(pa2, qa2))

    # non-unit Z on both sides: the unified add and the no-double add of
    # sums of the first batch
    s1 = curve.add(jac(pa2), jac(qa2))
    s2 = curve.add(jac(qa2), jac(qa2))
    sums = expected(pa2, qa2)
    dbl = [add(v, v) for v in sums]
    check("add non-unit Z", curve.add(s1, s1), dbl)
    check("add_nd non-unit Z", curve.add_nd(s1, s2),
          [add(a, add(b, b)) for a, b in zip(sums, qa2)])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    run(args.device)
    print("G2KERNELS OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
