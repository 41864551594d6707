"""Raw rates of the MSM's building blocks.

    python -m zkrollup_torch.tools.profile_kernels [--log-n 20]
        [--device cuda]

The counterpart of tools/profile_kernels.py (P_LOG_N there), at n =
2^log_n lanes of 32 distinct points of G1 tiled (P) and rolled by one (Q),
Jacobian with Z = 1. Each row is its first call and the mean of five
steady calls, each ended by a device synchronise:

  mont_mul[fq] over P.x, Q.x, in M mul/s
  g1_add of P and Q, in M add/s (and 34 Fq products an add)
  the merge tree's level 0: strided halves of P, one g1_add, two selects
  a gather of x, y and z by a permutation (index_select)
  a scatter of the n rows of x, y and z into 2^14 buckets (index_put_)
  a stable sort of (13, n / 8) keys below 1024, the indices its payload

The last three are XLA ops in the reference (jnp.take, .at[].set,
lax.sort) and torch ops here. Before anything is printed, the kernels'
results are held against their plain versions on the CPU on a sample of
lanes, the gather against the permuted rows there, the sort against
numpy's stable argsort, and the scatter to: every limb of each bucket
that was sent rows equals that limb of one of them (two rows sent to one
bucket race, limb by limb), and each other bucket stays zero.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from . import common

SAMPLE = 4096
BUCKETS_LOG = 14
SORT_ROWS = 13


def inputs(n: int, dev):
    """(P, Q): 32 distinct points tiled to n lanes and the same rolled by
    one, Jacobian (x, y, z) int32 limbs with z = 1 (Montgomery)."""
    from ..fields import limbs as L
    from ..fields.mont import FQ
    from .profile_msm import base_points
    x, y, _ = base_points(n, seed=7, count=32)
    one = np.broadcast_to(FQ.one_mont_np, x.shape)
    P = tuple(L.to_device(a, dev) for a in (x, y, one))
    Q = tuple(L.to_device(np.roll(a, 1, 0), dev) for a in (x, y, one))
    return P, Q


def level0(P):
    """The run-merge tree's level-0 pattern: strided halves (copied
    contiguous, as the tree does), one add, two selects."""
    from ..curve.g1 import G1
    a = tuple(t[0::2].contiguous() for t in P)
    b = tuple(t[1::2].contiguous() for t in P)
    br = G1.add(a, b)
    m = (torch.arange(a[0].shape[0], device=a[0].device) & 1).bool()[:, None]
    return G1.select(m, br, a), G1.select(m, br, b)


def check_scatter(rows, bidx, buckets, n_buckets: int) -> int:
    """Raise unless every limb of each bucket sent rows equals that limb
    of one of them and each other bucket is zero. Returns the count of
    buckets holding one sent row whole."""
    bidx = bidx.cpu().numpy()
    sent = np.bincount(bidx, minlength=n_buckets) > 0
    whole = np.ones(bidx.shape[0], bool)
    for t, out in zip(rows, buckets):
        t, out = t.cpu().numpy(), out.cpu().numpy()
        eq = out[bidx] == t
        for j in range(t.shape[1]):
            hit = np.bincount(bidx, weights=eq[:, j], minlength=n_buckets)
            if not (hit[sent] > 0).all():
                raise AssertionError("scatter: a bucket limb holds no "
                                     "value sent to it")
        if out[~sent].any():
            raise AssertionError("scatter: a bucket sent no row is not zero")
        whole &= eq.all(axis=1)
    return int((np.bincount(bidx, weights=whole, minlength=n_buckets)
                > 0).sum())


def run(device, log_n: int = 20, reps: int = 5) -> dict:
    """{"rows": [(name, first s, steady s, rate text)], "n", "whole"};
    raises unless every result holds."""
    from ..curve.g1 import G1
    from ..fields.mont import FQ

    dev = common.device(str(device))
    n = 1 << log_n
    P, Q = inputs(n, dev)
    rng = np.random.RandomState(0)
    lanes = torch.from_numpy(np.sort(rng.choice(n, min(SAMPLE, n),
                                                replace=False))).to(dev)
    half = lanes[lanes < n // 2]
    cpu = lambda p: tuple(a.index_select(0, lanes).cpu() for a in p)
    rows = []

    def stage(name, fn, rate):
        out, first, steady = common.timed(fn, dev, reps)
        rows.append((name, first, steady, rate(steady)))
        return out

    mm = stage(f"mont_mul[fq] 2^{log_n}", lambda: FQ.mont_mul(P[0], Q[0]),
               lambda t: f"{n / t / 1e6:.1f} M mul/s")
    if not torch.equal(mm.index_select(0, lanes).cpu(),
                       FQ.mont_mul(cpu(P)[0], cpu(Q)[0])):
        raise AssertionError("mont_mul[fq] differs from its plain version")
    add = stage(f"g1_add 2^{log_n}", lambda: G1.add(P, Q),
                lambda t: f"{n / t / 1e6:.2f} M add/s "
                          f"({n * 34 / t / 1e6:.0f} M mul-equiv/s)")
    if any(not torch.equal(a.index_select(0, lanes).cpu(), b)
           for a, b in zip(add, G1.add(cpu(P), cpu(Q)))):
        raise AssertionError("g1_add differs from its plain version")
    lv, rv = stage(f"tree level0 (halves+add+2 selects) 2^{log_n - 1}",
                   lambda: level0(P),
                   lambda t: f"{n / 2 / t / 1e6:.2f} M add/s incl. overhead")
    ev = tuple(a.index_select(0, 2 * half).cpu() for a in P)
    od = tuple(a.index_select(0, 2 * half + 1).cpu() for a in P)
    br = G1.add(ev, od)
    odd = (half.cpu() & 1).bool()[:, None]
    want_l, want_r = G1.select(odd, br, ev), G1.select(odd, br, od)
    if any(not torch.equal(a.index_select(0, half).cpu(), b)
           for a, b in zip(lv + rv, want_l + want_r)):
        raise AssertionError("tree level0 differs from its plain version")

    perm = torch.from_numpy(rng.permutation(n)).to(dev)
    moved = 3 * n * 16 * 4
    gath = stage(f"gather x,y,z by perm 2^{log_n}",
                 lambda: tuple(a.index_select(0, perm) for a in P),
                 lambda t: f"{2 * moved / t / 1e9:.1f} GB/s read+written")
    src = perm.index_select(0, lanes)
    if any(not torch.equal(g.index_select(0, lanes).cpu(),
                           a.index_select(0, src).cpu())
           for g, a in zip(gath, P)):
        raise AssertionError("gather: rows differ from the permuted rows")

    nb = 1 << BUCKETS_LOG
    bidx = torch.from_numpy(rng.randint(0, nb, size=n)).to(dev)

    def scatter():
        return tuple(a.new_zeros((nb, a.shape[1])).index_put_((bidx,), a)
                     for a in P)
    bk = stage(f"scatter-set x,y,z 2^{log_n} -> 2^{BUCKETS_LOG}", scatter,
               lambda t: f"{moved / t / 1e9:.1f} GB/s of rows")
    whole = check_scatter(P, bidx, bk, nb)

    cols = max(n // 8, 1)
    keys_np = rng.randint(0, 1024, size=(SORT_ROWS, cols)).astype(np.int32)
    keys = torch.from_numpy(keys_np).to(dev)
    vals, idx = stage(f"stable sort ({SORT_ROWS}, 2^{log_n - 3}) + payload",
                      lambda: torch.sort(keys, dim=1, stable=True),
                      lambda t: f"{SORT_ROWS * cols / t / 1e6:.1f} M keys/s")
    want = np.argsort(keys_np, axis=1, kind="stable")
    if not np.array_equal(idx.cpu().numpy(), want) or not np.array_equal(
            vals.cpu().numpy(), np.take_along_axis(keys_np, want, 1)):
        raise AssertionError("sort differs from numpy's stable argsort")
    return {"rows": rows, "n": n, "whole": whole, "buckets": nb}


def lines(out: dict) -> list:
    res = [f"{name:46s} first {first:7.3f} s  steady {steady * 1e3:9.3f} ms"
           f"  {rate}" for name, first, steady, rate in out["rows"]]
    res.append(f"  scatter: {out['whole']} of {out['buckets']} buckets hold "
               "one sent row whole")
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--log-n", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = common.device(args.device)
    out = run(dev, args.log_n)
    print(f"device: {common.device_name(dev)}; every result holds")
    for line in lines(out):
        print(line)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
