"""The single-table MSM's stages, timed one at a time.

    python -m zkrollup_torch.tools.profile_msm [--log-n 17] [-c 12]
        [--tree scan|scan1|affine|jacobian] [--device cuda]

The counterpart of tools/profile_msm.py (P_LOG_N, P_C and
ZKROLLUP_MSM_TREE there). n = 2^log_n points, 64 distinct points of G1
tiled (duplicates: msm() with distinct=False), seeded scalars below r.
Each stage is reported as its first call and the mean of three steady
calls, each ended by a device synchronise:

  (b) window_digits
  (c) the batched row sort (stable) and the flat gather of x, y and inf
  (d) the window sums of `tree` (sort, buckets or scan, reduction)
  (f) the full msm(): the window sums and the Horner combine

and points/s of (f). (f)'s result is held against the native engine's
Pippenger over the same table before anything is printed.
"""

from __future__ import annotations

import argparse
import random

import numpy as np
import torch

from . import common


def base_points(n: int, seed: int = 1234, count: int = 64):
    """`count` distinct points k G (seeded k) tiled to n rows, packed
    affine Montgomery limbs (x, y, inf) on the host."""
    from ..curve import g1
    from ..ref import bn254 as ref
    rnd = random.Random(seed)
    base = [ref.g1_mul(ref.G1_GEN, rnd.randrange(1, ref.R))
            for _ in range(count)]
    x, y, inf = g1.pack_affine_host(base)
    reps = -(-n // count)
    return (np.tile(x, (reps, 1))[:n], np.tile(y, (reps, 1))[:n],
            np.tile(inf, (reps, 1))[:n])


def run(device, log_n: int = 17, c: int = 12, tree: str = "scan",
        reps: int = 3) -> dict:
    """{"rows": [(stage, first s, steady s)], "points_per_s", "msm"
    (affine), "n", "c"}; raises unless (f) equals the engine."""
    from ..curve.g1 import G1
    from ..msm import msm

    dev = common.device(str(device))
    msm._check_tree(tree)
    n = 1 << log_n
    host = base_points(n)
    pa = common.on_device(host, dev)
    sc_np = common.random_scalars(n, 1234)
    sc = torch.from_numpy(sc_np.astype(np.int32)).to(dev)
    c = msm._clamp_window(c, n)
    n_windows = (256 + c - 1) // c
    rows = []

    def stage(label, fn):
        out, first, steady = common.timed(fn, dev, reps)
        rows.append((label, first, steady))
        return out

    digits = stage("(b) window_digits",
                   lambda: msm.window_digits(sc, c, n_windows))

    def sort_gather():
        _, perm = torch.sort(digits, dim=1, stable=True)
        idx = perm.reshape(-1)
        return tuple(a.index_select(0, idx) for a in pa)
    stage("(c) batched sort + flat gather", sort_gather)
    stage(f"(d) window sums ({tree})",
          lambda: msm._flat_window_sums(G1, digits, pa[:2], pa[2], c,
                                        False, tree))
    res = stage("(f) full msm", lambda: msm.msm(G1, pa, sc, c=c, tree=tree))
    got = common.jacobian_affine(res)
    if got != common.engine_msm(host, sc_np):
        raise AssertionError("profile_msm: msm() differs from the native "
                             "engine")
    return {"rows": rows, "points_per_s": n / rows[-1][2], "msm": got,
            "n": n, "c": c}


def lines(out: dict) -> list:
    res = [f"{label:44s} first {first:7.3f} s  steady {steady * 1e3:9.3f} ms"
           for label, first, steady in out["rows"]]
    res.append(f"-> {out['points_per_s']:,.0f} points/s")
    return res


def main(argv=None) -> int:
    from ..msm.msm import TREES
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--log-n", type=int, default=17)
    ap.add_argument("-c", type=int, default=12)
    ap.add_argument("--tree", choices=TREES, default="scan")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = common.device(args.device)
    out = run(dev, args.log_n, args.c, args.tree)
    print(f"device: {common.device_name(dev)}  tree={args.tree} "
          f"c={out['c']} n=2^{args.log_n}; msm() equals the native engine")
    for line in lines(out):
        print(line)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
