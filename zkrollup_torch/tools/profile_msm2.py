"""The MSM over distinct points, and the prover's fused four-table MSM.

    python -m zkrollup_torch.tools.profile_msm2 [--log-n 17] [-c 12]
        [--chunk 128] [--distinct 1] [--multi 1] [--device cuda]

The counterpart of tools/profile_msm2.py (P_LOG_N, P_C, P_CHUNK,
P_DISTINCT and P_MULTI there). The points are distinct, k G for distinct
seeded k by the port's fixed base on the device (cached in
build/msm_points/), as the key tables are:

  (a) msm_host_combine over 2^log_n points: window sums on the device,
      the Horner combine on the host
  (b) msm_multi_host_combine over four tables of 111,000, 75,000, 117,000
      and 131,071 points (434,071 in all: the prover's a, b1, c and h
      tables of BatchProcessTx(2,6)), packed by pack_tables into one scan

each as its first call and the mean of three steady calls, with points/s.
Both results are held against the native engine's Pippenger (per table
for (b)) before anything is printed.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from . import common

# the prove-shaped tables of (b)
PROVE_TABLES = (111_000, 75_000, 117_000, 131_071)


def run(device, log_n: int = 17, c: int = 12, chunk: int = 128,
        distinct: bool = True, multi: bool = True, reps: int = 3,
        tables=None) -> dict:
    """{"rows": [(stage, first s, steady s, points)], "results": {"a":
    affine, "b": [affine per table]}}; raises unless each equals the
    engine. tables: the sizes of (b)'s tables, PROVE_TABLES by default."""
    from ..curve.g1 import G1
    from ..msm import msm

    dev = common.device(str(device))
    n = 1 << log_n
    host = common.distinct_points(n, dev)
    pa = common.on_device(host, dev)
    sc_np = common.random_scalars(n, 1234)
    sc = torch.from_numpy(sc_np.astype(np.int32)).to(dev)
    rows, results = [], {}
    res, first, steady = common.timed(
        lambda: msm.msm_host_combine(G1, pa, sc, c=c, distinct=distinct,
                                     chunk=chunk), dev, reps)
    rows.append((f"(a) window_sums+host combine (single 2^{log_n})", first,
                 steady, n))
    results["a"] = common.jacobian_affine(res)
    if results["a"] != common.engine_msm(host, sc_np):
        raise AssertionError("profile_msm2 (a): msm_host_combine differs "
                             "from the native engine")

    if multi:
        tables = PROVE_TABLES if tables is None else tables
        total = sum(tables)
        x, y, inf = common.distinct_points(total, dev)
        tbls, s0 = [], 0
        for size in tables:
            tbls.append((x[s0:s0 + size], y[s0:s0 + size],
                         inf[s0:s0 + size]))
            s0 += size
        packed, bounds = msm.pack_tables(tbls, chunk=chunk)
        sc_cat = common.random_scalars(packed[0].shape[0], 4321)
        sc_cat[total:] = 0
        scj = torch.from_numpy(sc_cat.astype(np.int32)).to(dev)
        pk_dev = common.on_device(packed, dev)
        res, first, steady = common.timed(
            lambda: msm.msm_multi_host_combine(G1, pk_dev, bounds, scj,
                                               c=c, distinct=distinct,
                                               chunk=chunk), dev, reps)
        rows.append((f"(b) fused {len(tables)}-table ({total} pts, prove "
                     "shape)", first, steady, total))
        results["b"] = [common.jacobian_affine(p) for p in res]
        want = [common.engine_msm(t, sc_cat[s:s + l])
                for t, (s, l) in zip(tbls, bounds)]
        if results["b"] != want:
            raise AssertionError("profile_msm2 (b): msm_multi_host_combine "
                                 "differs from the native engine")
    return {"rows": rows, "results": results}


def lines(out: dict) -> list:
    res = []
    for label, first, steady, pts in out["rows"]:
        res.append(f"{label:46s} first {first:7.3f} s  steady "
                   f"{steady * 1e3:9.3f} ms")
        res.append(f"-> {pts / steady:,.0f} points/s")
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--log-n", type=int, default=17)
    ap.add_argument("-c", type=int, default=12)
    ap.add_argument("--chunk", type=int, default=128)
    ap.add_argument("--distinct", type=int, choices=(0, 1), default=1)
    ap.add_argument("--multi", type=int, choices=(0, 1), default=1)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = common.device(args.device)
    out = run(dev, args.log_n, args.c, args.chunk, bool(args.distinct),
              bool(args.multi))
    print(f"device: {common.device_name(dev)} c={args.c} "
          f"chunk={args.chunk} distinct={bool(args.distinct)}; each result "
          "equals the native engine")
    for line in lines(out):
        print(line)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
