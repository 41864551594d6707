"""The MSM at one window c and scan chunk.

    python -m zkrollup_torch.tools.msm_sweep C CHUNK [LOG_N] [--device cuda]

The counterpart of tools/msm_sweep.py. msm_host_combine over 2^log_n
distinct points (profile_msm2's, cached in build/msm_points/) with
seeded scalars below r, distinct=True, window c and chunk; the result is
held against the native engine's Pippenger. Prints the reference's line

    c= chunk= log_n= compile= steady= pts/s=

where compile= is the first call (the kernels' build or load included)
and steady= the mean of the three after it (the reference times one).
The reference reads its chunk from the environment when the module is
imported and so runs one process a configuration; the port passes it as
an argument, and run() takes the engine's result of an earlier
configuration over the same points.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from . import common


def run(device, c: int, chunk: int, log_n: int = 17, want=None,
        reps: int = 3) -> dict:
    """{"c", "chunk", "log_n", "compile_s", "steady_s", "pts_per_s",
    "msm" (affine)}; raises unless the MSM equals `want` (the engine's
    when not given)."""
    from ..curve.g1 import G1
    from ..msm import msm

    dev = common.device(str(device))
    n = 1 << log_n
    host = common.distinct_points(n, dev)
    pa = common.on_device(host, dev)
    sc_np = common.random_scalars(n, 1234)
    sc = torch.from_numpy(sc_np.astype(np.int32)).to(dev)
    res, first, steady = common.timed(
        lambda: msm.msm_host_combine(G1, pa, sc, c=c, distinct=True,
                                     chunk=chunk), dev, reps)
    got = common.jacobian_affine(res)
    if want is None:
        want = common.engine_msm(host, sc_np)
    if got != want:
        raise AssertionError(f"msm_sweep c={c} chunk={chunk}: the MSM "
                             "differs from the native engine")
    return {"c": c, "chunk": chunk, "log_n": log_n, "compile_s": first,
            "steady_s": steady, "pts_per_s": n / steady, "msm": got}


def line(out: dict) -> str:
    return (f"c={out['c']} chunk={out['chunk']} log_n={out['log_n']} "
            f"compile={out['compile_s']:.1f}s steady={out['steady_s']:.3f}s "
            f"pts/s={out['pts_per_s']:,.0f}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("c", type=int)
    ap.add_argument("chunk", type=int)
    ap.add_argument("log_n", type=int, nargs="?", default=17)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = common.device(args.device)
    print(line(run(dev, args.c, args.chunk, args.log_n)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
