"""Wall time of each stage of prove(), one stage at a time.

    python -m zkrollup_torch.tools.prove_breakdown [--device cuda]

The counterpart of tools/prove_breakdown.py, on the (2,6) demo batch (the
reference's two sends) with its key cached in build/keys/ (made by setup
on the device the first time). Each stage runs on its own, ended by a
device synchronise, best of 2: the witness to limbs (and onto the
device), to Montgomery form, the A/B/C evaluations, the quotient, the G1
key tables packed (once; cached on the key), the merged G1 scalars, the
fused G1 window sums, the G2 scalars' merge, the G2 window sums, the four
G1 host combines and the G2 host combine. prove() overlaps the G2 MSM
with the G1 host combine, so these stages add up to more than a proof.
The stages' outputs, blinded at r = 7, s = 11, must give the bytes of
prove() at the same (r, s); then three full prove() calls are timed.
"""

from __future__ import annotations

import argparse
import time

from . import common


def run(pk, r1cs, witness, device, best_of: int = 2, full: int = 3) -> dict:
    """{"rows": [(stage, seconds)], "points": {"g1", "g2"}, "full_s":
    [seconds of each prove()], "proof"}; raises unless the stages' proof
    equals prove()'s."""
    from ..curve.g1 import G1
    from ..curve.g2 import G2
    from ..fields import limbs as L
    from ..fields.mont import FR
    from ..groth16 import prove as P
    from ..groth16.qap import to_coo
    from ..msm import msm
    from ..msm.combine import (combine_multi_window_sums_host,
                           combine_window_sums_host_g2)
    from ..ref.bn254 import R as FR_MOD

    dev = common.device(str(device))
    c, r, s = 12, 7, 11       # prove()'s default window; the blinding
    coo = to_coo(r1cs)
    m = coo.m
    rows = []

    def stage(label, fn, n=best_of):
        best, out = None, None
        for _ in range(n):
            common.sync(dev)
            t0 = time.perf_counter()
            out = fn()
            common.sync(dev)
            dt = time.perf_counter() - t0
            best = dt if best is None else min(best, dt)
        rows.append((label, best))
        return out

    wits = [w % FR_MOD for w in witness]
    w_plain = stage("ints_to_limbs",
                    lambda: L.to_device(L.ints_to_limbs(wits), dev))
    w_mont = stage("to_mont", lambda: FR.to_mont(w_plain))
    coo_dev = P._coo_on(coo, dev)
    a_e, b_e, c_e = stage("abc_evals (spmv x3)",
                          lambda: P._abc_evals(coo_dev, w_mont, m))
    z_coset = (pow(P.COSET_SHIFT, m, FR_MOD) - 1) % FR_MOD
    zinv = FR.const_mont(pow(z_coset, FR_MOD - 2, FR_MOD), dev)
    h_plain = stage("quotient (3 transforms)",
                    lambda: P._quotient_plain(a_e, b_e, c_e, zinv))
    pack = stage("device_pack_g1 (cached after 1st)",
                 lambda: P._device_pack_g1(pk, dev), n=1)
    sc_cat = stage("scalars_cat (segsum)",
                   lambda: P._scalars_cat(w_plain, h_plain, pack))
    wsum1, c1 = stage("fused G1 window sums",
                      lambda: msm.multi_window_sums(G1, pack["points"],
                                                    sc_cat, c, pack["bounds"],
                                                    distinct=True))
    g2p = stage("device_pack_g2 (cached after 1st)",
                lambda: P._device_pack_g2(pk, dev), n=1)
    sc2 = stage("g2 scalars segsum",
                lambda: P._segsum_scalars(w_plain.index_select(0, g2p["idx"]),
                                          g2p["seg"], g2p["n_seg"]))
    wsum2, c2 = stage("G2 window sums",
                      lambda: msm.window_sums(G2, g2p["points"], sc2, c=c,
                                              distinct=True))
    g1_pts = stage("G1 host combines x4",
                   lambda: combine_multi_window_sums_host(
                       P._to_host_standard(G1, wsum1)(), c1))
    pi_b = stage("G2 host combine",
                 lambda: combine_window_sums_host_g2(
                     P._to_host_standard(G2, wsum2)(), c2))
    pi_a, pi_b1, pi_c, pi_h = g1_pts
    staged = P._blind_combine(pk, pi_a, pi_b, pi_b1, pi_c, pi_h, r, s)

    full_s, proof = [], None
    for _ in range(full):
        common.sync(dev)
        t0 = time.perf_counter()
        proof = P.prove(pk, r1cs, witness, r=r, s=s, device=dev)
        common.sync(dev)
        full_s.append(time.perf_counter() - t0)
    if (staged.a, staged.b, staged.c) != (proof.a, proof.b, proof.c):
        raise AssertionError("the stages' proof differs from prove()'s")
    return {"rows": rows, "full_s": full_s, "proof": proof,
            "points": {"g1": sum(n for _, n in pack["bounds"]),
                       "g2": int(sc2.shape[0])}}


def lines(out: dict) -> list:
    res = [f"{label:34s} {sec * 1e3:9.1f} ms" for label, sec in out["rows"]]
    res.append(f"  fused G1 points: {out['points']['g1']}, G2 points: "
               f"{out['points']['g2']}")
    res += [f"full prove() #{i}: {sec:.3f} s"
            for i, sec in enumerate(out["full_s"])]
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = common.device(args.device)
    prover, prep = common.demo_batch(dev)
    pk = prover.ensure_keys()
    print(f"(2,6) demo batch: {pk.n_vars} variables, domain "
          f"{pk.domain_size}, on {common.device_name(dev)}", flush=True)
    out = run(pk, prover.structure_r1cs(), prep.witness, dev)
    for line in lines(out):
        print(line)
    print("the stages' proof equals prove()'s bytes")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
