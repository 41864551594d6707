#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (zkrollup_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases; any failure raises and the script exits non-zero:
  0. the card's name and power limit; a CUDA device is required
  1. build the CUDA kernels (nvcc, from zkrollup_torch/csrc) and the native
     host engine (g++, from native/src into build/native), with seconds
  2. every kernel instantiation against its plain PyTorch version on the
     card, bit for bit, at the main path's widths, with both times and the
     kernel's bound (the least time the card could take for the work);
     the double also on one lane, the width of the MSM's Horner
  3. setup on the card: TxProver for the default BatchProcessTx(2, 6)
     config makes its key from a fixed seed with the fixed-base tables on
     the GPU (never read from a cache); setup_host makes the same key on
     the native engine; the two must be equal byte for byte
  4. the main path: two deposits, the two signed transfers of the demo
     rollup, one proof with the card-made key at pinned (r, s) that must
     self-verify and equal the native engine's proof byte for byte, the
     expected final balances, then three proofs at random (r, s), each
     self-verified
  5. the general MSM: msm(distinct=False) over the key's a table (with its
     duplicate points) and its undeduplicated b2 table, against the native
     engine's Pippenger over the same tables, as affine points
  6. the launch count of every kernel on each path (setup, the first proof,
     the MSMs), each counted from 0 just before its path; each kernel of a
     path must launch on it
The last three lines of standard output are one JSON object with the kernel
list, the card's name and power limit, and one JSON object with the device;
nothing is printed as a result when a phase fails.
"""

import sys

# Nothing of JAX and nothing of the zkrollup package may load: the port
# carries its own copies of the jax-free modules it needs.
sys.modules["jax"] = None
sys.modules["zkrollup"] = None

import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import time  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
SEED = 20261016
SETUP_SEED = b"chip-smoke"

_CU = "zkrollup_torch/csrc/kernels.cu"
# kernel -> (source, the Pallas kernel it replaces)
KERNELS = {
    "mont_mul[fr]": (_CU, "zkrollup/fields/pallas_mont.py:211"),
    "mont_mul[fq]": (_CU, "zkrollup/fields/pallas_mont.py:211"),
    "butterfly": (_CU, "zkrollup/fields/pallas_mont.py:175"),
    "g1_madd_nd": (_CU, "zkrollup/curve/pallas_curve.py:504"),
    "g1_add": (_CU, "zkrollup/curve/pallas_curve.py:480"),
    "g2_madd_nd": (_CU, "zkrollup/curve/pallas_curve_g2.py:304"),
    "g2_add": (_CU, "zkrollup/curve/pallas_curve_g2.py:288"),
    "g1_double": (_CU, "zkrollup/curve/pallas_curve.py:510"),
    "g2_double": (_CU, "zkrollup/curve/pallas_curve_g2.py:310"),
    "g1_madd": (_CU, "zkrollup/curve/pallas_curve.py:498"),
    "g2_madd": (_CU, "zkrollup/curve/pallas_curve_g2.py:299"),
}

# the kernels each path must launch
PATHS = {
    "setup": ("mont_mul[fq]", "g1_madd", "g2_madd"),
    "prove": ("mont_mul[fr]", "mont_mul[fq]", "butterfly", "g1_madd_nd",
              "g1_add", "g2_madd_nd", "g2_add"),
    "msm": ("g1_madd", "g2_madd", "g1_double", "g2_double", "g1_add",
            "g2_add"),
}

# -- the bound: the least time an H100 SXM could take for a kernel's work ---
HBM_BYTES_PER_S = 3.35e12          # device memory rate (NVIDIA data sheet)
# 32-bit integer multiply-adds: 64 per clock per SM (CUDA C++ Programming
# Guide, arithmetic instruction throughput, compute capability 9.0), 132
# SMs, 1.98 GHz maximum boost clock
INT_MULS_PER_S = 64 * 132 * 1.98e9
MULS_PER_PRODUCT = 264             # one 8-word CIOS product: 8 x (16 + 1 + 16)
# One coordinate value is 256 bits. The port stores it as a 64-byte row of
# 16 int32 words holding 16-bit limbs, a storage choice that doubles the
# bytes its kernels move; the bound counts the packed 32 bytes.
VALUE_BYTES = 32
# per lane: (Fq products of the add path, Fq products of the doubling path,
# taken only on the lanes where P == Q, coordinate values read + written).
# An Fq2 product is 3 Fq products, an Fq2 square 2.
PER_LANE = {
    "mont_mul": (1, 0, 3),
    "g1_double": (7, 0, 6), "g2_double": (16, 0, 12),
    "g1_madd": (11, 6, 9), "g2_madd": (30, 13, 18),
    "g1_madd_nd": (11, 0, 9), "g2_madd_nd": (30, 0, 18),
    "g1_add": (16, 7, 9), "g2_add": (44, 16, 18),
}


def bound(products: float, nbytes: float):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    32-bit multiplies over the integer-multiply rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = products * MULS_PER_PRODUCT / INT_MULS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def lane_bound(name: str, lanes: int, doubling_lanes: int = 0):
    add, dbl, values = PER_LANE[name.split("[")[0]]
    return bound(add * lanes + dbl * doubling_lanes,
                 values * VALUE_BYTES * lanes)


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, iters: int) -> float:
    """Mean device milliseconds per call, CUDA events around `iters` calls
    after one warm-up call. The calls are queued behind a GPU sleep of about
    50 ms, so a kernel's time is its device time and not the host's time to
    launch it (a wrapper spends tens of microseconds of Python per launch);
    a plain version, which synchronises inside, waits the sleep out before
    its first step."""
    import torch
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters


def max_abs_err(got, want) -> int:
    return max(int((g.to(int) - w.to(int)).abs().max()) if g.numel() else 0
               for g, w in zip(got, want))


def check_kernels(dev, results):
    """Phase 2: each kernel against its plain version on the card."""
    import numpy as np
    import torch
    from zkrollup_torch.fields import limbs as L
    from zkrollup_torch.fields.mont import FR, FQ
    from zkrollup_torch.fields import cuda_mont
    from zkrollup_torch.curve import cuda_curve
    from zkrollup_torch.curve.g1 import G1
    from zkrollup_torch.curve.g2 import G2
    from zkrollup_torch.native import engine

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)

    def rand_fe(n):
        """n canonical field elements (< 2^252 < p) as random limbs."""
        a = torch.randint(0, 1 << 16, (n, 16), generator=gen, device=dev,
                          dtype=torch.int32)
        a[:, 15] &= 0x0FFF
        return a

    def record(name, got, want, ms, plain_ms, bnd):
        err = max_abs_err(got, want)
        results[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                         "bound_ms": bnd[0], "bound_by": bnd[1],
                         "library_ms": None}
        log(f"  {name:13s} max_abs_err {err}  kernel {ms:.4f} ms  "
            f"plain {plain_ms:.3f} ms  bound {bnd[0]:.4f} ms ({bnd[1]})")
        if err:
            raise AssertionError(f"{name}: kernel disagrees with its plain "
                                 "version")

    # mont_mul over 2^20 lanes, edge values in the first rows (a may be any
    # value < 2^256, b any value < p); timed at the quotient's 2^17
    n = 1 << 20
    for F in (FR, FQ):
        a, b = rand_fe(n), rand_fe(n)
        edges_a = [0, 1, F.p - 1, F.r_mod_p, (1 << 256) - 1, F.p - 1]
        edges_b = [F.p - 1, F.p - 1, F.p - 1, F.r_mod_p, F.p - 1, 0]
        a[:len(edges_a)] = L.to_device(L.ints_to_limbs(edges_a), dev)
        b[:len(edges_b)] = L.to_device(L.ints_to_limbs(edges_b), dev)
        got = [F.mont_mul(a, b), F.mont_mul(a, b[3])]
        want = [cuda_mont.mont_mul_plain(F, a, b),
                cuda_mont.mont_mul_plain(F, a, b[3])]
        m = 1 << 17
        a2, b2 = a[:m].contiguous(), b[:m].contiguous()
        record(f"mont_mul[{F.name}]", got, want,
               cuda_ms(lambda: F.mont_mul(a2, b2), 50),
               cuda_ms(lambda: cuda_mont.mont_mul_plain(F, a2, b2), 3),
               lane_bound("mont_mul", m))

    # butterfly: the 17 in-place stages of an NTT over the 2^17 domain
    # (2^16 lanes each); the times are per stage, the bound is the mean
    # stage's: 2^17 rows read and written, 2^s twiddle rows read
    n = 1 << 17
    x0 = rand_fe(n)
    tws = [rand_fe(1 << s) for s in range(17)]

    def all_stages(stage, x):
        for s, tw in enumerate(tws):
            stage(FR, x, tw, 1 << s)
        return x

    stage_bytes = sum(2 * n * VALUE_BYTES + (1 << s) * VALUE_BYTES
                      for s in range(17)) / 17
    record("butterfly", [all_stages(cuda_mont.ntt_stage_, x0.clone())],
           [all_stages(cuda_mont.ntt_stage_plain_, x0.clone())],
           cuda_ms(lambda: all_stages(cuda_mont.ntt_stage_, x0.clone()),
                   20) / 17,
           cuda_ms(lambda: all_stages(cuda_mont.ntt_stage_plain_,
                                      x0.clone()), 2) / 17,
           bound(n // 2, stage_bytes))

    # curve kernels over 2^16 lanes of real points: affine tables from the
    # native fixed-base engine, Jacobian operands with Z != 1 from plain adds
    n = 1 << 16
    rng = np.random.RandomState(SEED)
    scal = [int(v) for v in rng.randint(1, 1 << 62, size=3 * n)]
    for curve, fixed_base in ((G1, engine.g1_fixed_base_mont),
                              (G2, engine.g2_fixed_base_mont)):
        x, y, inf = fixed_base(engine.ints_to_fr_bytes(scal), 3 * n)
        to_dev = lambda a: L.to_device(a, dev)
        F = curve.F
        if curve is G1:
            x, y = to_dev(x), to_dev(y)
        else:
            x, y = (to_dev(x[0]), to_dev(x[1])), (to_dev(y[0]), to_dev(y[1]))
        one = F.from_leaves([a.contiguous()
                             for a in F.leaves(F.one((3 * n,), dev))])
        aff = (x, y, one)          # Z = 1 points, three slices of n
        part = lambda k: curve.map(lambda a: a[k * n:(k + 1) * n]
                                   .contiguous(), aff)
        q = part(0)
        p = cuda_curve.add_plain(curve, part(1), part(2))   # Z != 1
        inf_pt = curve.infinity((n,), dev)
        neg_q = curve.neg(q)
        # special lanes: P + P, P + (-P), inf + Q, P + inf, inf + inf
        lanes = {0: (q, q), 1: (q, neg_q), 2: (inf_pt, q), 3: (p, inf_pt),
                 4: (inf_pt, inf_pt)}

        def with_lanes(pp, qq, cases):
            pp = curve.map(lambda a: a.clone(), pp)
            qq = curve.map(lambda a: a.clone(), qq)
            for k in cases:
                sp, sq = lanes[k]
                for d, s in zip(curve.leaves(pp), curve.leaves(sp)):
                    d[k] = s[k]
                for d, s in zip(curve.leaves(qq), curve.leaves(sq)):
                    d[k] = s[k]
            return pp, qq

        # add and madd: every special case; madd_nd: all but P + P (its
        # contract); double: p with the infinity lanes 2 and 4. Lane 0
        # (P + P) is the only lane on the doubling path of add and madd.
        pa, qa = with_lanes(p, q, (0, 1, 2, 3, 4))
        pm, qm = with_lanes(p, q, (1, 2, 3, 4))
        g = curve.name
        for name, fn, plain, args, n_dbl in (
                (f"{g}_madd_nd", cuda_curve.madd_nd,
                 cuda_curve.madd_nd_plain, (pm, qm), 0),
                (f"{g}_add", cuda_curve.add, cuda_curve.add_plain, (pa, qa),
                 1),
                (f"{g}_madd", cuda_curve.madd, cuda_curve.madd_plain,
                 (pa, qa), 1),
                (f"{g}_double", cuda_curve.double, cuda_curve.double_plain,
                 (pa,), 0)):
            record(name, curve.leaves(fn(curve, *args)),
                   curve.leaves(plain(curve, *args)),
                   cuda_ms(lambda: fn(curve, *args), 20),
                   cuda_ms(lambda: plain(curve, *args), 2),
                   lane_bound(name, n, n_dbl))

        # the double as the MSM's Horner launches it, on one lane: an
        # infinity lane (2) and a finite one (5); timed on the finite lane
        name = f"{g}_double"
        for k in (2, 5):
            one = curve.map(lambda a: a[k:k + 1].contiguous(), pa)
            if max_abs_err(curve.leaves(cuda_curve.double(curve, one)),
                           curve.leaves(cuda_curve.double_plain(curve,
                                                                one))):
                raise AssertionError(f"{name}: the one-lane kernel disagrees "
                                     f"with its plain version (lane {k})")
        ms1 = cuda_ms(lambda: cuda_curve.double(curve, one), 264)
        results[name]["one_lane_ms"] = ms1
        log(f"  {name:13s} one lane (infinity and finite): max_abs_err 0  "
            f"kernel {ms1:.4f} ms")


def same_key(a, b) -> list:
    """Names of the fields where two proving keys differ (tables compared as
    bytes with their dtypes and shapes)."""
    import numpy as np
    flat = lambda t: [np.asarray(v) for c in t
                      for v in (c if isinstance(c, tuple) else (c,))]
    bad = []
    for f in ("a_g1", "b1_g1", "c_g1", "h_g1", "b2_g2"):
        u, v = flat(getattr(a, f)), flat(getattr(b, f))
        if len(u) != len(v) or any(
                x.dtype != y.dtype or x.shape != y.shape
                or x.tobytes() != y.tobytes() for x, y in zip(u, v)):
            bad.append(f)
    for f in ("n_vars", "n_public", "domain_size", "alpha1", "beta1",
              "delta1", "beta2", "delta2", "vk", "r1cs_digest"):
        if getattr(a, f) != getattr(b, f):
            bad.append(f)
    return bad


def setup_phase(dev, launches):
    """Phase 3: the (2, 6) key on the card against setup_host's."""
    import numpy as np
    import torch
    from zkrollup_torch import kernels
    from zkrollup_torch.config import RollupConfig
    from zkrollup_torch.groth16.setup import _toxic_scalars, setup_host
    from zkrollup_torch.operator.prover import TxProver

    prover = TxProver(RollupConfig(), key_path=None, setup_seed=SETUP_SEED,
                      device=dev, c=12)
    t0 = time.time()
    r1cs = prover.structure_r1cs()
    log(f"  synthesis {time.time() - t0:.3f} s: {r1cs.n_vars} vars, "
        f"{r1cs.n_constraints} constraints, {r1cs.n_public} public")
    kernels.reset_launches()
    t0 = time.time()
    pk = prover.ensure_keys()
    torch.cuda.synchronize()
    card_s = time.time() - t0
    launches["setup"] = dict(kernels.LAUNCHES)
    t0 = time.time()
    host = setup_host(r1cs, seed=SETUP_SEED)
    host_s = time.time() - t0
    t0 = time.time()
    _toxic_scalars(r1cs, SETUP_SEED)
    scalars_s = time.time() - t0
    n_inf = int(np.asarray(pk.a_g1[2]).sum())
    log(f"  setup on {dev}: {card_s:.3f} s; setup_host (native engine): "
        f"{host_s:.3f} s; of either, the host's scalar derivation (Lagrange "
        f"evaluation at tau, timed apart): {scalars_s:.3f} s; domain "
        f"{pk.domain_size}; {n_inf} infinity rows in a_g1")
    bad = same_key(pk, host)
    if bad:
        raise AssertionError(f"card-made key differs from setup_host's: {bad}")
    log("  the two keys are equal byte for byte (tables, points, vk)")
    return prover


def proof_bytes(proof) -> bytes:
    """The proof as the verifier contract reads it: a, b, c coordinates as
    32-byte big-endian words."""
    (ax, ay), ((bx0, bx1), (by0, by1)), (cx, cy) = proof.a, proof.b, proof.c
    return b"".join(v.to_bytes(32, "big")
                    for v in (ax, ay, bx1, bx0, by1, by0, cx, cy))


def main_path(dev, prover, launches):
    """Phase 4: one BatchProcessTx(2, 6) batch through the port's prover."""
    import random
    from decimal import Decimal
    from zkrollup_torch import kernels
    from zkrollup_torch.groth16.prove import prove_host
    from zkrollup_torch.ref import eddsa
    from zkrollup_torch.ref.bn254 import R as FR_MOD
    from zkrollup_torch.tree.merkle import create_merkle_tree
    from zkrollup_torch.witness.assembler import (Transaction, format_tx,
                                                  hash_balance_tree_leaf)

    wei = lambda eth: int(Decimal(str(eth)) * 10 ** 18)
    priv_a = (3461904823869495924446136355166658661994387995314494198873459573992912434327
              % (2 ** 250))
    priv_b = (6876489714123326193969274478259787479864255376696894364275539418009183638325
              % (2 ** 250))

    cfg = prover.cfg
    pk = prover.ensure_keys()
    r1cs = prover.structure_r1cs()
    # operator state after two deposits (operator/state.py), then the two
    # signed transfers of the demo rollup (cli/main.py)
    tree = create_merkle_tree(cfg.tree_depth, cfg.tree_zero_value)
    pubs = [eddsa.gen_public_key(k) for k in (priv_a, priv_b)]
    for pub in pubs:
        leaf = {"publicKey": list(pub), "balance": wei(1.0), "nonce": 0}
        tree.insert_(hash_balance_tree_leaf(leaf), leaf)
    txs = []
    for amount, fee, nonce in ((0.1, 0.01, 1), (0.3, 0.02, 2)):
        tx = Transaction(0, 1, wei(amount), wei(fee), nonce)
        tx.signature = eddsa.sign(priv_a, format_tx(tx))
        txs.append(tx)
    prep = prover.prepare_batch(tree, txs)
    log(f"  witness {prep.witness_s:.3f} s, "
        f"{len(prep.public_signals)} public signals")

    r0, s0 = 0x1234567, 0x7654321
    kernels.reset_launches()
    t0 = time.time()
    proof = prover.prove_prepared(prep, r=r0, s=s0)
    first_s = time.time() - t0
    launches["prove"] = dict(kernels.LAUNCHES)
    log(f"  first proof on {dev} with the card-made key (self-verified): "
        f"{first_s:.3f} s {prover.stats.stages}")

    t0 = time.time()
    host = prove_host(pk, r1cs, prep.witness, r=r0, s=s0)
    log(f"  native engine proof: {time.time() - t0:.3f} s")
    if proof_bytes(proof) != proof_bytes(host):
        raise AssertionError("GPU proof differs from the native engine's")
    log(f"  proof bytes equal the native engine's: "
        f"{proof_bytes(proof).hex()[:32]}...")

    final = prep.final_tree.leaves_raw
    bal_a, nonce_a, bal_b = final[0]["balance"], final[0]["nonce"], \
        final[1]["balance"]
    log(f"  final tree: A {bal_a / 1e18} ETH nonce {nonce_a}, "
        f"B {bal_b / 1e18} ETH")
    if (bal_a, nonce_a, bal_b) != (wei(0.57), 2, wei(1.4)):
        raise AssertionError("unexpected final balances")

    rng = random.Random(SEED)
    steady = []
    for i in range(3):
        r, s = rng.randrange(1, FR_MOD), rng.randrange(1, FR_MOD)
        t0 = time.time()
        prover.prove_prepared(prep, r=r, s=s)   # raises unless it verifies
        steady.append(time.time() - t0)
        st = prover.stats
        log(f"  proof {i + 1} at random (r, s): {steady[-1]:.3f} s, "
            f"verified; stages " + ", ".join(
                f"{k} {v:.3f}" for k, v in st.stages.items())
            + f", verify {st.verify_s:.3f}")
    log(f"  steady state: {len(steady) / sum(steady):.3f} proofs/s "
        f"(prove + self-verify, witness {prep.witness_s:.3f} s apart)")
    return prep


def msm_phase(dev, pk, witness, launches):
    """Phase 5: msm(distinct=False) over the real a and b2 tables (the a
    table holds duplicate points and infinity rows) against the native
    engine's Pippenger."""
    import numpy as np
    import torch
    from zkrollup_torch import kernels
    from zkrollup_torch.curve import g1, g2
    from zkrollup_torch.fields import limbs as L
    from zkrollup_torch.msm.msm import msm
    from zkrollup_torch.native import engine
    from zkrollup_torch.ref.bn254 import R as FR_MOD

    nv = pk.n_vars
    d = lambda a: L.to_device(np.asarray(a), dev)
    ax, ay, ainf = pk.a_g1
    (bx0, bx1), (by0, by1), binf = pk.b2_g2
    a_tbl = (d(ax), d(ay), torch.from_numpy(np.asarray(ainf)).to(dev))
    b_tbl = ((d(bx0), d(bx1)), (d(by0), d(by1)),
             torch.from_numpy(np.asarray(binf)).to(dev))
    w = [v % FR_MOD for v in witness]
    sc = d(L.ints_to_limbs(w))
    xy = np.concatenate([np.asarray(ax), np.asarray(ay)], axis=1)
    live = xy[~np.asarray(ainf)[:, 0]]
    n_dup = live.shape[0] - np.unique(live, axis=0).shape[0]
    log(f"  a table: {nv} rows, {int(np.asarray(ainf).sum())} infinity, "
        f"{n_dup} duplicate points; b2 table: {nv} rows, not deduplicated")

    kernels.reset_launches()
    times = {}
    got = {}
    for name, curve, tbl in (("g1", g1.G1, a_tbl), ("g2", g2.G2, b_tbl)):
        torch.cuda.synchronize()
        t0 = time.time()
        pt = msm(curve, tbl, sc, c=12, distinct=False)
        torch.cuda.synchronize()
        times[f"msm_{name}_s"] = time.time() - t0
        mod = g1 if name == "g1" else g2
        got[name] = mod.to_affine_host(pt)[0]
    launches["msm"] = dict(kernels.LAUNCHES)

    w_bytes = engine.ints_to_fr_bytes(w)
    t0 = time.time()
    want = {"g1": engine.g1_msm_pip(engine.pack_g1_table_mont(pk.a_g1),
                                    w_bytes, nv),
            "g2": engine.g2_msm_pip(engine.pack_g2_table_mont(pk.b2_g2),
                                    w_bytes, nv)}
    host_s = time.time() - t0
    log(f"  msm(G1, a_g1, c=12, distinct=False) on {dev}: "
        f"{times['msm_g1_s']:.3f} s; msm(G2, b2_g2): {times['msm_g2_s']:.3f}"
        f" s; native engine, both: {host_s:.3f} s")
    for name in ("g1", "g2"):
        if got[name] != want[name]:
            raise AssertionError(f"{name} MSM differs from the native "
                                 "engine's")
    log("  both MSMs equal the native engine's as affine points")
    return times


def main() -> int:
    if not os.path.isdir(os.path.join(HERE, "zkrollup_torch")):
        print("chip_smoke.py: run it from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log(f"phase 0: {smi}")
    dev = torch.device("cuda", 0)

    from zkrollup_torch import kernels
    from zkrollup_torch.native import engine
    log("phase 1: build")
    t0 = time.time()
    kernels.load()
    log(f"  CUDA kernels: {time.time() - t0:.1f} s "
        f"({kernels.build_info['path']})")
    t0 = time.time()
    if not engine.available():
        raise RuntimeError("the native engine did not build (g++, native/src)")
    log(f"  native engine: {time.time() - t0:.1f} s ({engine._LIB_PATH})")

    log("phase 2: kernels against their plain versions")
    results = {}
    check_kernels(dev, results)

    launches = {}
    log("phase 3: setup on the card, BatchProcessTx(2, 6)")
    prover = setup_phase(dev, launches)

    log("phase 4: main path, BatchProcessTx(2, 6)")
    prep = main_path(dev, prover, launches)

    log("phase 5: the general MSM over the key's tables")
    msm_phase(dev, prover.pk, prep.witness, launches)

    log("phase 6: launches on each path")
    log(f"  {'kernel':13s} " + " ".join(f"{p:>7s}" for p in PATHS))
    for k in KERNELS:
        log(f"  {k:13s} " + " ".join(f"{launches[p][k]:7d}" for p in PATHS))
    missing = [(p, k) for p, ks in PATHS.items() for k in ks
               if launches[p][k] <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on their path: "
                             f"{missing}")
    loaded = [m for m, v in sys.modules.items() if v is not None and (
        m in ("jax", "zkrollup") or m.startswith(("jax.", "zkrollup.")))]
    if loaded:
        raise AssertionError(f"JAX or the zkrollup package was imported: "
                             f"{loaded[:5]}")

    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": KERNELS[k][0],
         "replaces": KERNELS[k][1],
         "launches": sum(launches[p][k] for p in PATHS),
         "launches_by_path": {p: launches[p][k] for p in PATHS},
         **results[k]} for k in KERNELS]}))
    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
