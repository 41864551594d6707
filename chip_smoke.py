#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (zkrollup_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases; any failure raises and the script exits non-zero:
  0. the card's name and power limit; a CUDA device is required
  1. build the CUDA kernels (nvcc, from zkrollup_torch/csrc) and the native
     host engine (make -C native), with seconds for each
  2. every kernel instantiation against its plain PyTorch version on the
     card, bit for bit, at the main path's widths, with both times
  3. the main path: TxProver for the default BatchProcessTx(2, 6) config,
     two deposits, the two signed transfers of the demo rollup, one proof
     on the GPU at pinned (r, s) that must self-verify and equal the native
     engine's proof byte for byte, the expected final balances, then three
     proofs at random (r, s), each self-verified
  4. the launch count of every kernel from the prover's construction to
     the end of its first proof, each of which must be above 0
The last two lines of standard output are one JSON object per kernel list
and one JSON object with the device; nothing is printed as a result when a
phase fails.
"""

import sys

# Nothing of JAX may load: the port and the zkrollup modules it uses are
# jax-free, and zkrollup/__init__.py skips its JAX set-up when the import
# fails.
sys.modules["jax"] = None

import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import time  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
SEED = 20261016

# kernel -> (source, the Pallas kernel it replaces)
KERNELS = {
    "mont_mul[fr]": ("zkrollup_torch/csrc/kernels.cu",
                     "zkrollup/fields/pallas_mont.py:211"),
    "mont_mul[fq]": ("zkrollup_torch/csrc/kernels.cu",
                     "zkrollup/fields/pallas_mont.py:211"),
    "butterfly": ("zkrollup_torch/csrc/kernels.cu",
                  "zkrollup/fields/pallas_mont.py:175"),
    "g1_madd_nd": ("zkrollup_torch/csrc/kernels.cu",
                   "zkrollup/curve/pallas_curve.py:504"),
    "g1_add": ("zkrollup_torch/csrc/kernels.cu",
               "zkrollup/curve/pallas_curve.py:480"),
    "g2_madd_nd": ("zkrollup_torch/csrc/kernels.cu",
                   "zkrollup/curve/pallas_curve_g2.py:304"),
    "g2_add": ("zkrollup_torch/csrc/kernels.cu",
               "zkrollup/curve/pallas_curve_g2.py:288"),
}


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, iters: int) -> float:
    """Mean milliseconds per call, CUDA events around `iters` calls after
    one warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
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
    from zkrollup.native import engine
    from zkrollup_torch.fields import limbs as L
    from zkrollup_torch.fields.mont import FR, FQ
    from zkrollup_torch.fields import cuda_mont
    from zkrollup_torch.curve import cuda_curve
    from zkrollup_torch.curve.g1 import G1
    from zkrollup_torch.curve.g2 import G2

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)

    def rand_fe(n):
        """n canonical field elements (< 2^252 < p) as random limbs."""
        a = torch.randint(0, 1 << 16, (n, 16), generator=gen, device=dev,
                          dtype=torch.int32)
        a[:, 15] &= 0x0FFF
        return a

    def record(name, got, want, ms, plain_ms):
        err = max_abs_err(got, want)
        results[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
        log(f"  {name:13s} max_abs_err {err}  kernel {ms:.4f} ms  "
            f"plain {plain_ms:.3f} ms")
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
               cuda_ms(lambda: cuda_mont.mont_mul_plain(F, a2, b2), 3))

    # butterfly: the 17 in-place stages of an NTT over the 2^17 domain
    # (2^16 lanes each); the times are per stage
    n = 1 << 17
    x0 = rand_fe(n)
    tws = [rand_fe(1 << s) for s in range(17)]

    def all_stages(stage, x):
        for s, tw in enumerate(tws):
            stage(FR, x, tw, 1 << s)
        return x

    record("butterfly", [all_stages(cuda_mont.ntt_stage_, x0.clone())],
           [all_stages(cuda_mont.ntt_stage_plain_, x0.clone())],
           cuda_ms(lambda: all_stages(cuda_mont.ntt_stage_, x0.clone()),
                   20) / 17,
           cuda_ms(lambda: all_stages(cuda_mont.ntt_stage_plain_,
                                      x0.clone()), 2) / 17)

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

        # add: every special case; madd_nd: all but P + P (its contract)
        pa, qa = with_lanes(p, q, (0, 1, 2, 3, 4))
        pm, qm = with_lanes(p, q, (1, 2, 3, 4))
        for name, fn, plain, pp, qq in (
                (f"{curve.name}_madd_nd", cuda_curve.madd_nd,
                 cuda_curve.madd_nd_plain, pm, qm),
                (f"{curve.name}_add", cuda_curve.add, cuda_curve.add_plain,
                 pa, qa)):
            record(name, curve.leaves(fn(curve, pp, qq)),
                   curve.leaves(plain(curve, pp, qq)),
                   cuda_ms(lambda: fn(curve, pp, qq), 20),
                   cuda_ms(lambda: plain(curve, pp, qq), 2))


def proof_bytes(proof) -> bytes:
    """The proof as the verifier contract reads it: a, b, c coordinates as
    32-byte big-endian words."""
    (ax, ay), ((bx0, bx1), (by0, by1)), (cx, cy) = proof.a, proof.b, proof.c
    return b"".join(v.to_bytes(32, "big")
                    for v in (ax, ay, bx1, bx0, by1, by0, cx, cy))


def main_path(dev):
    """Phase 3: one BatchProcessTx(2, 6) batch through the port's prover."""
    import random
    from decimal import Decimal
    from zkrollup.config import RollupConfig
    from zkrollup.ref import eddsa
    from zkrollup.ref.bn254 import R as FR_MOD
    from zkrollup.tree.merkle import create_merkle_tree
    from zkrollup.witness.assembler import (Transaction, format_tx,
                                            hash_balance_tree_leaf)
    from zkrollup_torch import kernels
    from zkrollup_torch.groth16.prove import prove_host
    from zkrollup_torch.operator.prover import TxProver

    wei = lambda eth: int(Decimal(str(eth)) * 10 ** 18)
    priv_a = (3461904823869495924446136355166658661994387995314494198873459573992912434327
              % (2 ** 250))
    priv_b = (6876489714123326193969274478259787479864255376696894364275539418009183638325
              % (2 ** 250))

    cfg = RollupConfig()
    key_path = os.path.join(HERE, "build", "keys",
                            f"tx_{cfg.batch_size}_{cfg.tree_depth}.npz")
    kernels.reset_launches()
    prover = TxProver(cfg, key_path=key_path, setup_seed=b"chip-smoke",
                      device=dev, c=12)
    t0 = time.time()
    pk = prover.ensure_keys()
    r1cs = prover.structure_r1cs()
    log(f"  keys ready in {time.time() - t0:.1f} s: {r1cs.n_vars} vars, "
        f"{r1cs.n_constraints} constraints, {r1cs.n_public} public, "
        f"domain {pk.domain_size}")

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
    t0 = time.time()
    proof = prover.prove_prepared(prep, r=r0, s=s0)
    first_s = time.time() - t0
    launches = dict(kernels.LAUNCHES)
    log(f"  first proof on {dev} (self-verified): {first_s:.3f} s "
        f"{prover.stats.stages}")

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
    return launches


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
    from zkrollup.native import engine
    log("phase 1: build")
    t0 = time.time()
    kernels.load()
    log(f"  CUDA kernels: {time.time() - t0:.1f} s "
        f"({kernels.build_info['path']})")
    t0 = time.time()
    if not engine.available():
        raise RuntimeError("the native engine did not build (make -C native)")
    log(f"  native engine: {time.time() - t0:.1f} s")

    log("phase 2: kernels against their plain versions")
    results = {}
    check_kernels(dev, results)

    log("phase 3: main path, BatchProcessTx(2, 6)")
    launches = main_path(dev)

    log("phase 4: launches in the main path up to its first proof")
    for name, count in launches.items():
        log(f"  {name:13s} {count}")
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: "
                             f"{missing}")
    if any(m == "jax" or m.startswith("jax.") for m in sys.modules
           if sys.modules[m] is not None):
        raise AssertionError("JAX was imported")

    log(smi)
    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": KERNELS[k][0],
         "replaces": KERNELS[k][1], "launches": launches[k],
         **results[k]} for k in KERNELS]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
