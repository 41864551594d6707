#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (zkrollup_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases; any failure raises and the script exits non-zero:
  0. the card's name and power limit; a CUDA device is required
  1. build the CUDA kernels (four nvcc processes at once, one per source of
     zkrollup_torch/csrc, with each kernel's registers and spill from the
     ptxas report) and the native host engine (g++, from native/src into
     build/native), with seconds
  2. every kernel instantiation against its plain PyTorch version on the
     card, bit for bit, at the main path's widths, with both times and the
     kernel's bound (the least time the card could take for the work);
     the double also on one lane, the width of the MSM's Horner; the six
     integer-unit kernels at the width and reps of phase 7's rate run (and
     at a small width)
  3. setup on the card: TxProver for the default BatchProcessTx(2, 6)
     config makes its key from a fixed seed with the fixed-base tables on
     the GPU (never read from a cache); setup_host makes the same key on
     the native engine; the two must be equal byte for byte
  4. the main path: two deposits, the two signed transfers of the demo
     rollup, one proof with the card-made key at pinned (r, s) that must
     self-verify and equal the native engine's proof byte for byte, the
     expected final balances, then three proofs at random (r, s), each
     self-verified
  5. the MSMs over the key's a table (with its duplicate points and
     infinity rows) and its undeduplicated b2 table, against the native
     engine's Pippenger over the same tables, as affine points: msm() with
     the default bucket strategy (the "msm" path), then with the other
     three strategies and msm_glv with two of them (the "msm_trees" path)
  6. the GLV prover with the Jacobian merge tree (TxProver(glv=True,
     tree="jacobian"), the "prove_glv" path): the batch of phase 4 at the
     same pinned (r, s), whose bytes must equal phase 4's proof and the
     native engine's, self-verified; then a second, timed proof
  7. the tools (the "tools" path): profile_alu's rates of the integer
     unit beside the documented multiply peak, and the point-kernel check
     of every G2 kernel against zkrollup_torch.ref; then (the "curve" path)
     JacobianCurve.add_nd over G1, the method that reaches g1_add_nd,
     against zkrollup_torch.ref
  8. the launch count of every kernel on each path (setup, the first proof,
     the MSMs, the strategies, the GLV proof, the tools, the G1 add_nd),
     each counted from 0 just before its path; each kernel of a path must
     launch on it
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

_CSRC = "zkrollup_torch/csrc/"
_PC = "zkrollup/curve/pallas_curve.py:"
_PC2 = "zkrollup/curve/pallas_curve_g2.py:"
# kernel -> (source, the Pallas kernel it replaces)
KERNELS = {
    "mont_mul[fr]": (_CSRC + "fields.cu", "zkrollup/fields/pallas_mont.py:211"),
    "mont_mul[fq]": (_CSRC + "fields.cu", "zkrollup/fields/pallas_mont.py:211"),
    "butterfly": (_CSRC + "fields.cu", "zkrollup/fields/pallas_mont.py:175"),
    "g1_madd_nd": (_CSRC + "g1.cu", _PC + "504"),
    "g1_add": (_CSRC + "g1.cu", _PC + "480"),
    "g2_madd_nd": (_CSRC + "g2.cu", _PC2 + "304"),
    "g2_add": (_CSRC + "g2.cu", _PC2 + "288"),
    "g1_double": (_CSRC + "g1.cu", _PC + "510"),
    "g2_double": (_CSRC + "g2.cu", _PC2 + "310"),
    "g1_madd": (_CSRC + "g1.cu", _PC + "498"),
    "g2_madd": (_CSRC + "g2.cu", _PC2 + "299"),
    "g1_add_nd": (_CSRC + "g1.cu", _PC + "492"),
    "g2_add_nd": (_CSRC + "g2.cu", _PC2 + "293"),
    "g1_add_z01": (_CSRC + "g1.cu", _PC + "486"),
    # no Pallas kernel: the XLA glue of the generic formula over Fq2
    "g2_add_z01": (_CSRC + "g2.cu", "zkrollup/curve/weierstrass.py:332"),
    **{f"alu_{op}": (_CSRC + "alu.cu", "tools/profile_vpu.py:56")
       for op in ("mul", "add", "shift_add", "f32_mul12", "mul16",
                  "umulhi")},
}

# the kernels each path must launch
PATHS = {
    "setup": ("mont_mul[fq]", "g1_madd", "g2_madd"),
    "prove": ("mont_mul[fr]", "mont_mul[fq]", "butterfly", "g1_madd_nd",
              "g1_add", "g2_madd_nd", "g2_add"),
    "msm": ("g1_madd", "g2_madd", "g1_double", "g2_double", "g1_add",
            "g2_add"),
    "msm_trees": ("mont_mul[fq]", "g1_add", "g2_add", "g1_add_z01",
                  "g2_add_z01", "g1_madd", "g1_double", "g2_double"),
    "prove_glv": ("mont_mul[fr]", "mont_mul[fq]", "butterfly", "g1_add_z01",
                  "g1_add", "g2_add_z01", "g2_add"),
    "tools": ("g2_add_nd", "g2_add_z01", "alu_mul", "alu_add",
              "alu_shift_add", "alu_f32_mul12", "alu_mul16", "alu_umulhi"),
    "curve": ("g1_add_nd",),
}

# -- the bound: the least time an H100 SXM could take for a kernel's work ---
HBM_BYTES_PER_S = 3.35e12          # device memory rate (NVIDIA data sheet)
# 32-bit integer multiply-adds: 64 per clock per SM (CUDA C++ Programming
# Guide, arithmetic instruction throughput, compute capability 9.0), 132
# SMs, 1.98 GHz maximum boost clock; the same Guide gives 64 for 32-bit
# integer add, shift and logic
INT_MULS_PER_S = 64 * 132 * 1.98e9
# 32-bit floating-point multiply: 128 per clock per SM (the same table; the
# data sheet's 67 TFLOP/s counts a multiply-add as two)
FP32_MULS_PER_S = 128 * 132 * 1.98e9
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
    "g1_add_nd": (16, 0, 9), "g2_add_nd": (44, 0, 18),
    "g1_add_z01": (6, 6, 9), "g2_add_z01": (16, 13, 18),
}
# integer-unit kernels, per lane and rep: (the op's own instructions, their
# rate); the two XORs that chain the reps, the masks and the f32 op's
# conversions are not counted. A lane reads 8 B and writes 4 B.
ALU_OPS = {
    "mul": (1, INT_MULS_PER_S), "add": (1, INT_MULS_PER_S),
    "shift_add": (2, INT_MULS_PER_S), "f32_mul12": (1, FP32_MULS_PER_S),
    "mul16": (1, INT_MULS_PER_S), "umulhi": (1, INT_MULS_PER_S),
}
ALU_LOG_N, ALU_REPS = 19, 1024      # the rate run: (16, 2^19) lanes


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


def alu_bound(op: str, n: int, reps: int):
    """The bound of alu_<op> over (16, n) lanes and reps: its own
    instructions at their documented rate against 12 B a lane."""
    count, rate = ALU_OPS[op]
    t_bytes = 16 * n * 12 / HBM_BYTES_PER_S * 1e3
    t_ops = 16 * n * reps * count / rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def ptxas_report(logs: dict) -> dict:
    """{kernel entry: (registers, spill store bytes)} from nvcc's -Xptxas -v
    output of each unit's build log."""
    import re
    out = {}
    for path in logs.values():
        with open(path) as f:
            text = f.read()
        for m in re.finditer(
                r"Compiling entry function '(\S+)'.*?(\d+) bytes spill "
                r"stores.*?Used (\d+) registers", text, re.S):
            out[m.group(1)] = (int(m.group(3)), int(m.group(2)))
    return out


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

        def with_lanes(pp, qq, cases):
            """pp, qq with the special lanes of `cases` (lane -> operands)
            written in."""
            pp = curve.map(lambda a: a.clone(), pp)
            qq = curve.map(lambda a: a.clone(), qq)
            for k, (sp, sq) in cases.items():
                for d, s in zip(curve.leaves(pp), curve.leaves(sp)):
                    d[k] = s[k]
                for d, s in zip(curve.leaves(qq), curve.leaves(sq)):
                    d[k] = s[k]
            return pp, qq

        # special lanes: 0 P + P, 1 P + (-P), 2 inf + Q, 3 P + inf,
        # 4 inf + inf. add, madd, add_nd: every case (on P + P add_nd, a
        # kernel without the doubling path, gives its own deterministic
        # result outside its contract); madd_nd: all but P + P; double: p
        # with the infinity lanes 2 and 4; add_z01: the same cases over
        # operands with Z in {0, 1} only. Lane 0 (P + P) is the only lane
        # on the doubling path of add, madd and add_z01.
        lanes = {0: (q, q), 1: (q, neg_q), 2: (inf_pt, q), 3: (p, inf_pt),
                 4: (inf_pt, inf_pt)}
        pa, qa = with_lanes(p, q, lanes)
        pm, qm = with_lanes(p, q, {k: v for k, v in lanes.items() if k})
        p01 = part(1)
        pz, qz = with_lanes(p01, q, {**lanes, 3: (p01, inf_pt)})
        g = curve.name
        for name, fn, plain, args, n_dbl in (
                (f"{g}_madd_nd", cuda_curve.madd_nd,
                 cuda_curve.madd_nd_plain, (pm, qm), 0),
                (f"{g}_add", cuda_curve.add, cuda_curve.add_plain, (pa, qa),
                 1),
                (f"{g}_madd", cuda_curve.madd, cuda_curve.madd_plain,
                 (pa, qa), 1),
                (f"{g}_double", cuda_curve.double, cuda_curve.double_plain,
                 (pa,), 0),
                (f"{g}_add_nd", cuda_curve.add_nd, cuda_curve.add_nd_plain,
                 (pa, qa), 0),
                (f"{g}_add_z01", cuda_curve.add_z01,
                 cuda_curve.add_z01_plain, (pz, qz), 1)):
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


def check_alu(dev, results):
    """Phase 2, the integer-unit kernels: each against its plain version,
    bit for bit, on the inputs of phase 7's rate run, (16, 2^ALU_LOG_N)
    and ALU_REPS (phase 7 times the kernel there), with the plain
    version's time; and at (16, 4096) and 256 reps."""
    import torch
    from zkrollup_torch.tools import profile_alu
    small = profile_alu.check(dev)
    a, b = profile_alu.inputs(1 << ALU_LOG_N, dev)
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    for op in profile_alu.OPS:
        torch.cuda.synchronize()
        e0.record()
        want = profile_alu.alu_plain(op, a, b, ALU_REPS)
        e1.record()
        torch.cuda.synchronize()
        plain_ms = e0.elapsed_time(e1)
        err = max_abs_err([profile_alu.alu(op, a, b, ALU_REPS)], [want])
        bnd = alu_bound(op, 1 << ALU_LOG_N, ALU_REPS)
        results[f"alu_{op}"] = {"max_abs_err": err, "plain_ms": plain_ms,
                                "bound_ms": bnd[0], "bound_by": bnd[1],
                                "library_ms": None}
        log(f"  alu_{op:10s} max_abs_err {err} at 16 x 2^{ALU_LOG_N}, "
            f"{ALU_REPS} reps ({small[op]} at 16 x 4096, 256 reps); plain "
            f"{plain_ms:.1f} ms, bound {bnd[0]:.4f} ms ({bnd[1]})")
        if err:
            raise AssertionError(f"alu_{op}: kernel disagrees with its plain "
                                 "version")


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
    return prep, proof_bytes(proof), (r0, s0)


def msm_phase(dev, pk, witness, launches):
    """Phase 5: the MSMs over the real a and b2 tables (the a table holds
    duplicate points and infinity rows) against the native engine's
    Pippenger: msm() with the default strategy ("msm" path), then the
    other three strategies and msm_glv ("msm_trees" path)."""
    import numpy as np
    import torch
    from zkrollup_torch import kernels
    from zkrollup_torch.curve import g1, g2
    from zkrollup_torch.fields import limbs as L
    from zkrollup_torch.msm.glv import msm_glv
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

    w_bytes = engine.ints_to_fr_bytes(w)
    t0 = time.time()
    want = {"g1": engine.g1_msm_pip(engine.pack_g1_table_mont(pk.a_g1),
                                    w_bytes, nv),
            "g2": engine.g2_msm_pip(engine.pack_g2_table_mont(pk.b2_g2),
                                    w_bytes, nv)}
    log(f"  native engine, both MSMs: {time.time() - t0:.3f} s")

    def timed(label, name, fn):
        torch.cuda.synchronize()
        t0 = time.time()
        pt = fn()
        torch.cuda.synchronize()
        secs = time.time() - t0
        got = (g1 if name == "g1" else g2).to_affine_host(pt)[0]
        log(f"  {label}: {secs:.3f} s, "
            + ("equals the native engine's" if got == want[name]
               else "DIFFERS from the native engine's"))
        if got != want[name]:
            raise AssertionError(f"{label} differs from the native engine's")
        return secs

    times = {}
    kernels.reset_launches()
    for name, curve, tbl in (("g1", g1.G1, a_tbl), ("g2", g2.G2, b_tbl)):
        times[f"msm_{name}_scan"] = timed(
            f"msm({name.upper()}, c=12, distinct=False, tree='scan')", name,
            lambda: msm(curve, tbl, sc, c=12, distinct=False))
    launches["msm"] = dict(kernels.LAUNCHES)

    kernels.reset_launches()
    for tree in ("scan1", "affine", "jacobian"):
        for name, curve, tbl in (("g1", g1.G1, a_tbl), ("g2", g2.G2, b_tbl)):
            times[f"msm_{name}_{tree}"] = timed(
                f"msm({name.upper()}, c=12, tree={tree!r})", name,
                lambda: msm(curve, tbl, sc, c=12, tree=tree))
    for tree in ("scan", "jacobian"):
        times[f"msm_glv_{tree}"] = timed(
            f"msm_glv(a_g1, c=12, tree={tree!r})", "g1",
            lambda: msm_glv(a_tbl, sc, c=12, tree=tree))
    launches["msm_trees"] = dict(kernels.LAUNCHES)
    return times


def glv_phase(dev, prover, prep, want_bytes, rs, launches):
    """Phase 6: the GLV prover with the Jacobian merge tree on the key of
    phase 3, the batch of phase 4 at its pinned (r, s)."""
    from zkrollup_torch import kernels
    from zkrollup_torch.operator.prover import TxProver

    gp = TxProver(prover.cfg, key_path=None, setup_seed=SETUP_SEED,
                  device=dev, c=12, glv=True, tree="jacobian")
    gp.pk = prover.ensure_keys()
    kernels.reset_launches()
    t0 = time.time()
    proof = gp.prove_prepared(prep, r=rs[0], s=rs[1])   # self-verifies
    first_s = time.time() - t0
    launches["prove_glv"] = dict(kernels.LAUNCHES)
    log(f"  first GLV proof (tree='jacobian', self-verified): {first_s:.3f} s"
        f"; stages " + ", ".join(f"{k} {v:.3f}"
                                 for k, v in gp.stats.stages.items()))
    if proof_bytes(proof) != want_bytes:
        raise AssertionError("the GLV proof differs from the default proof "
                             "and the native engine's")
    log("  its bytes equal the default proof's and the native engine's")
    t0 = time.time()
    gp.prove_prepared(prep, r=rs[0], s=rs[1])
    log(f"  second GLV proof: {time.time() - t0:.3f} s; stages "
        + ", ".join(f"{k} {v:.3f}" for k, v in gp.stats.stages.items())
        + f", verify {gp.stats.verify_s:.3f}")


def tools_phase(dev, results, launches):
    """Phase 7: profile_alu's rates and the point-kernel checks."""
    from zkrollup_torch import kernels
    from zkrollup_torch.tools import g2_kernel_check, profile_alu

    kernels.reset_launches()
    rates = profile_alu.rates(dev, ALU_LOG_N, ALU_REPS)
    log(f"  profile_alu: (16, 2^{ALU_LOG_N}) lanes, {ALU_REPS} reps; "
        f"documented 32-bit integer multiply peak {INT_MULS_PER_S / 1e12:.3f}"
        f" T/s (64 per clock per SM, 132 SMs, 1.98 GHz)")
    for op, r in rates.items():
        ratio = ""
        if op in ("mul", "umulhi", "mul16"):
            ratio = (f"  {r['lane_ops_per_s'] / INT_MULS_PER_S:.3f} of the "
                     "multiply peak")
        log(f"    {profile_alu.OPS[op]:40s} {r['ms']:8.4f} ms  "
            f"{r['lane_ops_per_s'] / 1e12:7.3f} T lane-ops/s{ratio}")
        results[f"alu_{op}"].update(ms=r["ms"],
                                    lane_ops_per_s=r["lane_ops_per_s"])
    g2_kernel_check.run(dev, log=lambda m: log("    " + m))
    log(f"  g2_kernel_check on {dev}: every G2 kernel equals "
        "zkrollup_torch.ref")
    launches["tools"] = dict(kernels.LAUNCHES)


def curve_path(dev, launches):
    """Phase 7, the "curve" path: JacobianCurve.add_nd over G1, the public
    method that reaches g1_add_nd, on distinct lanes, P + (-P), infinities
    and non-unit Z, against zkrollup_torch.ref."""
    from zkrollup_torch import kernels
    from zkrollup_torch.curve import g1
    from zkrollup_torch.ref import bn254 as ref

    pts = lambda ks: [None if k is None else ref.g1_mul(ref.G1_GEN, k)
                      for k in ks]
    jac = lambda ps: g1.G1.map(lambda a: a.to(dev),
                               g1.pack_jacobian_host(ps))
    p, q = pts([5, 77, None, 31, 12, None]), pts([11, 900, 31, None, None,
                                                  None])
    q[4] = ref.g1_neg(p[4])
    s1 = g1.G1.add(jac(p), jac(q))          # non-unit Z
    s2 = g1.G1.add(jac(q), jac(q))
    kernels.reset_launches()
    got = [g1.G1.add_nd(jac(p), jac(q)), g1.G1.add_nd(s1, s2)]
    launches["curve"] = dict(kernels.LAUNCHES)
    sums = [ref.g1_add(a, b) for a, b in zip(p, q)]
    want = [sums, [ref.g1_add(a, ref.g1_add(b, b)) for a, b in zip(sums, q)]]
    if [g1.to_affine_host(g) for g in got] != want:
        raise AssertionError("G1.add_nd differs from zkrollup_torch.ref")
    log(f"  G1.add_nd on {dev} (g1_add_nd), Z = 1 and non-unit Z: equals "
        "zkrollup_torch.ref")


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
    info = kernels.build_info
    log(f"  CUDA kernels: {time.time() - t0:.1f} s, {len(info['built'])} of "
        f"{len(kernels.UNITS)} units built by parallel nvcc processes "
        f"({os.path.dirname(info['paths']['fields'])})")
    for entry, (regs, spill) in sorted(ptxas_report(info["logs"]).items()):
        log(f"    {entry}: {regs} registers, {spill} bytes spill stores")
    t0 = time.time()
    if not engine.available():
        raise RuntimeError("the native engine did not build (g++, native/src)")
    log(f"  native engine: {time.time() - t0:.1f} s ({engine._LIB_PATH})")

    log("phase 2: kernels against their plain versions")
    results = {}
    check_kernels(dev, results)
    check_alu(dev, results)

    launches = {}
    log("phase 3: setup on the card, BatchProcessTx(2, 6)")
    prover = setup_phase(dev, launches)

    log("phase 4: main path, BatchProcessTx(2, 6)")
    prep, want_bytes, rs = main_path(dev, prover, launches)

    log("phase 5: the MSMs over the key's tables, four bucket strategies "
        "and GLV")
    msm_phase(dev, prover.pk, prep.witness, launches)

    log("phase 6: the GLV prover with the Jacobian merge tree, "
        "BatchProcessTx(2, 6)")
    glv_phase(dev, prover, prep, want_bytes, rs, launches)

    log("phase 7: tools")
    tools_phase(dev, results, launches)
    curve_path(dev, launches)

    log("phase 8: launches on each path")
    log(f"  {'kernel':14s} " + " ".join(f"{p:>9s}" for p in PATHS))
    for k in KERNELS:
        log(f"  {k:14s} " + " ".join(f"{launches[p][k]:9d}" for p in PATHS))
    missing = [(p, k) for p, ks in PATHS.items() for k in ks
               if launches[p][k] <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on their path: "
                             f"{missing}")
    unlaunched = [k for k in KERNELS
                  if not any(launches[p][k] for p in PATHS)]
    if unlaunched:
        raise AssertionError(f"kernels launched on no path: {unlaunched}")
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
