#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (zkrollup_torch) on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --ab CSRC [--ab CSRC ...]

Phases; any failure raises and the script exits non-zero:
  0. the card's name and power limit; a CUDA device is required
  1. build the CUDA kernels (five nvcc processes at once, one per source of
     zkrollup_torch/csrc, with each kernel's registers, spill and stack
     frame from the ptxas report; the eleven point kernels with launch
     bounds, g1_add, g1_madd_nd, g1_madd, g1_add_z01, g1_add_nd, g2_add,
     g2_madd_nd, g2_madd, g2_double, g2_add_z01 and g2_add_nd, and the two
     Horner kernels must not spill,
     six logged
     beside their registers before the unified add was factored out of
     its lane) and the native host engine (g++, from native/src into
     build/native), with seconds
  2. every kernel instantiation against its plain PyTorch version on the
     card, bit for bit, at the main path's widths, with both times and the
     kernel's bound (the least time the card could take for the work);
     the NTT pass on whole 2^17 transforms (forward, inverse, with pre and
     post tables, with the quotient's plain-form post and pointwise
     prologue, a batch of three) and as 17 one-stage passes, each pass and
     the quotient timed; the fold on 2^17 rows with its edge rows; the
     gathered mont_mul at 164,215 lanes and mont_mul at the witness's
     117,114; the inversion kernels (inv[fq], inv[fq2]) against their plain
     versions and against the route of one mont_mul launch a product
     (inv_loop), at the setup's widths (482,413 Fq lanes, 117,114 Fq2) and
     2^17, on ragged launches of 1, 22, 33 and 1,025 lanes and one finite
     lane, with 0, 1, q - 1, R mod q and zero lanes first, in the middle
     and last of a thread's lanes, and every lane of a thread zero, timed
     (device and wall ms) beside the bound of the function's own work,
     the kernel's own product count and inv_loop, also on one lane;
     the doubles (g2_double on thread pairs) also on ragged launches of
     1, 22 and 33 lanes at two offsets, of 1,025 lanes and on one lane
     (timed); the Horner kernels (g1_horner, g2_horner: the MSM's whole
     combine in one launch) against horner_plain and against the route of
     one double or add launch a step (horner_loop), Jacobian limbs, on
     the msm's 22 windows at c = 12, on 1, 2 and 11 windows, at small c,
     with infinity windows, on the add's doubling path and on P + (-P);
     both routes timed there, device ms and wall ms, beside the bound and
     the latency bound of the chain on one warp; the four
     point kernels of PROVE_SHAPES (g1_madd_nd, g1_add, g2_madd_nd,
     g2_add) also at the prove path's lanes per launch (timed there beside
     the bound at that width; the G1 two also at WAVE_LANES), the two of
     SETUP_SHAPES (g1_madd, g2_madd) also at the setup's lanes per launch
     and the msm paths' (timed there) and on the warp-vote cases (a warp
     of distinct pairs with one P + P lane, a warp of infinity + infinity,
     ragged launches of 33 and 1,025 lanes with P + P in the last warp),
     all six on ragged launches of 1, 22 and 33 lanes and on one lane
     (timed); the z01 adds (g1_add_z01 over the called Fq product,
     g2_add_z01 on thread pairs) also at the msm_trees leaf level's
     1,441,792 lanes (timed there), on the warp-vote cases and on ragged
     launches; the vote cases also with a P + (-P) lane; the adds without
     a doubling path (g1_add_nd over the called Fq product, g2_add_nd on
     thread pairs) on ragged launches of 1, 22, 33 and 1,025 lanes and on
     one lane, their H = 0 lanes (P + P, P + (-P)) and infinity operands
     among them; the eight
     integer-unit kernels (the TPU tool's body over six ops, and two
     multiply-only chains) at the width and reps of phase 7's rate run
     (and at a small width), each bound by its loop's instructions by class
     as cuobjdump -sass shows them; the field add and sub (add[fr],
     sub[fr], add[fq], sub[fq]) at 2^17 lanes with edge rows and at the
     paths' 117,114, on ragged launches of 1, 22, 33 and 1,025 lanes and
     with either operand one broadcast row, timed at both widths beside
     the bound; the MiMC sponge (mimc_sponge[fr], the whole multi-hash of a
     lane in one launch) at 2^17 pairs against its plain version (the
     reference's loop over the plain product and add, timed) and the
     native engine, at 2^17 four-wide rows against the engine, on ragged
     launches of 1, 22, 33 and 1,025 lanes of four inputs under a key a
     lane and a broadcast key, timed at both widths beside the bound and
     one lane's latency bound, and beside the route of a mont_mul[fr] and
     an add[fr] launch a step (mimc_loop), timed
  3. setup on the card: TxProver for the default BatchProcessTx(2, 6)
     config makes its key from a fixed seed with the fixed-base tables on
     the GPU (never read from a cache); setup_host makes the same key on
     the native engine; the two must be equal byte for byte; the setup
     path's widest launches of g1_madd and g2_madd must be SETUP_SHAPES,
     32 each, mont_mul[fq] at most 16, inv[fq] and inv[fq2] once each;
     its peak device memory; then
     the setup in parts on the host clock (the scalar derivation, the
     window tables, the scalars' encoding, each table's fixed-base loop and
     normalisation, the copies back, _key), whose key must be the same,
     and the G2 normalisation timed again with FieldCtx.add / sub on their
     carry loop (carry_loop_route), in turns; limbs.normalize on CUDA
     tensors never, on the setup and in its parts
  4. the main path: two deposits, the two signed transfers of the demo
     rollup, one proof with the card-made key at pinned (r, s) that must
     self-verify and equal the native engine's proof byte for byte (the
     calls of limbs.normalize on CUDA tensors counted), the expected final
     balances, the same batch through TxProver.prove_batch (the same
     bytes), then three proofs at random (r, s), each self-verified (the
     steady proofs/s, with no stage syncs), two prove(timings=) calls for
     the stage seconds, one steady proof under torch.profiler (device busy
     share, device time by kernel name and by stage label, each kernel
     attributed by correlation id to the label open at its launch; the
     four labels in the reference's order, each kernel of LABEL_KERNELS
     that launched under its label; peak memory) and evals_quotient's
     parts on the host clock, and two proofs with g2_backend="host" (the
     G2 MSM on the native engine beside the card's G1 work; the same
     bytes); then one more proof at the pinned (r, s) whose G1 add
     and madd_nd operands are kept (cuda_curve's wrappers are wrapped in
     this script for that proof only): for each g1_add launch the share of
     lanes and of 32-lane warps on the doubling path, then g1_add at its
     two widest launches and g1_madd_nd at one launch, on those operands,
     bit for bit against the plain versions and timed beside the bound
  5. the MSMs over the key's a table (with its duplicate points and
     infinity rows) and its undeduplicated b2 table, against the native
     engine's Pippenger over the same tables, as affine points: msm() with
     the default bucket strategy (the "msm" path), then with the other
     three strategies and msm_glv with two of them (the "msm_trees" path);
     on each table's window sums the Horner kernel equals horner_loop limb
     for limb, and msm() is timed with the Horner kernel and with the
     window sums and horner_loop, in turns; msm(tree="affine") is timed
     with the inversion kernel and with the route before it (the product
     tree, its root by inv_loop), in turns, each equal to the native engine,
     and with FieldCtx.add / sub on their carry loop (carry_loop_route), in
     turns; limbs.normalize on CUDA tensors never on the two paths
  6. the GLV prover with the Jacobian merge tree (TxProver(glv=True,
     tree="jacobian"), the "prove_glv" path): the batch of phase 4 at the
     same pinned (r, s), whose bytes must equal phase 4's proof and the
     native engine's, self-verified; then a second, timed proof
  7. the tools (the "tools" path): profile_alu's rates of the integer
     unit beside the documented multiply peak and each kernel's bound, and
     the point-kernel check
     of every G2 kernel against zkrollup_torch.ref; then (the "curve" path)
     JacobianCurve.add_nd and double over G1, the methods that reach
     g1_add_nd and g1_double, against zkrollup_torch.ref; then (the
     "measure" path) the measurement tools once each at the reference's
     sizes, every result held: trace_prove (the (2,6) demo batch, its
     device time by label), prove_breakdown (the stages' proof equal to
     prove()'s), profile_msm and profile_msm2 (2^17 tiled and distinct
     points, the four prove-shaped tables) and msm_sweep (c 11-13 x chunk
     64-256) against the native engine, profile_kernels (2^20) against
     the plain versions; and mesh_prove_check on the withdraw circuit
     over a virtual mesh of four in a process of its own, which must
     print MESH WITHDRAW OK. After phases 4-7 and 9 a profiler check
     counts the device events of one aten op and one ctypes launch
  8. the launch count and the lanes of every kernel on each path (setup,
     the first proof, the MSMs, the strategies, the GLV proof, the tools,
     the G1 add_nd, the measurement tools), each counted from 0 just
     before its path; each kernel
     of a path must launch on it; on prove ntt_pass and mont_mul[fr] at most
     six times, fold[fr] eight times, mont_mul[fq] at most five times,
     limbs.normalize on CUDA tensors never; on the msm paths one Horner a
     msm() call and no double, on "msm" 34 adds a curve, and on
     "msm_trees" mont_mul[fq] and the inversions within MSM_LIMITS
  9. the operator loop through the port's entry points (the "operator"
     path): `python -m zkrollup_torch.cli demo-rollup` in-process on the
     card with phase 3's key cached in a temporary --keys-dir (the
     contract's balances A 0.57 ETH nonce 2, B 1.4 ETH, fees 0.03); the
     batch daemon's run_pipeline (its witness stage in a spawned worker
     process) over four sends (two batches, the warm run), the same
     batches through step() on a daemon of its own, then run_pipeline and
     step() in turns (pipeline, step, step, pipeline), eight batches a
     timed run, against the contract's balances and root, with the median
     batches/s of each and each batch's assemble, synth, prove and verify
     seconds; the HTTP service on a
     free port (deposits, sends, /admin/prove-batch proving on a server
     thread, the users' balances). Then the withdraw circuit (the
     "withdraw" path): WithdrawProver's key made on the card, equal to
     setup_host's byte for byte; a withdraw proof at pinned (r, s), equal
     to the native engine's; that key as snarkjs JSON and as the websnark
     binary, each loaded back and proving the same bytes on the card, its
     verifying key and the proof through snarkjs JSON; the proof paid out
     by the contract once and refused on
     nullifier reuse, with its launches and lanes; `demo-withdraw` through
     the CLI. Each kernel of the two paths must launch on it
 10. the bulk MiMC tree (the "mimc" path, one mimc_sponge[fr] launch a
     level or a batch): merkle_level_up over 2^17 pairs, bit for bit
     against the native
     engine; bulk.from_leaves over a depth-18 tree at its capacity (2^17 - 1
     leaves), its root and caches against the engine's levels;
     multi_hash_rows over 2^17 four-wide rows against the engine;
     TreeStore.verify_integrity on that tree, True, then False after a
     corrupted leaf hash; the level timed (host clock, CUDA events,
     hashes/s beside the engine's one-core rate) in turns with mimc_loop
     on the add and sub kernels and on the carry loop (the route before
     both kernels), profiled; limbs.normalize on CUDA tensors never on the
     path nor in the profiled level
 11. the multi-device prover on a virtual mesh of DIST_SHARDS shards of
     the card (the "dist" path, zkrollup_torch/dist): prove(mesh=) of
     phase 4's batch at the pinned (r, s), with table_groups 1 and 2, each
     self-verified and equal to phase 4's bytes, timed beside
     prove(device=); the sharded NTT of 2^17 rows forward and inverse
     against ntt.transform; sharded_msm_g1 / g2 over the key's a and b2
     tables against the native engine; the path's launches and lanes,
     limbs.normalize on CUDA tensors never; the steady mesh proof timed
     again with FieldCtx.add / sub on their carry loop (carry_loop_route),
     in turns; then tools/multihost_sim.py (two processes,
     gloo, two shards each on the card), which must print MULTIHOST OK
The last three lines of standard output are one JSON object with the kernel
list, the card's name and power limit, and one JSON object with the device;
nothing is printed as a result when a phase fails.

With --ab, phases 0 and 1 only, then the point kernels of PROVE_SHAPES
and SETUP_SHAPES, the doubles, the Horner kernels, the z01 adds, the nd
adds and the inversion kernels (where CSRC has them; each of AB_KERNELS once, checked
by check_ab_cases) of this checkout against those built from each CSRC
directory (another commit's zkrollup_torch/csrc unpacked with `git
archive`, or an edited copy of this one's), on phase 2's operands and on
one proof's own,
and the field route (a 2^17 transform, the quotient, the fold, mont_mul at
its prove widths) against each CSRC's fields.cu, through the stage-by-stage
route where it has the earlier C interface (one butterfly launch a stage, as
at commit cea5215): see ab_run and ab_fields. The last line is then
one JSON object with the times.
"""

import sys

# Nothing of JAX and nothing of the zkrollup package may load: the port
# carries its own copies of the jax-free modules it needs.
sys.modules["jax"] = None
sys.modules["zkrollup"] = None

import collections  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import time  # noqa: E402
from decimal import Decimal  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
SEED = 20261016
SETUP_SEED = b"chip-smoke"
PINNED_RS = (0x1234567, 0x7654321)   # (r, s) of the proofs held to bytes

_CSRC = "zkrollup_torch/csrc/"
_PC = "zkrollup/curve/pallas_curve.py:"
_PC2 = "zkrollup/curve/pallas_curve_g2.py:"
# kernel -> (source, the Pallas kernel it replaces)
KERNELS = {
    "mont_mul[fr]": (_CSRC + "fields.cu", "zkrollup/fields/pallas_mont.py:211"),
    "mont_mul[fq]": (_CSRC + "fields.cu", "zkrollup/fields/pallas_mont.py:211"),
    "ntt_pass": (_CSRC + "fields.cu", "zkrollup/fields/pallas_mont.py:175"),
    # no Pallas kernel: the XLA glue of the spmv's carry pass and fold
    "fold[fr]": (_CSRC + "fields.cu", "zkrollup/groth16/prove.py:54"),
    # no Pallas kernel: the Fermat inversion, a chain of mont_mul
    # (mont_pow_const; over Fq2 through the norm, zkrollup/fields/fq2.py:51)
    "inv[fq]": (_CSRC + "fields.cu", "zkrollup/fields/mont.py:159"),
    "inv[fq2]": (_CSRC + "fields.cu", "zkrollup/fields/mont.py:159"),
    # no Pallas kernel: FieldCtx.add / sub, lax.scan carry chains inside
    # the traced program
    "add[fr]": (_CSRC + "fields.cu", "zkrollup/fields/mont.py:71"),
    "sub[fr]": (_CSRC + "fields.cu", "zkrollup/fields/mont.py:76"),
    "add[fq]": (_CSRC + "fields.cu", "zkrollup/fields/mont.py:71"),
    "sub[fq]": (_CSRC + "fields.cu", "zkrollup/fields/mont.py:76"),
    # no Pallas kernel: the sponge's 220-round lax.scan
    # (mimc_jax.py:41 permute_mont) inside multi_hash_mont
    "mimc_sponge[fr]": (_CSRC + "mimc.cu", "zkrollup/hash/mimc_jax.py:64"),
    "g1_madd_nd": (_CSRC + "g1.cu", _PC + "504"),
    "g1_add": (_CSRC + "g1.cu", _PC + "480"),
    "g2_madd_nd": (_CSRC + "g2.cu", _PC2 + "304"),
    "g2_add": (_CSRC + "g2.cu", _PC2 + "288"),
    "g1_double": (_CSRC + "g1.cu", _PC + "510"),
    "g2_double": (_CSRC + "g2.cu", _PC2 + "310"),
    # the device Horner of the reference's msm: a fori_loop of the double
    # and add kernels on one point, one launch here
    "g1_horner": (_CSRC + "g1.cu", "zkrollup/msm/msm.py:651"),
    "g2_horner": (_CSRC + "g2.cu", "zkrollup/msm/msm.py:651"),
    "g1_madd": (_CSRC + "g1.cu", _PC + "498"),
    "g2_madd": (_CSRC + "g2.cu", _PC2 + "299"),
    "g1_add_nd": (_CSRC + "g1.cu", _PC + "492"),
    "g2_add_nd": (_CSRC + "g2.cu", _PC2 + "293"),
    "g1_add_z01": (_CSRC + "g1.cu", _PC + "486"),
    # no Pallas kernel: the XLA glue of the generic formula over Fq2
    "g2_add_z01": (_CSRC + "g2.cu", "zkrollup/curve/weierstrass.py:332"),
    # the TPU tool's body over six ops, and beside it the multiply-only
    # bodies of the same tool (alu_mad_lo, alu_mad_hi)
    **{f"alu_{op}": (_CSRC + "alu.cu", "tools/profile_vpu.py:56")
       for op in ("mul", "add", "shift_add", "f32_mul12", "mul16",
                  "umulhi", "mad_lo", "mad_hi")},
}

# the kernels each path must launch
PATHS = {
    "setup": ("mont_mul[fq]", "inv[fq]", "inv[fq2]", "g1_madd", "g2_madd",
              "add[fq]", "sub[fq]"),
    "prove": ("mont_mul[fr]", "mont_mul[fq]", "ntt_pass", "fold[fr]",
              "g1_madd_nd", "g1_add", "g2_madd_nd", "g2_add"),
    "msm": ("g1_madd", "g2_madd", "g1_horner", "g2_horner", "g1_add",
            "g2_add"),
    "msm_trees": ("mont_mul[fq]", "inv[fq]", "inv[fq2]", "g1_add", "g2_add",
                  "g1_add_z01", "g2_add_z01", "g1_madd", "g1_horner",
                  "g2_horner", "add[fq]", "sub[fq]"),
    "prove_glv": ("mont_mul[fr]", "mont_mul[fq]", "ntt_pass", "fold[fr]",
                  "g1_add_z01", "g1_add", "g2_add_z01", "g2_add"),
    "tools": ("g2_add_nd", "g2_add_z01", "alu_mul", "alu_add",
              "alu_shift_add", "alu_f32_mul12", "alu_mul16", "alu_umulhi",
              "alu_mad_lo", "alu_mad_hi"),
    # phase 7: the measurement tools in this process (trace_prove and
    # prove_breakdown prove; profile_msm's msm() over tiled points takes
    # the mixed add and the Horner kernel; profile_msm2's distinct points
    # come from the fixed base, normalised by one inversion)
    "measure": ("mont_mul[fr]", "mont_mul[fq]", "ntt_pass", "fold[fr]",
                "g1_madd_nd", "g1_add", "g2_madd_nd", "g2_add", "g1_madd",
                "g1_horner", "inv[fq]"),
    "curve": ("g1_add_nd", "g1_double"),
    # phase 9: the operator loop's proofs (demo-rollup, the daemon, the
    # HTTP service) with phase 3's key; the withdraw circuit's setup and
    # proofs
    "operator": ("mont_mul[fr]", "mont_mul[fq]", "ntt_pass", "fold[fr]",
                 "g1_madd_nd", "g1_add", "g2_madd_nd", "g2_add"),
    "withdraw": ("mont_mul[fr]", "mont_mul[fq]", "ntt_pass", "fold[fr]",
                 "g1_madd_nd", "g1_add", "g2_madd_nd", "g2_add", "g1_madd",
                 "g2_madd", "inv[fq]", "inv[fq2]", "add[fq]", "sub[fq]"),
    # phase 10: the bulk MiMC tree (hash/mimc.py, tree/bulk.py), one
    # sponge launch a level or a batch
    "mimc": ("mimc_sponge[fr]",),
    # phase 11: the multi-device prover on a virtual mesh (dist/): the
    # evaluations, the sharded quotient (the local NTTs, the D-point DFT's
    # products), each shard's window sums (distinct=False), the fold, the
    # host combine's from_mont, and sharded_msm_g1 / g2's Horner; the
    # D-point sums on add[fr], the quotient's pointwise step on sub[fr]
    "dist": ("mont_mul[fr]", "mont_mul[fq]", "ntt_pass", "fold[fr]",
             "g1_madd", "g1_add", "g2_madd", "g2_add", "g1_horner",
             "g2_horner", "add[fr]", "sub[fr]"),
}
# the paths phase 9 drives, phase 10's and phase 11's; phase 8 checks the
# others
LOOP_PATHS = ("operator", "withdraw")
MIMC_PATHS = ("mimc",)
DIST_PATHS = ("dist",)

# -- the bound: the least time an H100 SXM could take for a kernel's work ---
HBM_BYTES_PER_S = 3.35e12          # device memory rate (NVIDIA data sheet)
# 32-bit integer multiply-adds: 64 per clock per SM (CUDA C++ Programming
# Guide, arithmetic instruction throughput, compute capability 9.0), 132
# SMs, 1.98 GHz maximum boost clock; the same Guide gives 64 for 32-bit
# integer add, shift and logic
CLOCK_HZ = 1.98e9
INT_MULS_PER_S = 64 * 132 * CLOCK_HZ
# one warp on an SM sub-partition, which issues 16 multiplies a clock:
# one warp-wide multiply every 2 clocks (the latency bound of a chain)
WARP_MUL_CLOCKS = 2
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
# The integer-unit kernels are bounded by their whole body per lane and
# rep, the TPU tool's op and the two XORs that chain its reps, or the
# multiply of a chain, and the loop's counter: the instructions of each
# kernel's loop by class, read from the build (profile_alu.sass_counts,
# cuobjdump -sass), each class at its CC 9.0 throughput and all of them at
# the issue rate (profile_alu.issue_clocks). A lane reads 8 B and writes
# 4 B.
ALU_LOG_N, ALU_REPS = 19, 1024      # the rate run: (16, 2^19) lanes
# the (2,6) proof's domain, its witness rows, and the gathered spmv
# products: the mean mont_mul[fr] width on prove of the stage-by-stage
# route (31 launches), and the widest
# product (the A matrix's 735,774 terms)
DOMAIN_LOG = 17
WITNESS_ROWS = 117_114
GATHER_LANES = 164_215
GATHER_WIDEST = 735_774
# launches on the prove path (phase 8): at most six NTT passes (the
# quotient's three transforms, two passes each) and six mont_mul[fr] (the
# witness's to_mont and the three gathered spmv products); exactly eight
# folds (the three spmv rows, the four G1 tables' merged scalars, G2's);
# at most five mont_mul[fq] (one from_mont a curve's window sums, and the
# negations of the table-end subtraction, one for G1 and two for G2)
PROVE_LIMITS = {"ntt_pass": (1, 6), "mont_mul[fr]": (1, 6),
                "fold[fr]": (8, 8), "mont_mul[fq]": (1, 5)}
# lanes per launch of the MSMs' point kernels on the prove path, the widest
# of each (c = 12: 22 windows, chunks of 128 points). G1, the four a, b1,
# c and h tables as one MSM of 3,386 chunks and 4 x 4,096 buckets: the
# scan leg's 22 x 3,386 lanes; the boundary add over 22 x 4 x 4,096 and
# the table-end subtraction over 22 x 4 x 4,095 lanes. G2, the b2 table
# (74,325 points padded to 2^17): 22 x 1,024; 22 x 4,096 and 22 x 4,095.
PROVE_SHAPES = {"g1_madd_nd": (74_492,), "g1_add": (360_448, 360_360),
                "g2_madd_nd": (22_528,), "g2_add": (90_112, 90_090)}
# one wave of the one-thread G1 kernels at 16 warps an SM: 132 x 512 lanes
WAVE_LANES = 67_584
RAGGED = (1, 22, 33)
# lanes per launch of the setup's fixed-base steps (32 a table, one chunk
# a table: msm/fixed_base.py): the (2,6) key's five G1 tables as one,
# 482,413 scalars, and its b2 table's 117,114; phase 3 fails unless they
# are the widest launches of these kernels on the setup path. The msm
# paths launch the same kernels at MSM_MADD_LANES (22 windows x 1,024
# chunks of the scan leg).
SETUP_SHAPES = {"g1_madd": (482_413,), "g2_madd": (117_114,)}
MSM_MADD_LANES = 22_528
# launches on the setup path (phase 3): 32 fixed-base steps a table; the
# normalisation once a table: one inversion (inv[fq], inv[fq2]) and its
# products (mont_mul[fq]: 4 for G1, 11 for G2)
SETUP_LIMITS = {"g1_madd": (32, 32), "g2_madd": (32, 32),
                "mont_mul[fq]": (1, 16), "inv[fq]": (1, 1),
                "inv[fq2]": (1, 1)}
# the widths of g2_add_z01 phase 2 holds it at beyond 2^16 lanes: the
# Jacobian merge tree's leaf level on the msm paths (22 windows x 2^16
# lanes, the b2 table padded to 2^17 pairs)
Z01_SHAPES = {"g1_add_z01": (1_441_792,), "g2_add_z01": (1_441_792,)}
# point kernels without a doubling path that phase 2 holds on ragged
# launches and one lane beyond 2^16 lanes (no warp vote)
ND_SHAPES = {"g1_add_nd": (), "g2_add_nd": ()}
# the inversion kernels in phase 2: the widest launch (the setup's G1
# table; 2^17 for Fq2, its table 117,114 a slice of it), the other
# widths as slices of its operand, and ragged launches
INV_SHAPES = {"inv[fq]": (482_413, 1 << 17), "inv[fq2]": (1 << 17, 117_114)}
INV_RAGGED = (1, 22, 33, 1025)
# the add and sub kernels in phase 2: 2^17 lanes (edge rows first), the
# paths' 117,114 (the setup's G2 table and the mesh's padded rows) as a
# slice, and ragged launches
ADD_SUB_WIDTHS = (1 << 17, 117_114)
ADD_SUB_RAGGED = (1, 22, 33, 1025)
# mimc_sponge[fr] in phase 2 and 10: the Fr products a lane does, 3 a
# round, 220 rounds an input
MIMC_PRODUCTS_PER_INPUT = 3 * 220
# the kernels --ab holds against the builds of other csrc/ (ab_run)
AB_KERNELS = (*PROVE_SHAPES, *SETUP_SHAPES, "g1_double", "g2_double",
              "g1_horner", "g2_horner", *Z01_SHAPES, *ND_SHAPES,
              *INV_SHAPES)
# the Fermat chain of q - 2 in the inversion kernel: 253 squares, 109
# products
INV_CHAIN = 362
# lanes a warp holds: one thread a G1 lane, two a G2 lane (thread pairs)
WARP_LANES = {"g1": 32, "g2": 16}
VOTE_CASES = ("one_p_plus_p", "one_p_minus_p", "inf_plus_inf", "ragged_33",
              "ragged_1025")
# kernel entries with launch bounds of (threads a block, blocks an SM)
# (csrc/g1.cu, csrc/points.cuh's PAIR_MIN_BLOCKS; the Horner kernels one
# warp and no minimum); phase 1 fails if one of them is missing from the
# ptxas report, spills, or takes more registers than those blocks leave
LAUNCH_BOUNDS = {"g1_add_kernel": (128, 3), "g1_madd_nd_kernel": (128, 4),
                 "g1_madd_kernel": (128, 3), "jac_add_pair_kernel": (128, 3),
                 "jac_madd_nd_pair_kernel": (128, 3),
                 "jac_madd_pair_kernel": (128, 3),
                 "jac_double_pair_kernel": (128, 3),
                 "jac_add_z01_pair_kernel": (128, 3),
                 "jac_add_nd_pair_kernel": (128, 3),
                 "g1_add_z01_kernel": (128, 3),
                 "g1_add_nd_kernel": (128, 3),
                 "g1_horner_kernel": (32, 1), "g2_horner_kernel": (32, 1),
                 "mimc_sponge_kernel": (128, 1)}
# ptxas registers of the kernels built before the unified add was factored
# out of its lane for the Horner (CUDA 12.8, sm_90a), which that must not
# change; phase 1 logs them beside this build's
EARLIER_REGS = {"g1_add_kernel": 149, "g1_madd_nd_kernel": 124,
                "g1_madd_kernel": 139, "jac_add_pair_kernel": 168,
                "jac_madd_nd_pair_kernel": 150, "jac_madd_pair_kernel": 168}
# the g1_madd_nd launch of a proof whose operands phase 4 keeps: the middle
# step of the scan leg's 127 (the accumulator a sum of 64 points)
MADD_ND_KEPT = 63
# the Horner of one msm() over 256-bit scalars at c = 12: 22 windows
HORNER_W, HORNER_C = 22, 12
# launches on the msm paths (phase 8): one Horner a msm() call (the "msm"
# path one a curve, "msm_trees" three: its msm_glv calls combine on the
# host), no double; on "msm" the scan route's 34 adds a curve (the halving
# reduce, the chunk-total scan, the boundary add and the table-end
# subtraction), where the one-lane Horner route added 22 more; on
# "msm_trees" at most the counts of the (2,6) key's tables: one inversion
# a level of the affine tree (17 levels a curve) and 243 mont_mul[fq]
# (the affine adds' products, 4 a level over G1 and 10 over G2, and the
# GLV tables' and negations'), where the 362-launch Fermat chain a level
# made 15,288
MSM_LIMITS = {
    "msm": {"g1_horner": (1, 1), "g2_horner": (1, 1), "g1_double": (0, 0),
            "g2_double": (0, 0), "g1_add": (34, 34), "g2_add": (34, 34)},
    "msm_trees": {"g1_horner": (3, 3), "g2_horner": (3, 3),
                  "g1_double": (0, 0), "g2_double": (0, 0),
                  "mont_mul[fq]": (1, 243), "inv[fq]": (1, 17),
                  "inv[fq2]": (1, 17)},
    # profile_msm's four msm() calls (a first and three steady) one Horner
    # each; every other MSM of the tools combines on the host
    "measure": {"g1_horner": (4, 4), "g2_horner": (0, 0),
                "g1_double": (0, 0), "g2_double": (0, 0)},
}
# phase 4: the kernels each stage label of prove() launches, by kernel
# symbol; the profiled proof fails unless each that launched during it is
# attributed to its label
LABEL_KERNELS = {
    "groth16.spmv_abc": {"mont_mul[fr]": "mont_mul_kernel",
                         "fold[fr]": "fold_fr_kernel"},
    "groth16.quotient": {"ntt_pass": "ntt_pass_kernel"},
    "groth16.msm_g1": {"g1_madd_nd": "g1_madd_nd_kernel",
                       "g1_add": "g1_add_kernel"},
    "groth16.msm_g2": {"g2_madd_nd": "jac_madd_nd_pair_kernel",
                       "g2_add": "jac_add_pair_kernel"},
}
# phase 7: the tools at the reference's sizes; msm_sweep's grid
MEASURE_MSM_LOG = 17
MEASURE_KERNELS_LOG = 20
SWEEP = tuple((c, k) for c in (11, 12, 13) for k in (64, 128, 256))
MESH_CIRCUIT, MESH_DEVICES = "withdraw", 4


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


def chain_ms(products: float) -> float:
    """The latency bound of a chain of `products` dependent Fq products a
    thread on one warp: 264 multiplies each, one every WARP_MUL_CLOCKS."""
    return products * MULS_PER_PRODUCT * WARP_MUL_CLOCKS / CLOCK_HZ * 1e3


def horner_bounds(g: str, W: int, c: int, doubling_adds: int = 0):
    """The Horner of W windows at c over curve g (W c doubles, W adds, the
    add's doubling path on `doubling_adds` of them): ((bound_ms, bound_by)
    of its products and bytes over the whole card, the latency bound of
    its chain on one warp, a G2 chain halved over a thread pair)."""
    dbl = PER_LANE[f"{g}_double"][0]
    add, add_dbl, _ = PER_LANE[f"{g}_add"]
    products = W * c * dbl + W * add + doubling_adds * add_dbl
    values = (W + 1) * 3 * (2 if g == "g2" else 1)
    return (bound(products, values * VALUE_BYTES),
            chain_ms(products / (2 if g == "g2" else 1)))


def inv_bound(name: str, n: int):
    """The bound of inv[fq] / inv[fq2] over n lanes, from the function's
    own work: Montgomery's trick over all n lanes, 3 products a lane (7
    over Fq2: the norm's two squares, the coordinates' two), less 3, and
    one q - 2 chain, against the lanes' values read and written once. How
    the kernel shares the lanes among threads does not enter it
    (inv_kernel_products counts that)."""
    lane, k = (3, 1) if name == "inv[fq]" else (7, 2)
    return bound(lane * n - 3 + INV_CHAIN, 2 * k * n * VALUE_BYTES)


def inv_kernel_products(name: str, n: int) -> int:
    """The Fq products inv_kernel does over n lanes at
    kernels.inv_per_thread() lanes a thread, T = ceil(n / that) threads:
    3 a lane (7 over Fq2) and INV_CHAIN a thread, less 3 a thread (its
    first lane has no prefix product and no back step)."""
    from zkrollup_torch import kernels
    T = -(-n // kernels.inv_per_thread())
    return (3 if name == "inv[fq]" else 7) * n + (INV_CHAIN - 3) * T


def alu_bound(counts: dict, n: int, reps: int):
    """The bound of an integer-unit kernel over (16, n) lanes and reps: the
    clocks an SM needs per lane and rep for its loop's instructions
    (profile_alu.issue_clocks of its sass_counts entry) over 132 SMs at
    CLOCK_HZ, against 12 B a lane."""
    from zkrollup_torch.tools import profile_alu
    t_bytes = 16 * n * 12 / HBM_BYTES_PER_S * 1e3
    t_ops = (16 * n * reps * profile_alu.issue_clocks(counts)
             / (132 * CLOCK_HZ) * 1e3)
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def ptxas_report(logs: dict) -> dict:
    """{function: (registers, spill store bytes, stack frame bytes)} from
    nvcc's -Xptxas -v output of each unit's build log; registers are None
    for a called device function, whose registers count in its caller's."""
    import re
    out = {}
    for path in logs.values():
        with open(path) as f:
            text = f.read()
        regs = {m.group(1): int(m.group(2)) for m in re.finditer(
            r"Compiling entry function '(\S+)'.*?Used (\d+) registers", text,
            re.S)}
        for m in re.finditer(r"Function properties for (\S+)\s+(\d+) bytes "
                             r"stack frame, (\d+) bytes spill stores", text):
            out[m.group(1)] = (regs.get(m.group(1)), int(m.group(3)),
                               int(m.group(2)))
    return out


def resident_warps(regs: int) -> int:
    """Warps an H100 SM holds of a kernel of 128-thread blocks at `regs`
    registers a thread: 64K registers an SM, allocated per warp in units of
    256, whole blocks of 4 warps, at most 64 warps."""
    per_warp = -(-regs * 32 // 256) * 256
    return min(64, 65536 // per_warp // 4 * 4)


def log_ptxas(ptxas: dict, prefix: str = "") -> None:
    for entry, (regs, spill, stack) in sorted(ptxas.items()):
        what = ("called function" if regs is None
                else f"{regs} registers ({resident_warps(regs)} warps an SM)")
        log(f"    {prefix}{entry}: {what}, {spill} bytes spill stores, "
            f"{stack} bytes stack frame")


def check_spill(ptxas: dict) -> None:
    """Phase 1: every kernel of LAUNCH_BOUNDS is in the report once, spills
    nothing and fits the blocks its launch bounds ask for; no called
    function spills."""
    bad = []
    for name, (threads, blocks) in LAUNCH_BOUNDS.items():
        found = [(e, v) for e, v in ptxas.items()
                 if f"{len(name)}{name}E" in e and v[0] is not None]
        if len(found) != 1:
            bad.append(f"{name}: {len(found)} entries in the ptxas report")
            continue
        (regs, spill, _), = (v for _, v in found)
        was = EARLIER_REGS.get(name)
        log(f"  {name}: launch bounds ({threads}, {blocks}), {regs} "
            f"registers, {spill} bytes spill stores"
            + ("" if was is None else f" (before the add was factored: "
               f"{was} registers, {'same' if was == regs else 'CHANGED'})"))
        if spill or resident_warps(regs) < threads // 32 * blocks:
            bad.append(f"{name}: {regs} registers, {spill} bytes spill "
                       f"stores at ({threads}, {blocks})")
    bad += [f"{e}: {v[1]} bytes spill stores" for e, v in ptxas.items()
            if v[0] is None and v[1]]
    if bad:
        raise AssertionError("kernels spill or miss their launch bounds: "
                             + "; ".join(bad))


def check_widest(path: str, counts: dict, shapes: dict) -> None:
    """Phases 3 and 8: `shapes` (PROVE_SHAPES, SETUP_SHAPES), the widths at
    which phase 2 holds and times those point kernels, must be the widest
    launches of `path` (counts: count_path's entry of it)."""
    for name, want in shapes.items():
        widths = counts[name][2]
        log(f"  {name} on {path}, launches at each width: "
            + ", ".join(f"{w} x {c}" for w, c in sorted(widths.items(),
                                                        reverse=True)))
        widest = tuple(sorted(widths, reverse=True)[:len(want)])
        if widest != want:
            raise AssertionError(f"{name}: the {path} path's widest launches"
                                 f" are {widest}, the script says {want}")


def check_limits(path: str, counts: dict, limits: dict) -> None:
    """Phases 3 and 8: each kernel of `limits` launched within its range on
    `path` (PROVE_LIMITS, SETUP_LIMITS)."""
    for name, (lo, hi) in limits.items():
        count = counts[name][0]
        log(f"  {name} on {path}: {count} launches (allowed {lo}-{hi}), "
            "lanes at each width: " + ", ".join(
                f"{w} x {c}" for w, c in sorted(counts[name][2].items(),
                                                reverse=True)))
        if not lo <= count <= hi:
            raise AssertionError(f"{name}: {count} launches on {path}, "
                                 f"allowed {lo}-{hi}")


def check_prove_limits(launches) -> None:
    """Phase 8: the field kernels' launches on the prove path within
    PROVE_LIMITS, and limbs.normalize never reached on a CUDA tensor
    during that proof."""
    check_limits("prove", launches["prove"], PROVE_LIMITS)
    norm = launches["prove_normalize_cuda"]
    log(f"  limbs.normalize on CUDA tensors during the first proof: {norm}")
    if norm:
        raise AssertionError(f"limbs.normalize ran {norm} times on CUDA "
                             "tensors during the first proof")


def count_path(launches, path):
    """launches[path][kernel] = (launches, lanes, {lanes a launch: launches})
    since the last reset."""
    from zkrollup_torch import kernels
    launches[path] = {k: (kernels.LAUNCHES[k], kernels.LANES[k],
                          dict(kernels.WIDTHS[k]))
                      for k in kernels.LAUNCHES}


def log(*a):
    print(*a, flush=True)


def smi_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


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


def inv_loop(a):
    """The Fq inversion as it ran before the inversion kernel, the
    baseline phases 2 and 5 time it against: Fermat, a^(q - 2), one
    mont_mul[fq] launch a product (FieldCtx.mont_pow_const over the kernel
    wrapper: 253 squares, 109 products)."""
    from zkrollup_torch.fields.mont import FQ
    return FQ.mont_pow_const(a, FQ.p - 2)


def inv2_loop(a):
    """The Fq2 inversion as it ran before the inversion kernel: the norm by
    two mont_mul[fq] launches and FQ.add, inv_loop, then (a0 n^-1,
    -(a1 n^-1)) by three more launches."""
    from zkrollup_torch.fields.mont import FQ
    norm = FQ.add(FQ.mont_mul(a[0], a[0]), FQ.mont_mul(a[1], a[1]))
    ninv = inv_loop(norm)
    return (FQ.mont_mul(a[0], ninv), FQ.neg(FQ.mont_mul(a[1], ninv)))


@contextlib.contextmanager
def inv_loop_route():
    """While open, weierstrass.batch_inverse runs as it did before the
    inversion kernel: the product tree (a mont_mul launch over each level)
    with its root inverted by inv_loop or inv2_loop."""
    from zkrollup_torch.curve import weierstrass as W
    saved = (W.batch_inverse, W.FqOps.__dict__["inv"],
             W.Fq2Ops.__dict__["inv"])
    W.batch_inverse = W.batch_inverse_tree
    W.FqOps.inv = staticmethod(inv_loop)
    W.Fq2Ops.inv = staticmethod(inv2_loop)
    try:
        yield
    finally:
        W.batch_inverse = saved[0]
        W.FqOps.inv, W.Fq2Ops.inv = saved[1], saved[2]


@contextlib.contextmanager
def carry_loop_route():
    """While open, FieldCtx.add and sub run as they did before the add and
    sub kernels, on every device: their plain versions, limbs.normalize's
    carry loop, which reads a flag back to the host on every pass."""
    from zkrollup_torch.fields import cuda_mont
    saved = cuda_mont.add, cuda_mont.sub
    cuda_mont.add, cuda_mont.sub = cuda_mont.add_plain, cuda_mont.sub_plain
    try:
        yield
    finally:
        cuda_mont.add, cuda_mont.sub = saved


def mimc_loop(inputs):
    """The sponge as it ran before mimc_sponge[fr], the baseline phases 2
    and 10 time it against: the reference's loop over the rounds
    (mimc.permute_mont), a mont_mul[fr] launch a product and FR.add an add
    (the add[fr] kernel; the carry loop inside carry_loop_route)."""
    import torch
    from zkrollup_torch.fields import limbs as L
    from zkrollup_torch.fields.mont import FR
    from zkrollup_torch.hash import mimc
    zeros = torch.zeros(inputs.shape[:-2] + (L.N_LIMBS,), dtype=L.DTYPE,
                        device=inputs.device)
    r, c = zeros, zeros
    for i in range(inputs.shape[-2]):
        r = FR.add(r, inputs[..., i, :])
        r, c = mimc.permute_mont(r, c, zeros)
    return r


def mimc_operands() -> dict:
    """Phase 2's and phase 10's MiMC data from the seed: MIMC_PAIRS pairs'
    values and the native engine's hashes of them, a depth-MIMC_DEPTH
    tree's 2^(MIMC_DEPTH - 1) - 1 leaves, MIMC_ROWS four-wide rows and the
    engine's hashes of them."""
    import numpy as np
    from zkrollup_torch.fields.mont import FR
    rng = np.random.RandomState(SEED + 10)
    rand = lambda n: [int.from_bytes(rng.bytes(32), "little") % FR.p
                      for _ in range(n)]
    vals = rand(2 * MIMC_PAIRS)
    pairs = [vals[i:i + 2] for i in range(0, len(vals), 2)]
    t0 = time.time()
    want_level = engine_rows(pairs)
    log(f"  the engine's {MIMC_PAIRS} pair hashes on {ENGINE_THREADS} "
        f"threads: {time.time() - t0:.3f} s")
    leaves = rand((1 << (MIMC_DEPTH - 1)) - 1)
    flat = rand(4 * MIMC_ROWS)
    rows = [flat[i:i + 4] for i in range(0, len(flat), 4)]
    return {"vals": vals, "pairs": pairs, "want_level": want_level,
            "leaves": leaves, "rows": rows, "want_rows": engine_rows(rows)}


def zero_lanes(n: int, per_thread: int) -> list:
    """Lanes of a launch of n lanes at per_thread lanes a thread (T
    threads, thread t on lanes t + j T): the first, the middle and the last
    of thread 0 and of the last thread, and every lane of thread 1."""
    T = -(-n // per_thread)
    out = []
    for t in (0, T - 1):
        own = list(range(t, n, T))
        out += [own[0], own[len(own) // 2], own[-1]]
    return out + (list(range(1, n, T)) if T > 1 else [])


def inv_operand(rand_fe, name: str, n: int, edges: bool = False):
    """n lanes for inv[fq] (a tensor) or inv[fq2] (a pair): random
    canonical values with zero_lanes(n, kernels.inv_per_thread()) zero;
    with `edges` rows 2-5 are 1, q - 1, R mod q and 0 (in a0, with a1 = 0
    over Fq2), and over Fq2 row 6 has a0 = 0 and row 7 a1 = 0."""
    import torch
    from zkrollup_torch.fields import limbs as L
    from zkrollup_torch.fields.mont import FQ
    planes = [rand_fe(n) for _ in range(1 if name == "inv[fq]" else 2)]
    dev = planes[0].device
    from zkrollup_torch import kernels
    zl = torch.tensor(zero_lanes(n, kernels.inv_per_thread()), device=dev)
    for pl in planes:
        pl[zl] = 0
    if edges:
        planes[0][2:6] = L.to_device(L.ints_to_limbs(
            [1, FQ.p - 1, FQ.r_mod_p, 0]), dev)
        if len(planes) == 2:
            planes[1][2:6] = 0
            planes[0][6] = 0
            planes[1][7] = 0
    return planes[0] if len(planes) == 1 else tuple(planes)


def check_inv(dev, rand_fe, results):
    """Phase 2, inv[fq] and inv[fq2]: bit for bit against their plain
    versions (cuda_mont.inv_plain, inv_fq2_plain: Fermat over the plain
    product) and against inv_loop / inv2_loop (one mont_mul[fq] launch a
    product), at INV_SHAPES (the widest launch, its operand with the edge
    rows of inv_operand, and a slice of it), on ragged launches of
    INV_RAGGED lanes (zero lanes placed for each launch; one lane is a zero
    lane) and on one finite lane. The plain version runs once on the widest
    operand (timed) and once on the small ones concatenated. Timed: the
    kernel at each width beside its bound, and on one lane beside one
    thread's latency bound; inv_loop at the widest width and on one lane;
    device ms (cuda_ms) and wall ms (wall_ms). Beside the bound, the
    kernel's own product count (inv_kernel_products) at the multiply
    rate."""
    import torch
    from zkrollup_torch import kernels
    from zkrollup_torch.fields import cuda_mont, fq2
    from zkrollup_torch.fields.mont import FQ

    for name, (big, other) in INV_SHAPES.items():
        two = name == "inv[fq2]"
        kernel = fq2.inv if two else FQ.mont_inv
        plain = ((lambda a: cuda_mont.inv_fq2_plain(FQ, a)) if two
                 else (lambda a: cuda_mont.inv_plain(FQ, a)))
        loop = inv2_loop if two else inv_loop
        planes = (lambda x: list(x)) if two else (lambda x: [x])
        join = tuple if two else (lambda ps: ps[0])
        cut = lambda x, lo, hi: join([p[lo:hi].contiguous()
                                      for p in planes(x)])

        wide = inv_operand(rand_fe, name, big, edges=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want_wide = plain(wide)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        small = [inv_operand(rand_fe, name, n) for n in INV_RAGGED]
        small.append(inv_operand(rand_fe, name, 1))
        planes(small[-1])[0][0] = planes(rand_fe(1))[0][0] | 1  # finite
        cat = join([torch.cat(ps) for ps in zip(*map(planes, small))])
        want_cat = plain(cat)
        cases, off = [(big, wide, want_wide),
                      (other, cut(wide, 0, other), cut(want_wide, 0, other))
                      ], 0
        for x in small:
            n = planes(x)[0].shape[0]
            cases.append((n, x, cut(want_cat, off, off + n)))
            off += n
        for n, x, want in cases:
            e_plain = max_abs_err(planes(kernel(x)), planes(want))
            e_loop = max_abs_err(planes(loop(x)), planes(want))
            if e_plain or e_loop:
                raise AssertionError(
                    f"{name}: kernel or the launch-a-product route disagrees"
                    f" with the plain version at {n} lanes")
        shapes = {}
        for n, x, _ in cases[:2]:
            bnd = inv_bound(name, n)
            prods = inv_kernel_products(name, n)
            shapes[str(n)] = {"ms": cuda_ms(lambda: kernel(x), 20),
                              "bound_ms": bnd[0], "bound_by": bnd[1],
                              "kernel_products": prods,
                              "kernel_products_ms": bound(prods, 0)[0]}
        one = cases[-1][1]
        chain = INV_CHAIN + (4 if two else 0)
        res = {
            "max_abs_err": 0, "lanes": big, "ms": shapes[str(big)]["ms"],
            "plain_ms": plain_ms, "bound_ms": shapes[str(big)]["bound_ms"],
            "bound_by": shapes[str(big)]["bound_by"], "library_ms": None,
            "per_thread": kernels.inv_per_thread(), "shapes": shapes,
            "wall_ms": wall_ms(lambda: kernel(wide)),
            "loop_ms": cuda_ms(lambda: loop(wide), 2),
            "loop_wall_ms": wall_ms(lambda: loop(wide), 3),
            "one_lane_ms": cuda_ms(lambda: kernel(one), 20),
            "one_lane_wall_ms": wall_ms(lambda: kernel(one)),
            "one_lane_loop_ms": cuda_ms(lambda: loop(one), 2),
            "one_lane_loop_wall_ms": wall_ms(lambda: loop(one), 3),
            "one_lane_latency_bound_ms": chain_ms(chain)}
        results[name] = res
        log(f"  {name:13s} {big} and {other} lanes, ragged {INV_RAGGED}, one "
            f"finite lane; 0, 1, q - 1, R mod q and zero lanes first, middle"
            f" and last of a thread: max_abs_err 0 against the plain version "
            f"and the launch-a-product route")
        for n, row in shapes.items():
            log(f"  {name:13s} {n} lanes: kernel {row['ms']:.4f} ms, bound "
                f"{row['bound_ms']:.4f} ms ({row['bound_by']}); the kernel's "
                f"own {row['kernel_products']} products "
                f"{row['kernel_products_ms']:.4f} ms at the multiply rate")
        log(f"  {name:13s} {big} lanes: kernel {res['wall_ms']:.4f} ms wall; "
            f"the launch-a-product route {res['loop_ms']:.4f} ms device, "
            f"{res['loop_wall_ms']:.4f} ms wall; plain {plain_ms:.1f} ms; "
            f"one lane: kernel {res['one_lane_ms']:.4f} ms device, "
            f"{res['one_lane_wall_ms']:.4f} wall, the route "
            f"{res['one_lane_loop_ms']:.4f} device, "
            f"{res['one_lane_loop_wall_ms']:.4f} wall; one thread's latency "
            f"bound {res['one_lane_latency_bound_ms']:.4f} ms")


def check_add_sub(dev, rand_fe, results):
    """Phase 2, add[fr], sub[fr], add[fq], sub[fq] (FieldCtx.add / sub on
    CUDA tensors): bit for bit against add_plain / sub_plain at
    ADD_SUB_WIDTHS (2^17 lanes with 0, 1, p - 1, a + b = p exactly and a
    borrowing difference in the first rows, and 117,114 as a slice), on
    ragged launches of ADD_SUB_RAGGED lanes and with either operand one
    broadcast row. Timed at each width beside the bound (3 values of 32 B
    a lane over the memory rate), wall ms at 2^17, and the plain version's
    wall ms (its carry loop syncs on every pass) at 2^17."""
    import functools
    from zkrollup_torch.fields import cuda_mont, limbs as L
    from zkrollup_torch.fields.mont import FR, FQ

    big = ADD_SUB_WIDTHS[0]
    for F in (FR, FQ):
        a, b = rand_fe(big), rand_fe(big)
        v = F.p // 3
        a[:6] = L.to_device(L.ints_to_limbs(
            [0, F.p - 1, 1, F.p - 1, v, 1]), dev)
        b[:6] = L.to_device(L.ints_to_limbs(
            [0, 1, F.p - 1, F.p - 1, F.p - v, 2]), dev)
        for op in ("add", "sub"):
            name = f"{op}[{F.name}]"
            fn = getattr(F, op)
            plain = functools.partial(getattr(cuda_mont, f"{op}_plain"), F)
            want = plain(a, b)
            cases = [(n, fn(a[:n], b[:n]), want[:n])
                     for n in ADD_SUB_WIDTHS + ADD_SUB_RAGGED]
            cases += [("b one row", fn(a, b[5]), plain(a, b[5])),
                      ("a one row", fn(a[4], b), plain(a[4], b))]
            for what, got, w in cases:
                if got.shape != w.shape or max_abs_err([got], [w]):
                    raise AssertionError(f"{name} differs from its plain "
                                         f"version ({what} lanes)")
            shapes = {}
            for n in ADD_SUB_WIDTHS:
                x, y = a[:n], b[:n]
                bnd = bound(0, 3 * VALUE_BYTES * n)
                shapes[str(n)] = {"ms": cuda_ms(lambda: fn(x, y), 50),
                                  "bound_ms": bnd[0], "bound_by": bnd[1]}
            top = shapes[str(big)]
            res = {"max_abs_err": 0, "lanes": big, "ms": top["ms"],
                   "plain_ms": wall_ms(lambda: plain(a, b)),
                   "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
                   "library_ms": None, "shapes": shapes,
                   "wall_ms": wall_ms(lambda: fn(a, b))}
            results[name] = res
            log(f"  {name:13s} {' and '.join(map(str, ADD_SUB_WIDTHS))} "
                f"lanes, ragged {ADD_SUB_RAGGED}, either operand one row: "
                "max_abs_err 0 against the plain version; " + "; ".join(
                    f"{n} lanes: kernel {r['ms']:.4f} ms, bound "
                    f"{r['bound_ms']:.4f} ms ({r['bound_by']})"
                    for n, r in shapes.items())
                + f"; {big} lanes: wall {res['wall_ms']:.4f} ms, plain "
                f"(carry loop) wall {res['plain_ms']:.3f} ms")


def mimc_kernel_registers():
    """(registers, resident 128-thread warps an SM) of mimc_sponge_kernel
    from this build's ptxas report."""
    from zkrollup_torch import kernels
    regs = [v[0] for e, v in ptxas_report(kernels.build_info["logs"]).items()
            if "18mimc_sponge_kernelE" in e and v[0] is not None]
    if len(regs) != 1:
        raise AssertionError(f"mimc_sponge_kernel: {len(regs)} entries in "
                             "the ptxas report")
    return regs[0], resident_warps(regs[0])


def check_mimc(dev, ops, results):
    """Phase 2, mimc_sponge[fr] (multi_hash_mont on CUDA tensors): at 2^17
    pairs bit for bit against the native engine, its plain version
    (mimc.multi_hash_mont_plain, the reference's loop over the plain
    product and add; timed, wall) and mimc_loop (a mont_mul[fr] and an
    add[fr] launch a step); at 2^17 four-wide rows against the engine; on
    ragged launches of 1, 22, 33 and 1,025 lanes of four inputs under a key
    a lane and under one broadcast key against the plain version. Timed:
    device ms at both widths beside the bound (the Fr products over the
    multiply rate) and one lane's latency bound (its chain of dependent
    products on one warp), wall ms, one lane, and mimc_loop's device and
    wall ms; the kernel's registers and waves at 2^17 lanes."""
    import torch
    from zkrollup_torch.fields import limbs as L
    from zkrollup_torch.fields.mont import FR
    from zkrollup_torch.hash import mimc

    enc = lambda vals, w: L.to_device(FR.to_mont_host(vals), dev).reshape(
        -1, w, L.N_LIMBS)
    pairs = enc(ops["vals"], 2)
    rows = enc([v for r in ops["rows"] for v in r], 4)
    got = mimc.multi_hash_mont(pairs)
    if (FR.from_mont_host(got) != ops["want_level"]
            or FR.from_mont_host(mimc.multi_hash_mont(rows))
            != ops["want_rows"]):
        raise AssertionError("mimc_sponge[fr] differs from the native "
                             "engine")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = mimc.multi_hash_mont_plain(pairs)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    if max_abs_err([got], [want]) or max_abs_err([mimc_loop(pairs)],
                                                 [want]):
        raise AssertionError("mimc_sponge[fr] or mimc_loop differs from "
                             "the plain version at 2^17 pairs")
    x4 = rows[:max(ADD_SUB_RAGGED)]
    keys = enc(ops["vals"][:x4.shape[0]], 1)[:, 0]
    for k in (keys, keys[3]):
        want_k = mimc.multi_hash_mont_plain(x4, k)
        for m in ADD_SUB_RAGGED:
            km = k if k.dim() == 1 else k[:m]
            if max_abs_err([mimc.multi_hash_mont(x4[:m], km)], [want_k[:m]]):
                raise AssertionError(f"mimc_sponge[fr] differs from its "
                                     f"plain version on {m} lanes")
    regs, warps = mimc_kernel_registers()
    shapes = {}
    for label, x in (("pairs", pairs), ("rows", rows)):
        n, n_in = x.shape[0], x.shape[1]
        products = n * n_in * MIMC_PRODUCTS_PER_INPUT
        bnd = bound(products, (n_in + 1) * VALUE_BYTES * n)
        shapes[label] = {
            "lanes": n, "n_in": n_in, "products": products,
            "ms": cuda_ms(lambda: mimc.multi_hash_mont(x), 10),
            "wall_ms": wall_ms(lambda: mimc.multi_hash_mont(x)),
            "bound_ms": bnd[0], "bound_by": bnd[1],
            "latency_bound_ms": chain_ms(n_in * MIMC_PRODUCTS_PER_INPUT),
            "waves": n / (132 * warps * 32)}
    one = pairs[:1]
    top = shapes["pairs"]
    res = {"max_abs_err": 0, "lanes": top["lanes"], "ms": top["ms"],
           "plain_ms": plain_ms, "bound_ms": top["bound_ms"],
           "bound_by": top["bound_by"], "library_ms": None, "shapes": shapes,
           "registers": regs, "wall_ms": top["wall_ms"],
           "one_lane_ms": cuda_ms(lambda: mimc.multi_hash_mont(one), 10),
           "loop_ms": cuda_ms(lambda: mimc_loop(pairs), 2),
           "loop_wall_ms": wall_ms(lambda: mimc_loop(pairs), 3)}
    results["mimc_sponge[fr]"] = res
    log(f"  mimc_sponge[fr] {top['lanes']} pairs: equal to the native "
        f"engine, the plain version and mimc_loop bit for bit; "
        f"{shapes['rows']['lanes']} four-wide rows: equal to the engine; "
        f"ragged {ADD_SUB_RAGGED} lanes of four under a key a lane and a "
        f"broadcast key: equal to the plain version; {regs} registers, "
        f"{warps} warps an SM")
    for label, r in shapes.items():
        log(f"  mimc_sponge[fr] {r['lanes']} lanes of {r['n_in']} inputs "
            f"({r['products']} Fr products): kernel {r['ms']:.4f} ms, wall "
            f"{r['wall_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}), one lane's latency bound "
            f"{r['latency_bound_ms']:.4f} ms, {r['waves']:.3f} waves")
    log(f"  mimc_sponge[fr] one lane {res['one_lane_ms']:.4f} ms; plain "
        f"{plain_ms:.1f} ms at {top['lanes']} pairs; mimc_loop "
        f"{res['loop_ms']:.4f} ms device, {res['loop_wall_ms']:.4f} ms wall")


def check_kernels(dev, results):
    """Phase 2: each kernel against its plain version on the card."""
    import torch
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

    check_fields(dev, rand_fe, record, results)
    check_inv(dev, rand_fe, results)
    check_add_sub(dev, rand_fe, results)

    # curve kernels over 2^16 lanes of real points
    n = 1 << 16
    for curve in (G1, G2):
        ops = point_operands(curve, dev, n)
        for name, (fn, plain, args, n_dbl) in ops.items():
            record(name, curve.leaves(fn(curve, *args)),
                   curve.leaves(plain(curve, *args)),
                   cuda_ms(lambda: fn(curve, *args), 20),
                   cuda_ms(lambda: plain(curve, *args), 2),
                   lane_bound(name, n, n_dbl))

        check_double(curve, ops[f"{curve.name}_double"][2], results)
        for name in (*PROVE_SHAPES, *SETUP_SHAPES, *Z01_SHAPES,
                     *ND_SHAPES):
            if name.startswith(curve.name + "_"):
                check_widths(curve, name, *ops[name][:3], results)
        check_horner(curve, ops[f"{curve.name}_add"][2][0], results)


def check_double(curve, args, results):
    """Phase 2, the double beyond 2^16 lanes (g1_double; g2_double on
    thread pairs): bit for bit against double_plain on ragged launches of
    RAGGED lanes at two offsets and of 1,025 lanes, and on one lane (an
    infinity lane and a finite one); timed on one lane beside its latency
    bound (one warp's chain: 7 Fq products over G1, 8 a thread of a G2
    pair)."""
    from zkrollup_torch.curve import cuda_curve
    name = f"{curve.name}_double"
    n = curve.leaves(args[0])[0].shape[0]
    take = lambda m, off=0: take_lanes(curve, args, m, off)[0]
    subs = [(m, off) for m in RAGGED for off in (0, n - 7)] + [(1025, 0)]
    subs += [(1, 2), (1, 5)]
    bad = [(m, off) for m, off in subs if max_abs_err(
        curve.leaves(cuda_curve.double(curve, *take(m, off))),
        curve.leaves(cuda_curve.double_plain(curve, *take(m, off))))]
    if bad:
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version at (lanes, offset) {bad}")
    one = take(1, 5)
    ms1 = cuda_ms(lambda: cuda_curve.double(curve, *one), 264)
    products = PER_LANE[name][0] / (2 if curve.name == "g2" else 1)
    results[name].update(one_lane_ms=ms1,
                         one_lane_latency_bound_ms=chain_ms(products))
    log(f"  {name:13s} {RAGGED} lanes at offsets 0 and {n - 7}, 1025 lanes, "
        f"one lane (infinity and finite): max_abs_err 0; one lane "
        f"{ms1:.4f} ms, latency bound {chain_ms(products):.4f} ms")


def horner_loop(curve, wsum, c: int):
    """The MSM's Horner as msm() ran it before the Horner kernels, the
    baseline phases 2 and 5 hold and time them against: from infinity, for
    each window from the top, c double launches and one add launch on one
    lane (286 launches a curve at c = 12, 22 windows)."""
    from zkrollup_torch.curve import cuda_curve
    n_windows = curve.leaves(wsum)[0].shape[0]
    res = curve.infinity((1,), curve.leaves(wsum)[0].device)
    for w in range(n_windows - 1, -1, -1):
        for _ in range(c):
            res = cuda_curve.double(curve, res)
        res = cuda_curve.add(curve, res, curve.map(
            lambda a: a[w:w + 1].contiguous(), wsum))
    return curve.map(lambda a: a[0], res)


def horner_plain_host(curve, wsum, c: int):
    """horner_plain on the CPU over copies of wsum, the result back on
    wsum's device: the same integer arithmetic as on the card, where each
    of its ~20 torch ops a product is a launch."""
    from zkrollup_torch.curve import cuda_curve
    dev = curve.leaves(wsum)[0].device
    out = cuda_curve.horner_plain(curve, curve.map(lambda a: a.cpu(), wsum),
                                  c)
    return curve.map(lambda a: a.to(dev), out)


def horner_cases(curve, p) -> dict:
    """Phase 2's window sums for the Horner kernels, {label: (wsum, c,
    adds on the doubling path)}, from rows of p (phase 2's Jacobian
    operand: Z != 1, rows 5.. finite and distinct, row 4 infinity): the
    msm's W = 22 at c = 12, W = 1 and 2, the GLV tables' W = 11, small c,
    infinity windows at the top, the middle and the bottom and every
    window infinity, W_1 = 2^c res (the add's doubling path; W_1 in other
    Jacobian limbs than res), W_1 = -(2^c res) and, as the last window,
    W_0 = -(2^c res) (P + (-P): Z zeroed alone)."""
    import torch
    from zkrollup_torch.curve import cuda_curve
    dev = curve.leaves(p)[0].device
    rows = lambda *idx: curve.map(
        lambda a: a.index_select(0, torch.tensor(idx, device=dev)), p)
    cat = lambda *pts: curve.map(lambda *a: torch.cat(a).contiguous(), *pts)

    def times_2c(pt, c):
        for _ in range(c):
            pt = cuda_curve.double_plain(curve, pt)
        return pt

    c = HORNER_C
    twice = times_2c(rows(5), c)
    # 2^c res again, other limbs: (2^c res - r) + r
    other = cuda_curve.add_plain(curve, cuda_curve.add_plain(
        curve, twice, curve.neg(rows(8))), rows(8))
    inf = lambda k: rows(*([4] * k))
    return {
        f"W={HORNER_W}, c={c}": (rows(*range(5, 5 + HORNER_W)), c, 0),
        f"W=1, c={c}": (rows(5), c, 0),
        f"W=2, c={c}": (rows(5, 6), c, 0),
        f"W=11, c={c} (GLV tables)": (rows(*range(5, 16)), c, 0),
        "W=9, c=1": (rows(*range(20, 29)), 1, 0),
        "W=6, c=3": (rows(*range(30, 36)), 3, 0),
        "W=22, c=2, windows 0, 10, 20 and 21 infinity": (
            cat(inf(1), rows(*range(40, 49)), inf(1), rows(*range(50, 59)),
                inf(2)), 2, 0),
        f"W=3, c={c}, every window infinity": (inf(3), c, 0),
        f"W=3, c={c}, W_1 = 2^c res (doubling path)": (
            cat(rows(7), other, rows(5)), c, 1),
        f"W=3, c={c}, W_1 = -(2^c res)": (
            cat(rows(7), curve.neg(twice), rows(5)), c, 0),
        f"W=2, c={c}, W_0 = -(2^c res)": (cat(curve.neg(twice), rows(5)),
                                          c, 0),
    }


def wall_ms(fn, reps: int = 5) -> float:
    """Median host milliseconds of one call, from a synchronize to the
    synchronize after it."""
    import statistics
    import torch
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(out)


def check_horner(curve, p, results):
    """Phase 2, the Horner kernel of `curve` (g1_horner, g2_horner): on
    every case of horner_cases, bit for bit as Jacobian limbs against
    horner_plain and against the one-lane route (horner_loop). The msm's
    case (W = 22, c = 12) runs horner_plain on the card, once, timed; the
    others run it on the CPU (horner_plain_host). Both routes timed there:
    device ms (cuda_ms) and wall ms (wall_ms), beside the bound over the
    card and the latency bound of the chain on one warp."""
    from zkrollup_torch.curve import cuda_curve
    import torch
    g = curve.name
    name = f"{g}_horner"
    err = 0
    for label, (wsum, c, n_dbl) in horner_cases(curve, p).items():
        got = curve.leaves(cuda_curve.horner(curve, wsum, c))
        loop = curve.leaves(horner_loop(curve, wsum, c))
        main = label == f"W={HORNER_W}, c={HORNER_C}"
        if main:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            plain = curve.leaves(cuda_curve.horner_plain(curve, wsum, c))
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t0) * 1e3
            timed = (wsum, c)
        else:
            plain = curve.leaves(horner_plain_host(curve, wsum, c))
        e_plain, e_loop = max_abs_err(got, plain), max_abs_err(got, loop)
        log(f"  {name:13s} {label}: max_abs_err {e_plain} against "
            f"horner_plain, {e_loop} against the one-lane route")
        if e_plain or e_loop:
            raise AssertionError(f"{name}: kernel disagrees with horner_plain"
                                 f" or the one-lane route ({label})")
        err = max(err, e_plain)
    wsum, c = timed
    ms = cuda_ms(lambda: cuda_curve.horner(curve, wsum, c), 20)
    loop_ms = cuda_ms(lambda: horner_loop(curve, wsum, c), 2)
    wall = wall_ms(lambda: cuda_curve.horner(curve, wsum, c))
    loop_wall = wall_ms(lambda: horner_loop(curve, wsum, c))
    bnd, latency = horner_bounds(g, HORNER_W, HORNER_C)
    results[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bnd[0], "bound_by": bnd[1],
                     "library_ms": None, "latency_bound_ms": latency,
                     "wall_ms": wall, "loop_ms": loop_ms,
                     "loop_wall_ms": loop_wall}
    log(f"  {name:13s} W={HORNER_W}, c={HORNER_C}: kernel {ms:.4f} ms device"
        f", {wall:.4f} ms wall; the one-lane route {loop_ms:.4f} ms device, "
        f"{loop_wall:.4f} ms wall; plain {plain_ms:.1f} ms; latency bound "
        f"{latency:.4f} ms, bound {bnd[0]:.6f} ms ({bnd[1]})")


def transform_bound(batch: int, log_n: int, products: int = 0,
                    tables: int = 1):
    """The bound of `batch` radix-2 transforms of 2^log_n rows: log_n x
    2^(log_n - 1) products each (and `products` more, the tables' and the
    prologue's), against the rows read and written once and `tables`
    tables of 2^log_n rows read once (the twiddles; pre or post)."""
    n = 1 << log_n
    return bound(batch * log_n * n // 2 + products,
                 (2 * batch + tables) * n * VALUE_BYTES)


def run_passes(fn, x, tw, **kw):
    """A transform of x through `fn` (cuda_mont.ntt_pass or its plain
    version) pass by pass, as ntt.transform runs it."""
    from zkrollup_torch.fields.mont import FR
    from zkrollup_torch.ntt import ntt
    plan = ntt.passes(x.shape[-2].bit_length() - 1)
    post = kw.pop("post", None)
    y = None
    for p, (s0, k) in enumerate(plan):
        last = post if p == len(plan) - 1 else None
        if p == 0:
            y = fn(FR, x, tw, s0, k, bitrev=True, post=last, **kw)
        else:
            fn(FR, y, tw, s0, k, out=y, post=last)
    return y


def check_fields(dev, rand_fe, record, results):
    """Phase 2, the NTT pass, the fold and the gathered mont_mul at the
    prove path's shapes, bit for bit against their plain versions, each
    with 0, 1 and r - 1 in its first rows. ntt_pass: one 2^17 transform,
    forward and inverse (n^-1 broadcast); with Montgomery pre and post
    tables; with the quotient's plain-form post; a batch of three; the
    pointwise prologue of the quotient's coset iNTT; the 17 stages as 17
    passes of one stage (in place, the old butterfly's function). Timed:
    the forward transform (its row in the kernel line), each of its two
    launches, the batch of three, the coset iNTT with its prologue, the
    one-stage pass and the whole quotient on 2^17 rows. fold[fr]: 2^17
    rows of lazy sums with rows V = 0, V = 2^288 - 1 and V = 5 r. The
    gathered mont_mul[fr]: 164,215 and 735,774 lanes over a 117,114-row
    table, and the plain launch at the witness's 117,114 lanes."""
    import numpy as np
    import torch
    from zkrollup_torch.fields import cuda_mont, limbs as L
    from zkrollup_torch.fields.mont import FR
    from zkrollup_torch.groth16 import prove as P
    from zkrollup_torch.ntt import ntt

    log_n = DOMAIN_LOG
    n = 1 << log_n
    edges = L.to_device(L.ints_to_limbs([0, 1, FR.p - 1]), dev)

    def fe(*shape):
        x = rand_fe(int(np.prod(shape))).view(*shape, 16)
        if shape[-1] >= 3:
            x[..., :3, :] = edges
        return x

    tab = lambda kind: ntt._TABLES.get(kind, log_n, dev)
    tw, twi = tab("twiddles"), tab("twiddles_inv")
    ninv = FR.const_mont(pow(n, FR.p - 2, FR.p), dev)
    x, x3, b, c = fe(n), fe(3, n), fe(n), fe(n)
    z = fe(1)[0]
    cases = {
        "forward": (x, tw, {}),
        "inverse": (x, twi, {"post": ninv}),
        "pre and post": (x, tw, {"pre": tab("coset"),
                                 "post": tab("ninv_coset")}),
        "plain-form post": (x, twi, {"post": tab("ninv_coset_inv_plain")}),
        "batch of 3": (x3, twi, {"post": tab("ninv_coset")}),
        "pointwise": (x, twi, {"pointwise": (b, c, z),
                               "post": tab("ninv_coset_inv_plain")}),
    }
    got, want = [], []
    for name, (xx, tt, kw) in cases.items():
        got.append(run_passes(cuda_mont.ntt_pass, xx, tt, **dict(kw)))
        want.append(run_passes(cuda_mont.ntt_pass_plain, xx, tt, **dict(kw)))
        log(f"  ntt_pass, 2^{log_n} transform, {name}: max_abs_err "
            f"{max_abs_err(got[-1:], want[-1:])}")
    # the 17 stages as 17 one-stage passes in place (random tables)
    tws = [rand_fe(1 << s) for s in range(log_n)]

    def all_stages(stage, y):
        for s, t in enumerate(tws):
            stage(FR, y, t, 1 << s)
        return y

    got.append(all_stages(cuda_mont.ntt_stage_, x.clone()))
    want.append(all_stages(cuda_mont.ntt_stage_plain_, x.clone()))
    record("ntt_pass", got, want,
           cuda_ms(lambda: ntt.transform(x), 50),
           cuda_ms(lambda: run_passes(cuda_mont.ntt_pass_plain, x, tw), 2),
           transform_bound(1, log_n))
    y = ntt.transform(x)
    (s0a, ka), (s0b, kb) = ntt.passes(log_n)
    evals = [fe(n) for _ in range(3)]
    zinv = fe(1)[0]
    extra = {
        "pass_ms": [cuda_ms(lambda: cuda_mont.ntt_pass(
                        FR, x, tw, s0a, ka, bitrev=True), 50),
                    cuda_ms(lambda: cuda_mont.ntt_pass(
                        FR, y, tw, s0b, kb, out=y), 50)],
        "pass_bound_ms": [transform_bound(1, log_n)[0] * ka / log_n,
                          transform_bound(1, log_n)[0] * kb / log_n],
        "batch3_ms": cuda_ms(lambda: ntt.transform(x3, True,
                                                   post=tab("ninv_coset")),
                             20),
        "batch3_bound_ms": transform_bound(3, log_n, 3 * n, 2)[0],
        "coset_intt_pointwise_ms": cuda_ms(lambda: ntt.transform(
            x, True, pointwise=(b, c, z),
            post=tab("ninv_coset_inv_plain")), 20),
        "coset_intt_pointwise_bound_ms": transform_bound(
            1, log_n, 3 * n, 4)[0],
        "one_stage_ms": cuda_ms(lambda: all_stages(cuda_mont.ntt_stage_,
                                                   x.clone()), 20) / log_n,
        "one_stage_bound_ms": bound(n // 2, 2 * n * VALUE_BYTES
                                    + n // 2 * VALUE_BYTES)[0],
        "quotient_ms": cuda_ms(lambda: P._quotient_plain(*evals, zinv), 20),
        "quotient_bound_ms": quotient_bound(log_n)[0],
    }
    results["ntt_pass"].update(extra)
    log("  ntt_pass: pass 1 (stages 0-{}, gather) {:.4f} ms, pass 2 "
        "(stages {}-{}) {:.4f} ms; batch of 3 inverse {:.4f} ms (bound "
        "{:.4f}); coset iNTT with the pointwise prologue {:.4f} ms (bound "
        "{:.4f}); one-stage pass {:.4f} ms a stage (bound {:.4f}); the "
        "quotient at 2^{} {:.4f} ms (bound {:.4f})".format(
            ka - 1, extra["pass_ms"][0], s0b, log_n - 1, extra["pass_ms"][1],
            extra["batch3_ms"], extra["batch3_bound_ms"],
            extra["coset_intt_pointwise_ms"],
            extra["coset_intt_pointwise_bound_ms"], extra["one_stage_ms"],
            extra["one_stage_bound_ms"], log_n, extra["quotient_ms"],
            extra["quotient_bound_ms"]))

    # fold[fr]: lazy sums of up to 64 terms a row, and the edge rows
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 1)
    sums = torch.randint(0, 64 * 65536, (n, 16), generator=gen, device=dev,
                         dtype=torch.int64)
    sums[0] = 0
    sums[1, :15], sums[1, 15] = 0xFFFF, (1 << 48) - 1
    sums[2] = torch.tensor([((5 * FR.p) >> (16 * i)) & 0xFFFF
                            for i in range(15)] + [(5 * FR.p) >> 240],
                           device=dev)
    folded = cuda_mont.fold(FR, sums)
    if L.limbs_to_ints(folded[:3]) != [0, ((1 << 288) - 1) % FR.p, 0]:
        raise AssertionError("fold[fr]: the edge rows are not V mod r")
    record("fold[fr]", [folded], [cuda_mont.fold_plain(FR, sums)],
           cuda_ms(lambda: cuda_mont.fold(FR, sums), 50),
           cuda_ms(lambda: cuda_mont.fold_plain(FR, sums), 3),
           bound(2 * n, n * (16 * 8 + VALUE_BYTES)))

    # mont_mul[fr] at its prove widths: gathered, and the witness's to_mont
    nv = WITNESS_ROWS
    w = rand_fe(nv)
    w[:3] = edges
    r2 = FR.r2_limbs(dev)
    results["mont_mul[fr]"].update(
        to_mont_ms=cuda_ms(lambda: FR.mont_mul(w, r2), 50),
        to_mont_bound_ms=bound(nv, 2 * nv * VALUE_BYTES)[0], gather=[])
    log(f"  mont_mul[fr] at the witness's {nv} lanes (to_mont): "
        f"{results['mont_mul[fr]']['to_mont_ms']:.4f} ms (bound "
        f"{results['mont_mul[fr]']['to_mont_bound_ms']:.4f})")
    for m in (GATHER_LANES, GATHER_WIDEST):
        a = rand_fe(m)
        a[:3] = edges
        idx = torch.randint(0, nv, (m,), generator=gen, device=dev)
        idx[:9] = torch.tensor([0, 1, 2] * 3, device=dev)
        err = max_abs_err([FR.mont_mul(a, w, idx)],
                          [cuda_mont.mont_mul_gather_plain(FR, a, w, idx)])
        rows = int(torch.unique(idx).numel())
        gbound = bound(m, (2 * m + rows) * VALUE_BYTES)
        row = {"lanes": m, "table_rows": nv, "max_abs_err": err,
               "ms": cuda_ms(lambda: FR.mont_mul(a, w, idx), 50),
               "plain_ms": cuda_ms(lambda: cuda_mont.mont_mul_gather_plain(
                   FR, a, w, idx), 3),
               "bound_ms": gbound[0], "bound_by": gbound[1],
               "index_select_then_mont_mul_ms": cuda_ms(
                   lambda: FR.mont_mul(a, w.index_select(0, idx)), 50)}
        results["mont_mul[fr]"]["gather"].append(row)
        log(f"  mont_mul[fr] gathered, {m} lanes over {nv} rows: max_abs_err "
            f"{err}  kernel {row['ms']:.4f} ms  (index_select, then "
            f"mont_mul: {row['index_select_then_mont_mul_ms']:.4f})  plain "
            f"{row['plain_ms']:.3f} ms  bound {gbound[0]:.4f} ms "
            f"({gbound[1]})")
        if err:
            raise AssertionError("mont_mul[fr]: the gathered kernel "
                                 f"disagrees with its plain version at {m} "
                                 "lanes")


def quotient_bound(log_n: int):
    """The bound of groth16.prove._quotient_plain on 2^log_n rows: seven
    transforms; the products of the two post tables (four transforms) and
    of the pointwise step (two a row); three evaluations read, h written,
    two twiddle and two post tables read."""
    n = 1 << log_n
    return bound(7 * log_n * n // 2 + 6 * n, (3 + 1 + 4) * n * VALUE_BYTES)


def point_operands(curve, dev, n: int) -> dict:
    """Phase 2's operands of the six point kernels of `curve`: {kernel: (fn,
    plain, args, lanes on the doubling path)}, n lanes of real points:
    affine tables from the native fixed-base engine, Jacobian operands with
    Z != 1 from plain adds, the special lanes written in.

    Special lanes: 0 P + P, 1 P + (-P), 2 inf + Q, 3 P + inf, 4 inf + inf.
    add, madd, add_nd: every case (on P + P add_nd, a kernel without the
    doubling path, gives its own deterministic result outside its
    contract); madd_nd: all but P + P; double: p with the infinity lanes 2
    and 4; add_z01: the same cases over operands with Z in {0, 1} only.
    Lane 0 (P + P) is the only lane on the doubling path of add, madd and
    add_z01."""
    import numpy as np
    from zkrollup_torch.curve import cuda_curve
    from zkrollup_torch.curve.g1 import G1
    from zkrollup_torch.fields import limbs as L
    from zkrollup_torch.native import engine

    rng = np.random.RandomState(SEED)
    scal = [int(v) for v in rng.randint(1, 1 << 62, size=3 * n)]
    fixed_base = (engine.g1_fixed_base_mont if curve is G1
                  else engine.g2_fixed_base_mont)
    x, y, _ = fixed_base(engine.ints_to_fr_bytes(scal), 3 * n)
    to_dev = lambda a: L.to_device(a, dev)
    F = curve.F
    if curve is G1:
        x, y = to_dev(x), to_dev(y)
    else:
        x, y = (to_dev(x[0]), to_dev(x[1])), (to_dev(y[0]), to_dev(y[1]))
    one = F.from_leaves([a.contiguous()
                         for a in F.leaves(F.one((3 * n,), dev))])
    aff = (x, y, one)          # Z = 1 points, three slices of n
    part = lambda k: curve.map(lambda a: a[k * n:(k + 1) * n].contiguous(),
                               aff)
    q = part(0)
    p = cuda_curve.add_plain(curve, part(1), part(2))   # Z != 1
    inf_pt = curve.infinity((n,), dev)

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

    lanes = {0: (q, q), 1: (q, curve.neg(q)), 2: (inf_pt, q),
             3: (p, inf_pt), 4: (inf_pt, inf_pt)}
    pa, qa = with_lanes(p, q, lanes)
    pm, qm = with_lanes(p, q, {k: v for k, v in lanes.items() if k})
    p01 = part(1)
    pz, qz = with_lanes(p01, q, {**lanes, 3: (p01, inf_pt)})
    g = curve.name
    c = cuda_curve
    return {
        f"{g}_madd_nd": (c.madd_nd, c.madd_nd_plain, (pm, qm), 0),
        f"{g}_add": (c.add, c.add_plain, (pa, qa), 1),
        f"{g}_madd": (c.madd, c.madd_plain, (pa, qa), 1),
        f"{g}_double": (c.double, c.double_plain, (pa,), 0),
        f"{g}_add_nd": (c.add_nd, c.add_nd_plain, (pa, qa), 0),
        f"{g}_add_z01": (c.add_z01, c.add_z01_plain, (pz, qz), 1),
    }


def take_lanes(curve, args, m: int, off: int = 0):
    """(lanes off .. off + m - 1 of `args`, repeated past their length;
    how many of them are lane 0, the one P == Q lane of the add)."""
    import torch
    n = curve.leaves(args[0])[0].shape[0]
    idx = (torch.arange(m, device=curve.leaves(args[0])[0].device) + off) % n
    return (tuple(curve.map(lambda a: a.index_select(0, idx), t)
                  for t in args), int((idx == 0).sum()))


def vote_lanes(case: str, warp: int) -> list:
    """Lanes of point_operands for a warp-vote case of a kernel whose warp
    holds `warp` lanes: a warp of distinct pairs and one P + P lane (or one
    P + (-P) lane), a warp of infinity + infinity only (H = R = 0 on every
    lane, no doubling), or a launch of 33 or 1,025 lanes whose P + P lane
    is in the ragged last warp. Lanes 5.. of point_operands are distinct
    pairs."""
    if case in ("one_p_plus_p", "one_p_minus_p"):
        k = warp // 2 + 1
        lane = 0 if case == "one_p_plus_p" else 1
        return (list(range(5, 5 + k)) + [lane]
                + list(range(5 + k, 4 + warp)))
    if case == "inf_plus_inf":
        return [4] * warp
    return list(range(5, 4 + int(case.split("_")[1]))) + [0]


def widths_of(name: str) -> list:
    """[(lanes, what)]: the widths beyond 2^16 at which phase 2 holds and
    times a point kernel of PROVE_SHAPES, SETUP_SHAPES, Z01_SHAPES or
    ND_SHAPES."""
    if name in ND_SHAPES:
        return [(m, "tools") for m in ND_SHAPES[name]]
    if name in Z01_SHAPES:
        return [(m, "msm_trees leaves") for m in Z01_SHAPES[name]]
    if name in SETUP_SHAPES:
        return ([(m, "setup") for m in SETUP_SHAPES[name]]
                + [(MSM_MADD_LANES, "msm")])
    return ([(m, "prove") for m in PROVE_SHAPES[name]]
            + ([(WAVE_LANES, "one wave")] if name.startswith("g1_") else []))


def check_widths(curve, name, fn, plain, args, results):
    """Phase 2, a point kernel of PROVE_SHAPES, SETUP_SHAPES, Z01_SHAPES or
    ND_SHAPES beyond 2^16 lanes: bit for bit against its plain version at
    widths_of(name), on ragged launches (RAGGED, at two offsets, and 1,025
    lanes), on one lane (six lanes, the special ones included: on the adds
    without a doubling path lanes 0 and 1 have H = 0) and, for the voting
    kernels
    of SETUP_SHAPES and Z01_SHAPES, on the warp-vote cases (VOTE_CASES at
    the kernel's warp); timed at those
    widths, beside the bound there, and on one lane. Operands are lanes of
    `args` (2^16 lanes, lane 0 the only P == Q lane of the add), repeated
    past 2^16."""
    import torch
    n = curve.leaves(args[0])[0].shape[0]
    take = lambda m, off=0: take_lanes(curve, args, m, off)
    doubles = name.endswith(("_add", "_madd", "_add_z01"))  # doubling path
    votes = name in SETUP_SHAPES or name in Z01_SHAPES

    def same(sub):
        return max_abs_err(curve.leaves(fn(curve, *sub)),
                           curve.leaves(plain(curve, *sub)))

    shapes = {}
    for m, what in widths_of(name):
        sub, n_dbl = take(m)
        err = same(sub)
        ms = cuda_ms(lambda: fn(curve, *sub), 20)
        bnd = lane_bound(name, m, n_dbl if doubles else 0)
        shapes[str(m)] = {"max_abs_err": err, "ms": ms, "bound_ms": bnd[0],
                          "bound_by": bnd[1]}
        log(f"  {name:13s} {m} lanes ({what}): max_abs_err {err}  kernel "
            f"{ms:.4f} ms  bound {bnd[0]:.4f} ms ({bnd[1]})")
        if err:
            raise AssertionError(f"{name}: kernel disagrees with its plain "
                                 f"version at {m} lanes")
    bad = [(m, off) for m, off in [(m, off) for m in RAGGED
                                   for off in (0, n - 7)] + [(1025, 0)]
           if same(take(m, off)[0])]
    bad += [(1, off) for off in range(6) if same(take(1, off)[0])]
    if votes:
        dev = curve.leaves(args[0])[0].device
        for case in VOTE_CASES:
            idx = torch.tensor(vote_lanes(case, WARP_LANES[curve.name]),
                               device=dev)
            if same(tuple(curve.map(lambda a: a.index_select(0, idx), t)
                          for t in args)):
                bad.append(case)
    if bad:
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version at (lanes, offset) or case {bad}")
    one, _ = take(1, 5)
    ms1 = cuda_ms(lambda: fn(curve, *one), 264)
    results[name].update(shapes=shapes, one_lane_ms=ms1)
    cases = (f", vote cases {VOTE_CASES} at {WARP_LANES[curve.name]} lanes "
             "a warp" if votes else "")
    log(f"  {name:13s} ragged {RAGGED} lanes at two offsets, 1025 lanes and "
        f"one lane (lanes 0-5)"
        f"{cases}: max_abs_err 0; one lane {ms1:.4f} ms")


def check_alu(dev, results):
    """Phase 2, the integer-unit kernels: each against its plain version,
    bit for bit, on the inputs of phase 7's rate run, (16, 2^ALU_LOG_N)
    and ALU_REPS (phase 7 times the kernel there), with the plain
    version's time; and at (16, 4096) and 256 reps. Each kernel's bound
    counts its loop's instructions by class, from cuobjdump -sass of the
    built alu library (profile_alu.sass_counts), logged per lane and
    rep."""
    import torch
    from zkrollup_torch import kernels
    from zkrollup_torch.tools import profile_alu
    small = profile_alu.check(dev)
    sass = profile_alu.sass_counts(kernels.build_info["paths"]["alu"])
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
        bnd = alu_bound(sass[op], 1 << ALU_LOG_N, ALU_REPS)
        per_rep = {c: v for c, v in sass[op].items() if c != "opcodes"}
        results[f"alu_{op}"] = {"max_abs_err": err, "plain_ms": plain_ms,
                                "bound_ms": bnd[0], "bound_by": bnd[1],
                                "library_ms": None,
                                "sass_per_rep": per_rep}
        log(f"  alu_{op:10s} loop instructions a lane and rep by class "
            f"{per_rep}; opcodes in the loop {sass[op]['opcodes']}")
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
    """Phase 3: the (2, 6) key on the card against setup_host's, the setup
    path's launches against SETUP_SHAPES and SETUP_LIMITS, its peak device
    memory, then the setup in parts (setup_parts)."""
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
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base_mem = torch.cuda.memory_allocated(dev)
    with cuda_normalize_calls() as norm:
        t0 = time.time()
        pk = prover.ensure_keys()
        torch.cuda.synchronize()
        card_s = time.time() - t0
    peak = torch.cuda.max_memory_allocated(dev) - base_mem
    count_path(launches, "setup")
    check_no_normalize("the setup", norm[0])
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
        f"{pk.domain_size}; {n_inf} infinity rows in a_g1; peak device "
        f"memory of the setup {peak / 2**30:.3f} GiB above the "
        f"{base_mem / 2**30:.3f} GiB held before it")
    bad = same_key(pk, host)
    if bad:
        raise AssertionError(f"card-made key differs from setup_host's: {bad}")
    log("  the two keys are equal byte for byte (tables, points, vk)")
    setup = launches["setup"]
    log("  launches on the setup path: " + ", ".join(
        f"{k} {v[0]} ({v[1]} lanes)" for k, v in setup.items() if v[0]))
    check_widest("setup", setup, SETUP_SHAPES)
    check_limits("setup", setup, SETUP_LIMITS)
    setup_parts(dev, r1cs, pk)
    return prover


def setup_parts(dev, r1cs, pk):
    """Phase 3: the setup on the card in parts, calling the functions of
    groth16/setup.py and msm/fixed_base.py one by one as setup does, on the
    host clock after a synchronize: the scalar derivation, the window
    tables' host build on a cold cache and their copy to the card, the
    scalars' ints_to_limbs and copy, the G1 fixed-base loop and its
    normalisation, the same for G2, the copies to the host and _key's host
    point multiplications (and, apart, the R1CS hash inside _key). The key
    so made must equal `pk`."""
    import torch
    from zkrollup_torch.fields import limbs as L
    from zkrollup_torch.groth16.keys import r1cs_digest
    from zkrollup_torch.groth16.setup import _key, _toxic_scalars
    from zkrollup_torch.msm import fixed_base as fb
    from zkrollup_torch.ref.bn254 import R as FR_MOD

    parts = {}

    def part(label, fn):
        torch.cuda.synchronize()
        t0 = time.time()
        out = fn()
        torch.cuda.synchronize()
        parts[label] = time.time() - t0
        return out

    for cached in (fb._g1_table_host, fb._g2_table_host, fb._g1_table,
                   fb._g2_table):
        cached.cache_clear()
    with cuda_normalize_calls() as calls:
        sc = part("scalar derivation",
                  lambda: _toxic_scalars(r1cs, SETUP_SEED))
        part("window tables, host build", lambda: (fb._g1_table_host(),
                                                    fb._g2_table_host()))
        part("window tables, to the card", lambda: (fb._g1_table(str(dev)),
                                                     fb._g2_table(str(dev))))
        limbs = part("scalars, ints_to_limbs", lambda: [
            L.ints_to_limbs([x % FR_MOD for x in sc[k]])
            for k in ("all_g1", "b_t")])
        s1, s2 = part("scalars, to the card",
                      lambda: [L.to_device(a, dev) for a in limbs])
        jac1 = part("G1 fixed-base loop", lambda: fb.fixed_base_g1(s1))
        aff1 = part("G1 normalisation", lambda: fb.g1_normalize_packed(jac1))
        jac2 = part("G2 fixed-base loop", lambda: fb.fixed_base_g2(s2))
        aff2 = part("G2 normalisation", lambda: fb.g2_normalize_packed(jac2))
    check_no_normalize("the setup's parts on the card", calls[0])

    def to_host():
        (x, y, inf), ((x0, x1), (y0, y1), inf2) = aff1, aff2
        return ((fb._host(x), fb._host(y), inf.cpu().numpy()),
                ((fb._host(x0), fb._host(x1)), (fb._host(y0), fb._host(y1)),
                 inf2.cpu().numpy()))

    g1_packed, b2 = part("copies to the host", to_host)
    key = part("_key (host point multiplications)",
               lambda: _key(r1cs, sc, g1_packed, b2))
    log(f"  setup in parts ({sum(parts.values()):.3f} s): " + ", ".join(
        f"{k} {v:.4f} s" for k, v in parts.items()))
    t0 = time.time()
    r1cs_digest(r1cs)
    log(f"  of _key, r1cs_digest (the key's hash of the R1CS): "
        f"{time.time() - t0:.4f} s")
    bad = same_key(key, pk)
    if bad:
        raise AssertionError(f"the key made in parts differs: {bad}")

    # the G2 normalisation's adds and subs on their kernels and on the
    # carry loop, in turns, each giving the same affine planes
    secs = {"kernels": [], "carry loop": []}
    for route in ("kernels", "carry loop", "carry loop", "kernels"):
        with (carry_loop_route() if route == "carry loop"
              else contextlib.nullcontext()):
            again = part("again", lambda: fb.g2_normalize_packed(jac2))
        secs[route].append(parts["again"])
        if max_abs_err([*again[0], *again[1], again[2]],
                       [*aff2[0], *aff2[1], aff2[2]]):
            raise AssertionError(f"the G2 normalisation differs with the "
                                 f"adds on the {route}")
    log("  G2 normalisation seconds, FieldCtx.add / sub on the add and sub "
        "kernels " + " ".join(f"{t:.4f}" for t in secs["kernels"])
        + ", on the carry loop " + " ".join(
            f"{t:.4f}" for t in secs["carry loop"]))


def proof_bytes(proof) -> bytes:
    """The proof as the verifier contract reads it: a, b, c coordinates as
    32-byte big-endian words."""
    (ax, ay), ((bx0, bx1), (by0, by1)), (cx, cy) = proof.a, proof.b, proof.c
    return b"".join(v.to_bytes(32, "big")
                    for v in (ax, ay, bx1, bx0, by1, by0, cx, cy))


def wei(eth) -> int:
    return int(Decimal(str(eth)) * 10 ** 18)


def demo_txs(cfg):
    """The batch of the demo rollup on `cfg`: the operator state after two
    deposits (operator/state.py), then the two signed transfers of
    cli/main.py. Returns (tree, txs)."""
    from zkrollup_torch.ref import eddsa
    from zkrollup_torch.tree.merkle import create_merkle_tree
    from zkrollup_torch.witness.assembler import (Transaction, format_tx,
                                                  hash_balance_tree_leaf)

    priv_a = (3461904823869495924446136355166658661994387995314494198873459573992912434327
              % (2 ** 250))
    priv_b = (6876489714123326193969274478259787479864255376696894364275539418009183638325
              % (2 ** 250))
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
    return tree, txs


def demo_batch(prover):
    """The demo rollup's batch, prepared (the witness)."""
    return prover.prepare_batch(*demo_txs(prover.cfg))


@contextlib.contextmanager
def cuda_normalize_calls():
    """Counts the calls of limbs.normalize (the carry loop that reads a
    flag back to the host on every pass) on CUDA tensors while open."""
    from zkrollup_torch.fields import limbs
    orig, calls = limbs.normalize, [0]

    def counted(t):
        calls[0] += t.device.type == "cuda"
        return orig(t)

    limbs.normalize = counted
    try:
        yield calls
    finally:
        limbs.normalize = orig


def check_no_normalize(what: str, calls: int) -> None:
    """limbs.normalize never ran on a CUDA tensor during `what`."""
    log(f"  limbs.normalize on CUDA tensors during {what}: {calls}")
    if calls:
        raise AssertionError(f"limbs.normalize ran {calls} times on CUDA "
                             f"tensors during {what}")


def main_path(dev, prover, launches):
    """Phase 4: one BatchProcessTx(2, 6) batch through the port's prover."""
    import random
    from zkrollup_torch import kernels
    from zkrollup_torch.groth16.prove import prove, prove_host
    from zkrollup_torch.ref.bn254 import R as FR_MOD

    pk = prover.ensure_keys()
    r1cs = prover.structure_r1cs()
    tree, txs = demo_txs(prover.cfg)
    prep = prover.prepare_batch(tree, txs)
    log(f"  witness {prep.witness_s:.3f} s, "
        f"{len(prep.public_signals)} public signals")

    r0, s0 = PINNED_RS
    kernels.reset_launches()
    with cuda_normalize_calls() as norm:
        t0 = time.time()
        proof = prover.prove_prepared(prep, r=r0, s=s0)
        first_s = time.time() - t0
    count_path(launches, "prove")
    launches["prove_normalize_cuda"] = norm[0]
    log(f"  first proof on {dev} with the card-made key (self-verified): "
        f"{first_s:.3f} s (prove {prover.stats.prove_s:.3f}, verify "
        f"{prover.stats.verify_s:.3f}); limbs.normalize on CUDA tensors "
        f"{norm[0]} times")

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

    t0 = time.time()
    bproof, signals, final_tree = prover.prove_batch(tree, txs, r=r0, s=s0)
    log(f"  prove_batch (witness, proof, self-verify): "
        f"{time.time() - t0:.3f} s")
    if proof_bytes(bproof) != proof_bytes(proof):
        raise AssertionError("prove_batch's proof differs from "
                             "prove_prepared's and the native engine's")
    if (signals != prep.public_signals
            or final_tree.root != prep.final_tree.root):
        raise AssertionError("prove_batch's public signals or final tree "
                             "differ from prepare_batch's")
    log("  its bytes equal prove_prepared's and the native engine's; its "
        "public signals and final tree equal prepare_batch's")

    rng = random.Random(SEED)
    steady = []
    for i in range(3):
        r, s = rng.randrange(1, FR_MOD), rng.randrange(1, FR_MOD)
        t0 = time.time()
        prover.prove_prepared(prep, r=r, s=s)   # raises unless it verifies
        steady.append(time.time() - t0)
        st = prover.stats
        log(f"  proof {i + 1} at random (r, s): {steady[-1]:.3f} s, "
            f"verified; prove {st.prove_s:.3f}, verify {st.verify_s:.3f}")
    log(f"  steady state: {len(steady) / sum(steady):.3f} proofs/s "
        f"(prove_prepared: prove + self-verify, no stage syncs; witness "
        f"{prep.witness_s:.3f} s apart)")
    for i in range(2):
        stages = {}
        t0 = time.time()
        prove(pk, r1cs, prep.witness, r=r0, s=s0, device=dev, c=prover.c,
              timings=stages)
        log(f"  prove(timings=) {i + 1}: {time.time() - t0:.3f} s, stages "
            "(a device synchronize after each) " + ", ".join(
                f"{k} {v:.3f}" for k, v in stages.items()))
    for i in range(2):
        t0 = time.time()
        hproof = prove(pk, r1cs, prep.witness, r=r0, s=s0, device=dev,
                       c=prover.c, g2_backend="host")
        log(f"  prove(g2_backend='host') {i + 1}: {time.time() - t0:.3f} s "
            "(the G2 MSM on the native engine while the card runs G1"
            + (", the b2 table packed for it first)" if i == 0 else ")"))
        if proof_bytes(hproof) != proof_bytes(proof):
            raise AssertionError("the proof with g2_backend='host' differs "
                                 "from the device path's")
    log("  its bytes equal the device path's")
    profile_proof(dev, prover, prep)
    return prep, proof_bytes(proof)


def device_time(prof):
    """(the device's busy seconds: the union of its kernels and copies in a
    torch.profiler trace; [(microseconds, count, name)] by kernel name,
    largest first). The profiler's device-side spans of record_function
    ranges (gpu_user_annotation: prove()'s stage labels) are no device
    work, and the lead-in launches (profiled) no work of the window's:
    both are left out."""
    import torch
    from zkrollup_torch.tools.trace_prove import LABELS, LEAD_NAME
    cuda = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and e.name not in LABELS and LEAD_NAME not in e.name]
    busy, end = 0.0, float("-inf")
    for a, b in sorted((e.time_range.start, e.time_range.end) for e in cuda):
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    by_name = collections.defaultdict(lambda: [0.0, 0])
    for e in cuda:
        by_name[e.name][0] += e.time_range.end - e.time_range.start
        by_name[e.name][1] += 1
    return busy / 1e6, sorted(((t, c, name) for name, (t, c)
                               in by_name.items()), reverse=True)


def profile_proof(dev, prover, prep):
    """Phase 4: one steady proof (prove_prepared) under torch.profiler,
    after lead-in launches (profiled): the device's busy share (the union of
    its kernels and copies over the wall time), the device time by kernel
    name and by stage label (stage_table), peak device memory; then
    evals_quotient's parts on the host clock, each ended by a device
    synchronize, three times: the witness encoding (ints_to_limbs, the
    copy, to_mont), _abc_evals and the quotient."""
    import torch
    from zkrollup_torch import kernels
    from zkrollup_torch.fields import limbs as L
    from zkrollup_torch.fields.mont import FR
    from zkrollup_torch.groth16 import prove as P
    from zkrollup_torch.groth16.qap import to_coo
    from zkrollup_torch.ref.bn254 import R as FR_MOD

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    before = dict(kernels.LAUNCHES)
    w = profiled(dev, lambda: prover.prove_prepared(
        prep, r=PINNED_RS[0], s=PINNED_RS[1]))
    wall = w["wall_s"]
    peak = torch.cuda.max_memory_allocated(dev)
    launched = {k: kernels.LAUNCHES[k] - v for k, v in before.items()}
    busy_s, rows = device_time(w["prof"])
    total = sum(t for t, _, _ in rows) / 1e6
    st = prover.stats
    log(f"  profile of one steady proof (prove_prepared; {lead_note(w)}): "
        f"wall "
        f"{wall:.4f} s (prove {st.prove_s:.4f}, verify {st.verify_s:.4f}); "
        f"device busy {busy_s:.4f} s, share {busy_s / wall:.3f} of the "
        f"wall, {busy_s / st.prove_s:.3f} of prove; device time by name "
        f"{total:.4f} s over {len(rows)} kernel names; peak device memory "
        f"{peak / 2 ** 30:.3f} GiB")
    for t, count, key in rows[:16]:
        log(f"    {t / 1e3:9.3f} ms  {count:6d} x  {key[:90]}")
    stage_table(w["events"], wall, launched, w["lead"])

    coo = to_coo(prover.structure_r1cs())
    m = coo.m
    zinv = FR.const_mont(pow((pow(P.COSET_SHIFT, m, FR_MOD) - 1) % FR_MOD,
                             FR_MOD - 2, FR_MOD), dev)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    for i in range(3):
        limbs, t_enc = timed(lambda: L.ints_to_limbs(
            [w % FR_MOD for w in prep.witness]))
        w_mont, t_dev = timed(lambda: FR.to_mont(L.to_device(limbs, dev)))
        evals, t_abc = timed(lambda: P._abc_evals(P._coo_on(coo, dev),
                                                  w_mont, m))
        _, t_q = timed(lambda: P._quotient_plain(*evals, zinv))
        log(f"  evals_quotient in parts {i + 1}: ints_to_limbs of "
            f"{len(prep.witness)} ints {t_enc:.4f} s, copy and to_mont "
            f"{t_dev:.4f} s, _abc_evals {t_abc:.4f} s, quotient {t_q:.4f} s")


def stage_table(events, wall: float, launched: dict, lead: int) -> None:
    """Phase 4: the profiled proof's device time by stage label
    (trace_prove.by_label of its trace events: each kernel and copy goes to
    the label open on the host thread at its launch, matched by correlation
    id). Fails unless the four labels opened once each, in the reference's
    order, and each kernel of LABEL_KERNELS that launched during the proof
    has device time under its label."""
    from zkrollup_torch.tools import trace_prove

    order = trace_prove.label_order(events)
    rows = trace_prove.by_label(events)
    log("  the same proof by stage label (device time of the kernels and "
        "copies launched inside each; span: the profiler's own "
        "gpu_user_annotation, idle gaps included):")
    for line in trace_prove.table(rows, wall, lead):
        log("    " + line)
    if order != list(trace_prove.LABELS):
        raise AssertionError(f"stage labels of the profiled proof: {order}")
    for label, kern in LABEL_KERNELS.items():
        names = rows[label]["names"]
        for k, sym in kern.items():
            if launched[k] and not any(sym in n for n in names):
                raise AssertionError(
                    f"{label}: {k} launched {launched[k]} times in the "
                    "profiled proof, no device time attributed to the label")


def keep_prove_operands(prover, prep):
    """One more proof at PINNED_RS, with cuda_curve.add and madd_nd wrapped
    here for its length only: clones of the operands of its every g1_add
    launch and of its g1_madd_nd launch MADD_ND_KEPT. Returns ({lanes:
    (p, q)} of the g1_add launches, in launch order, and (p, q) of the
    g1_madd_nd launch)."""
    from zkrollup_torch.curve import cuda_curve
    add, madd_nd = cuda_curve.add, cuda_curve.madd_nd
    adds, madds = [], []
    clone = lambda curve, *ps: tuple(curve.map(lambda a: a.clone(), p)
                                     for p in ps)

    def add_kept(curve, p, q):
        if curve.name == "g1":
            adds.append(clone(curve, p, q))
        return add(curve, p, q)

    def madd_nd_kept(curve, p, q):
        if curve.name == "g1":
            madds.append(clone(curve, p, q) if len(madds) == MADD_ND_KEPT
                         else None)
        return madd_nd(curve, p, q)

    cuda_curve.add, cuda_curve.madd_nd = add_kept, madd_nd_kept
    try:
        prover.prove_prepared(prep, r=PINNED_RS[0], s=PINNED_RS[1])
    finally:
        cuda_curve.add, cuda_curve.madd_nd = add, madd_nd
    return adds, madds[MADD_ND_KEPT]


def widest(adds, k: int = 2) -> list:
    """The k widest launches of `adds`, widest first."""
    lanes = lambda pq: pq[0][0].shape[0]
    return sorted(adds, key=lanes, reverse=True)[:k]


def doubling_lanes(curve, p, q):
    """(n,) bools: the lanes of the add p + q whose doubling path's result
    survives the selects, H = R = 0 with neither operand infinite: the
    lanes of jac_add_lane's warp vote (csrc/curve.cuh)."""
    from zkrollup_torch.curve import cuda_curve
    F = curve.F
    _, H, R = cuda_curve._add_path(F, p, q)
    return (F.is_zero(H) & F.is_zero(R) & ~F.is_zero(p[2])
            & ~F.is_zero(q[2]))[:, 0]


def check_prove_operands(adds, madd, results):
    """Phase 4, the G1 kernels on one proof's own operands: for each g1_add
    launch its lanes and 32-lane warps on the doubling path; g1_add at its
    two widest launches (PROVE_SHAPES) and g1_madd_nd at one launch, bit for
    bit against the plain versions and timed beside the bound there (the
    doubling products counted on the doubling lanes)."""
    import torch
    from zkrollup_torch.curve import cuda_curve
    from zkrollup_torch.curve.g1 import G1

    shares = []
    for k, (p, q) in enumerate(adds):
        need = doubling_lanes(G1, p, q)
        n = need.numel()
        warps = torch.nn.functional.pad(need, (0, -n % 32)).view(-1, 32)
        warps = warps.any(dim=1)
        share = {"lanes": n, "doubling_lanes": int(need.sum()),
                 "warps": warps.numel(), "doubling_warps": int(warps.sum())}
        shares.append(share)
        log(f"  g1_add launch {k + 1:2d} of the proof: {n:6d} lanes, "
            f"{share['doubling_lanes']} on the doubling path "
            f"({share['doubling_lanes'] / n:.6f}), "
            f"{share['doubling_warps']} of {share['warps']} warps "
            f"({share['doubling_warps'] / share['warps']:.6f})")
    by_lanes = {s["lanes"]: s["doubling_lanes"] for s in shares}
    cases = [("g1_add", cuda_curve.add, cuda_curve.add_plain, pq)
             for pq in widest(adds)]
    cases.append(("g1_madd_nd", cuda_curve.madd_nd, cuda_curve.madd_nd_plain,
                  madd))
    got_widths = {name: () for name, *_ in cases}
    rows = {name: [] for name in got_widths}
    for name, fn, plain, (p, q) in cases:
        m = G1.leaves(p)[0].shape[0]
        got_widths[name] += (m,)
        err = max_abs_err(G1.leaves(fn(G1, p, q)), G1.leaves(plain(G1, p, q)))
        ms = cuda_ms(lambda: fn(G1, p, q), 20)
        n_dbl = by_lanes[m] if name == "g1_add" else 0
        bnd = lane_bound(name, m, n_dbl)
        rows[name].append({"lanes": m, "doubling_lanes": n_dbl,
                           "max_abs_err": err, "ms": ms, "bound_ms": bnd[0]})
        log(f"  {name:13s} {m} lanes, the proof's operands: max_abs_err "
            f"{err}  kernel {ms:.4f} ms  bound {bnd[0]:.4f} ms ({bnd[1]}; "
            f"{n_dbl} doubling lanes)")
        if err:
            raise AssertionError(f"{name}: kernel disagrees with its plain "
                                 f"version on the proof's operands ({m} "
                                 "lanes)")
    for name, ws in got_widths.items():
        if ws != PROVE_SHAPES[name]:
            raise AssertionError(f"{name}: the proof's operands are {ws} "
                                 f"lanes wide, PROVE_SHAPES says "
                                 f"{PROVE_SHAPES[name]}")
        results[name]["prove_operands"] = rows[name]
    results["g1_add"]["doubling_share"] = shares


def msm_phase(dev, pk, witness, launches):
    """Phase 5: the MSMs over the real a and b2 tables (the a table holds
    duplicate points and infinity rows) against the native engine's
    Pippenger: msm() with the default strategy ("msm" path), then the
    other three strategies and msm_glv ("msm_trees" path); then, per
    curve, the Horner kernel against the one-lane route (horner_loop) on
    the tables' window sums, limb for limb, and msm() timed through
    each; then msm(tree="affine") timed with the inversion kernel and with
    the route before it (inv_loop_route)."""
    import numpy as np
    import torch
    from zkrollup_torch import kernels
    from zkrollup_torch.curve import g1, g2
    from zkrollup_torch.fields import limbs as L
    from zkrollup_torch.msm.glv import msm_glv
    from zkrollup_torch.msm.msm import msm, window_sums
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
    with cuda_normalize_calls() as norm:
        for name, curve, tbl in (("g1", g1.G1, a_tbl), ("g2", g2.G2, b_tbl)):
            times[f"msm_{name}_scan"] = timed(
                f"msm({name.upper()}, c=12, distinct=False, tree='scan')",
                name, lambda: msm(curve, tbl, sc, c=12, distinct=False))
    count_path(launches, "msm")
    check_no_normalize("the msm path", norm[0])

    kernels.reset_launches()
    with cuda_normalize_calls() as norm:
        for tree in ("scan1", "affine", "jacobian"):
            for name, curve, tbl in (("g1", g1.G1, a_tbl),
                                     ("g2", g2.G2, b_tbl)):
                times[f"msm_{name}_{tree}"] = timed(
                    f"msm({name.upper()}, c=12, tree={tree!r})", name,
                    lambda: msm(curve, tbl, sc, c=12, tree=tree))
        for tree in ("scan", "jacobian"):
            times[f"msm_glv_{tree}"] = timed(
                f"msm_glv(a_g1, c=12, tree={tree!r})", "g1",
                lambda: msm_glv(a_tbl, sc, c=12, tree=tree))
    count_path(launches, "msm_trees")
    check_no_normalize("the msm_trees path", norm[0])

    # the Horner's two routes on these tables: on one set of window sums,
    # the kernel's limbs against the one-lane route's; then msm() (window
    # sums, one Horner launch) against the window sums and horner_loop,
    # in turns, each equal to the native engine
    for name, curve, tbl in (("g1", g1.G1, a_tbl), ("g2", g2.G2, b_tbl)):
        wsum, c = window_sums(curve, tbl, sc, c=12)
        if max_abs_err(curve.leaves(curve.horner(wsum, c)),
                       curve.leaves(horner_loop(curve, wsum, c))):
            raise AssertionError(f"{name}_horner differs from the one-lane "
                                 "route on the key's window sums")
        routes = {"horner": lambda: msm(curve, tbl, sc, c=12),
                  "loop": lambda: horner_loop(
                      curve, *window_sums(curve, tbl, sc, c=12))}
        secs = {r: [] for r in routes}
        for r in ("horner", "loop", "loop", "horner") * 2:
            secs[r].append(timed(f"msm({name.upper()}), {r} route", name,
                                 routes[r]))
        times[f"msm_{name}_routes"] = secs
        log(f"  msm({name.upper()}) on the key's table, the Horner kernel's "
            f"limbs equal the one-lane route's on its window sums; seconds, "
            f"Horner kernel " + " ".join(f"{t:.4f}" for t in secs["horner"])
            + ", one-lane route " + " ".join(f"{t:.4f}" for t in secs["loop"]))

    # the affine strategy's batched inversions: one inv[fq] / inv[fq2]
    # launch a tree level against the route before the kernel (the product
    # tree, its root by inv_loop); and its adds and subs on their kernels
    # against the carry loop (carry_loop_route); in turns, each equal to
    # the native engine
    routes = {"kernel": ("inversion and adds by kernel",
                         contextlib.nullcontext),
              "loop": ("inversion by product tree and inv_loop",
                       inv_loop_route),
              "carry": ("adds on the carry loop", carry_loop_route)}
    for name, curve, tbl in (("g1", g1.G1, a_tbl), ("g2", g2.G2, b_tbl)):
        def affine(route):
            with routes[route][1]():
                return msm(curve, tbl, sc, c=12, tree="affine")
        secs = {r: [] for r in routes}
        for r in ("kernel", "loop", "carry", "carry", "loop", "kernel"):
            secs[r].append(timed(f"msm({name.upper()}, tree='affine'), "
                                 f"{routes[r][0]}", name,
                                 lambda: affine(r)))
        times[f"msm_{name}_affine_routes"] = secs
        log(f"  msm({name.upper()}, tree='affine') seconds, " + "; ".join(
            f"{routes[r][0]} " + " ".join(f"{t:.4f}" for t in secs[r])
            for r in routes))
    return times


def glv_phase(dev, prover, prep, want_bytes, launches):
    """Phase 6: the GLV prover with the Jacobian merge tree on the key of
    phase 3, the batch of phase 4 at its pinned (r, s)."""
    from zkrollup_torch import kernels
    from zkrollup_torch.operator.prover import TxProver

    gp = TxProver(prover.cfg, key_path=None, setup_seed=SETUP_SEED,
                  device=dev, c=12, glv=True, tree="jacobian")
    gp.pk = prover.ensure_keys()
    kernels.reset_launches()
    t0 = time.time()
    proof = gp.prove_prepared(prep, r=PINNED_RS[0], s=PINNED_RS[1])
    first_s = time.time() - t0
    count_path(launches, "prove_glv")
    log(f"  first GLV proof (tree='jacobian', self-verified): {first_s:.3f} s"
        f" (prove {gp.stats.prove_s:.3f}, verify {gp.stats.verify_s:.3f})")
    if proof_bytes(proof) != want_bytes:
        raise AssertionError("the GLV proof differs from the default proof "
                             "and the native engine's")
    log("  its bytes equal the default proof's and the native engine's")
    t0 = time.time()
    gp.prove_prepared(prep, r=PINNED_RS[0], s=PINNED_RS[1])
    log(f"  second GLV proof: {time.time() - t0:.3f} s (prove "
        f"{gp.stats.prove_s:.3f}, verify {gp.stats.verify_s:.3f})")


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
        if op in ("mul", "umulhi", "mul16", "mad_lo", "mad_hi"):
            ratio = (f"  {r['lane_ops_per_s'] / INT_MULS_PER_S:.3f} of the "
                     "multiply peak")
        bnd = results[f"alu_{op}"]["bound_ms"]
        log(f"    {profile_alu.OPS[op]:40s} {r['ms']:8.4f} ms  "
            f"{r['lane_ops_per_s'] / 1e12:7.3f} T lane-ops/s{ratio}; "
            f"bound {bnd:.4f} ms, {bnd / r['ms']:.3f} of it")
        results[f"alu_{op}"].update(ms=r["ms"],
                                    lane_ops_per_s=r["lane_ops_per_s"])
    g2_kernel_check.run(dev, log=lambda m: log("    " + m))
    log(f"  g2_kernel_check on {dev}: every G2 kernel equals "
        "zkrollup_torch.ref")
    count_path(launches, "tools")


def curve_path(dev, launches):
    """Phase 7, the "curve" path: JacobianCurve.add_nd and double over G1,
    the public methods that reach g1_add_nd and g1_double, on distinct
    lanes, P + (-P), infinities and non-unit Z, against
    zkrollup_torch.ref."""
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
    got = [g1.G1.add_nd(jac(p), jac(q)), g1.G1.add_nd(s1, s2),
           g1.G1.double(s1)]
    count_path(launches, "curve")
    sums = [ref.g1_add(a, b) for a, b in zip(p, q)]
    want = [sums, [ref.g1_add(a, ref.g1_add(b, b)) for a, b in zip(sums, q)],
            [ref.g1_add(a, a) for a in sums]]
    if [g1.to_affine_host(g) for g in got] != want:
        raise AssertionError("G1.add_nd or G1.double differs from "
                             "zkrollup_torch.ref")
    log(f"  G1.add_nd on {dev} (g1_add_nd), Z = 1 and non-unit Z, and "
        "G1.double (g1_double), non-unit Z and infinity: equal "
        "zkrollup_torch.ref")


def measure_phase(dev, prover, launches) -> dict:
    """Phase 7, the "measure" path: the measurement tools, each once at
    the reference's sizes, with their results held (each tool raises
    otherwise): trace_prove on the (2,6) demo batch of the reference's
    tools (tools/prove_breakdown.py's two sends) with phase 3's key, its
    labels in order and with device time; prove_breakdown on the same
    batch, its stages giving prove()'s bytes; profile_msm at 2^17, c = 12
    against the native engine; profile_msm2 (2^17 distinct points and the
    prove-shaped four tables) against the engine; msm_sweep over SWEEP at
    2^17, each equal to the engine; profile_kernels at 2^20 against the
    plain versions. The tools' distinct points are made anew in a
    temporary directory. Then mesh_prove_check on MESH_CIRCUIT over a
    virtual mesh of MESH_DEVICES shards in a process of its own (its
    launches not counted here), which must print MESH WITHDRAW OK.
    Returns the headline numbers."""
    import tempfile
    from zkrollup_torch import kernels
    from zkrollup_torch.tools import (common, msm_sweep, profile_kernels,
                                      profile_msm, profile_msm2,
                                      prove_breakdown, trace_prove)

    out = {}
    r1cs = prover.structure_r1cs()
    with tempfile.TemporaryDirectory() as tmp:
        build_dir, common.BUILD_DIR = common.BUILD_DIR, tmp
        try:
            _, prep = common.demo_batch(dev, prover=prover)
            kernels.reset_launches()
            t0 = time.time()
            tr = trace_prove.run(prover.pk, r1cs, prep.witness,
                                 prep.public_signals, dev, tmp, "tx")
            log(f"  trace_prove --circuit tx ({time.time() - t0:.1f} s; "
                f"the traced proof verified; labels {', '.join(tr['order'])}"
                f"; Chrome trace {os.path.getsize(tr['trace'])} bytes):")
            log(f"    kernels lost after the lead-in, by window: "
                f"{tr['lost']}")
            for line in trace_prove.table(tr["rows"], tr["wall_s"],
                                          tr["lead"]):
                log("    " + line)
            if tr["order"] != list(trace_prove.LABELS) or any(
                    tr["rows"][k]["us"] <= 0 for k in trace_prove.LABELS):
                raise AssertionError("trace_prove: a stage label is missing "
                                     "or has no device time")
            out["trace"] = tr
            t0 = time.time()
            bd = prove_breakdown.run(prover.pk, r1cs, prep.witness, dev)
            log(f"  prove_breakdown ({time.time() - t0:.1f} s; the stages' "
                "proof equals prove()'s bytes):")
            for line in prove_breakdown.lines(bd):
                log("    " + line)
            out["breakdown"] = bd
            t0 = time.time()
            pm = profile_msm.run(dev, MEASURE_MSM_LOG, 12)
            log(f"  profile_msm 2^{MEASURE_MSM_LOG}, c = {pm['c']}, scan "
                f"({time.time() - t0:.1f} s; msm() equals the native "
                "engine):")
            for line in profile_msm.lines(pm):
                log("    " + line)
            out["profile_msm"] = pm
            t0 = time.time()
            pm2 = profile_msm2.run(dev, MEASURE_MSM_LOG, 12)
            log(f"  profile_msm2 2^{MEASURE_MSM_LOG} distinct and the prove "
                f"shape, c = 12, chunk 128 ({time.time() - t0:.1f} s; both "
                "equal the native engine):")
            for line in profile_msm2.lines(pm2):
                log("    " + line)
            out["profile_msm2"] = pm2
            t0 = time.time()
            want = pm2["results"]["a"]
            out["sweep"] = []
            for c, chunk in SWEEP:
                sw = msm_sweep.run(dev, c, chunk, MEASURE_MSM_LOG, want=want)
                log("    " + msm_sweep.line(sw))
                out["sweep"].append(sw)
            log(f"  msm_sweep: {len(SWEEP)} configurations at "
                f"2^{MEASURE_MSM_LOG}, each equal to the native engine "
                f"({time.time() - t0:.1f} s)")
            t0 = time.time()
            pk_ = profile_kernels.run(dev, MEASURE_KERNELS_LOG)
            log(f"  profile_kernels 2^{MEASURE_KERNELS_LOG} "
                f"({time.time() - t0:.1f} s; every result holds):")
            for line in profile_kernels.lines(pk_):
                log("    " + line)
            out["kernels"] = pk_
            count_path(launches, "measure")
        finally:
            common.BUILD_DIR = build_dir

    t0 = time.time()
    res = subprocess.run(
        [sys.executable, "-m", "zkrollup_torch.tools.mesh_prove_check",
         "--circuit", MESH_CIRCUIT, "--devices", str(MESH_DEVICES),
         "--device", str(dev)], cwd=HERE, capture_output=True, text=True,
        timeout=600)
    for line in res.stdout.splitlines():
        log(f"    {line}")
    log(f"  mesh_prove_check --circuit {MESH_CIRCUIT} --devices "
        f"{MESH_DEVICES}: exit code {res.returncode}, "
        f"{time.time() - t0:.1f} s")
    if res.returncode or f"MESH {MESH_CIRCUIT.upper()} OK" not in res.stdout:
        raise AssertionError("mesh_prove_check failed:\n"
                             + res.stderr[-3000:])
    return out


def profiled(dev, fn, whole: bool = True) -> dict:
    """fn() under torch.profiler (CPU and CUDA), the device synchronised
    inside: trace_prove.whole_window (after a lead-in of spin-kernel
    launches, made longer until no launch after it lost its kernel) or,
    with whole=False, one window with no lead-in, as it was read before.
    Returns whole_window's dict and under "kept" the lead-in launches whose
    kernel the profiler kept."""
    import tempfile
    from zkrollup_torch.tools import trace_prove
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "window.json")
        if whole:
            w = trace_prove.whole_window(dev, fn, path)
        else:
            prof, events, wall, out = trace_prove.window(dev, fn, path)
            w = {"prof": prof, "events": events, "wall_s": wall, "out": out,
                 "lead": 0, "lost": []}
    w["kept"] = sum(1 for e in w["events"] if e.get("cat") == "kernel"
                    and trace_prove.LEAD_NAME in e["name"])
    return w


def lead_note(w: dict) -> str:
    """How a profiled() window's lead-in went, for the log."""
    return (f"{w['lead']} lead-in launches, {w['kept']} kept; kernels lost "
            f"after the lead-in, by window: {w['lost']}")


def profiler_check(dev, when: str) -> None:
    """How many of a short window's first device events torch.profiler
    drops at this point of the process: one aten op and one mont_mul[fq]
    launch (ctypes) profiled as they are, their device events counted,
    then again in a whole window (profiled). Launches made here count on
    no path: every path counts from a reset after this."""
    import torch
    from zkrollup_torch.fields.mont import FQ

    a = torch.ones((1 << 10, 16), dtype=torch.int32, device=dev)
    torch.cuda.synchronize()
    w = profiled(dev, lambda: FQ.mont_mul(a + 1, a), whole=False)
    bare = sum(c for _, c, _ in device_time(w["prof"])[1])
    w = profiled(dev, lambda: FQ.mont_mul(a + 1, a))
    led = sum(c for _, c, _ in device_time(w["prof"])[1])
    log(f"  profiler check {when}: one aten op and one ctypes launch, "
        f"{bare} of 2 device events recorded; in a whole window {led} of 2 "
        f"({lead_note(w)})")


# -- phase 9: the operator loop ----------------------------------------------

LOOP_PRIV = (1234567890123456789, 9876543210987654321)   # users A and B
WITHDRAW_NULLIFIER = 0x5eed


def run_cli(argv) -> tuple:
    """zkrollup_torch.cli.main(argv) in this process, its standard output
    captured and logged indented. Returns (exit code, output)."""
    import io
    from zkrollup_torch.cli import main as cli
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(argv)
    for line in out.getvalue().splitlines():
        log(f"    | {line}")
    return rc, out.getvalue()


class LoopEnv:
    """One operator over a fresh chain simulator: contract, state, queue,
    daemon and app around `prover` (cli/main.py's wiring)."""

    def __init__(self, prover):
        from zkrollup_torch.chain.simulator import RollUpContract
        from zkrollup_torch.operator.batchd import BatchDaemon
        from zkrollup_torch.operator.queue import TxQueue
        from zkrollup_torch.operator.service import OperatorApp
        from zkrollup_torch.operator.state import OperatorState
        from zkrollup_torch.ref import eddsa
        cfg = prover.cfg
        self.contract = RollUpContract(cfg, tx_vk=prover.ensure_keys().vk,
                                       withdraw_vk=None)
        self.state = OperatorState(cfg)
        self.queue = TxQueue()
        self.daemon = BatchDaemon(cfg, self.state, self.queue, prover,
                                  self.contract)
        self.app = OperatorApp(cfg, self.state, self.queue, self.contract,
                               self.daemon)
        self.pubs = [eddsa.gen_public_key(k) for k in LOOP_PRIV]

    def deposit(self, eth_a, eth_b):
        for pub, eth in zip(self.pubs, (eth_a, eth_b)):
            self.contract.deposit(pub[0], pub[1], wei(eth))
        self.app.sync_chain()

    def send_body(self, nonce, amount, fee) -> dict:
        from zkrollup_torch.ref import eddsa
        from zkrollup_torch.witness.assembler import Transaction, format_tx
        tx = Transaction(0, 1, wei(amount), wei(fee), nonce)
        tx.signature = eddsa.sign(LOOP_PRIV[0], format_tx(tx))
        return {"from": 0, "to": 1, "amount": str(tx.amount),
                "fee": str(tx.fee), "nonce": nonce,
                "signature": {"R8": [str(tx.signature.R8[0]),
                                     str(tx.signature.R8[1])],
                              "S": str(tx.signature.S)}}

    def send(self, nonces, amount=0.1, fee=0.01):
        for n in nonces:
            resp = self.app.post_send(self.send_body(n, amount, fee))
            if resp != {"status": "Transaction accepted"}:
                raise AssertionError(f"/send nonce {n}: {resp}")

    def check(self, what, eth_a, nonce_a, eth_b, fees):
        """The contract's balances and fees, and the operator's root equal
        to the contract's."""
        from zkrollup_torch.ref.mimc import multi_hash
        a, b = (self.contract.get_user_data(multi_hash(list(p)))
                for p in self.pubs)
        got = (a[3], a[4], b[3], self.contract.get_accrued_fees())
        want = (wei(eth_a), nonce_a, wei(eth_b), wei(fees))
        roots = (self.state.load_tree().root,
                 self.contract.balance_tree.get_root())
        log(f"  {what}: contract A {a[3] / 1e18} ETH nonce {a[4]}, B "
            f"{b[3] / 1e18} ETH, fees {got[3] / 1e18} ETH; operator root "
            + ("equals" if roots[0] == roots[1] else "DIFFERS from")
            + " the contract's")
        if got != want or roots[0] != roots[1]:
            raise AssertionError(f"{what}: contract {got}, want {want}; "
                                 f"roots {roots}")


@contextlib.contextmanager
def batch_records(prover):
    """Each proof prove_prepared makes while open (the daemon's step and
    run_pipeline both prove through it): (assemble_s and synth_s of its
    batch's witness, prove_s, verify_s)."""
    records = []
    orig = prover.prove_prepared

    def recorded(prep, r=None, s=None):
        proof = orig(prep, r=r, s=s)
        st = prover.stats
        records.append((prep.assemble_s, prep.synth_s, st.prove_s,
                        st.verify_s))
        return proof

    prover.prove_prepared = recorded
    try:
        yield records
    finally:
        del prover.prove_prepared


def log_batches(label, records, wall) -> float:
    """Logs a run's batches/s and each batch's seconds; returns the
    batches/s."""
    n = len(records)
    log(f"  {label}: {n} batches in {wall:.3f} s, {n / wall:.3f} batches/s")
    for i, (a, w, p, v) in enumerate(records):
        log(f"    batch {i + 1}: assemble_s {a:.3f}, synth_s {w:.3f}, "
            f"prove_s {p:.3f}, verify_s {v:.3f}")
    sums = [sum(r[k] for r in records) for k in range(4)]
    log(f"    sums: assemble {sums[0]:.3f} s, synth {sums[1]:.3f} s, prove "
        f"{sums[2]:.3f} s, verify {sums[3]:.3f} s")
    return n / wall


# phase 9's timed runs: run_pipeline and step() in turns, LOOP_TURN_BATCHES
# batches a run, each run on sends of its own (0.01 ETH, fee 0.001)
LOOP_TURNS = ("pipeline", "step", "step", "pipeline")
LOOP_TURN_BATCHES = 8


def operator_loop(dev, prover, launches):
    """Phase 9, the "operator" path: demo-rollup through the CLI, the
    pipelined daemon, the same batches stepped, the HTTP service; all with
    phase 3's card-made key on `prover`'s device."""
    import tempfile
    import urllib.request
    import torch
    from zkrollup_torch import kernels
    from zkrollup_torch.operator.service import start_app

    cfg = prover.cfg
    kernels.reset_launches()
    with tempfile.TemporaryDirectory() as keys_dir:
        t0 = time.time()
        prover.ensure_keys().save(os.path.join(
            keys_dir, f"tx_{cfg.batch_size}_{cfg.tree_depth}.npz"))
        log(f"  phase 3's key saved to the CLI's --keys-dir: "
            f"{time.time() - t0:.3f} s")
        t0 = time.time()
        rc, out = run_cli(["--keys-dir", keys_dir, "--device", str(dev),
                           "demo-rollup"])
    log(f"  demo-rollup through zkrollup_torch.cli.main: exit code {rc}, "
        f"{time.time() - t0:.3f} s (key load and R1CS digest, one batch)")
    for want in ("A: balance 0.57 ETH nonce 2", "B: balance 1.4 ETH nonce 0",
                 "accrued fees: 0.03 ETH", "DEMO ROLLUP OK"):
        if rc != 0 or want not in out:
            raise AssertionError(f"demo-rollup: exit code {rc}, no {want!r}")

    # the pipelined daemon: tests/test_e2e_rollup.py's four sends, two
    # batches (its witness worker's spawn and imports paid here), and the
    # stepped daemon on the same sends apart; then run_pipeline and step()
    # in turns, LOOP_TURN_BATCHES batches a timed run
    pipe, stepped = LoopEnv(prover), LoopEnv(prover)
    try:
        for env in (pipe, stepped):
            env.deposit(2.0, 1.0)
            env.send(range(1, 5))
        with batch_records(prover) as rec:
            t0 = time.time()
            done = pipe.daemon.run_pipeline(max_batches=2)
            log_batches("warm run_pipeline(max_batches=2)", rec,
                        time.time() - t0)
        if done != 2 or pipe.queue.pending_count():
            raise AssertionError(f"run_pipeline settled {done} batches")
        pipe.check("after two pipelined batches", 1.56, 4, 1.40, 0.04)
        for _ in range(2):
            if not stepped.daemon.step():
                raise AssertionError("step() settled no batch")
        stepped.check("after two stepped batches", 1.56, 4, 1.40, 0.04)

        rates = {"pipeline": [], "step": []}
        nonce = {"pipeline": 5, "step": 5}
        k = LOOP_TURN_BATCHES
        for turn in LOOP_TURNS:
            env = pipe if turn == "pipeline" else stepped
            first = nonce[turn]
            nonce[turn] += 2 * k
            env.send(range(first, nonce[turn]), amount=0.01, fee=0.001)
            with batch_records(prover) as rec:
                t0 = time.time()
                if turn == "pipeline":
                    done = env.daemon.run_pipeline(max_batches=k)
                else:
                    done = sum(env.daemon.step() for _ in range(k))
                wall = time.time() - t0
            if done != k or env.queue.pending_count():
                raise AssertionError(f"{turn}: {done} of {k} batches "
                                     "settled")
            rates[turn].append(log_batches(
                f"{turn}, {k} batches" if turn == "pipeline" else
                f"step() {k} times, one batch each", rec, wall))
        sent = 4 + 4 * k
        for env in (pipe, stepped):
            env.check(f"after {sent // 2} batches",
                      Decimal("1.56") - Decimal("0.044") * k, sent,
                      Decimal("1.40") + Decimal("0.04") * k,
                      Decimal("0.04") + Decimal("0.004") * k)
        med = {t: statistics.median(v) for t, v in rates.items()}
        log(f"  batches/s, median of {len(rates['step'])} runs of {k} "
            f"batches: run_pipeline {med['pipeline']:.3f}, step() "
            f"{med['step']:.3f}; pipeline against step "
            f"{med['pipeline'] / med['step']:.3f}x ({smi_line()})")
        log(f"  the daemon's metrics: {pipe.daemon.metrics.snapshot()}")
    finally:
        pipe.daemon.close()

    # the HTTP service: /admin/prove-batch proves on a server thread
    env = LoopEnv(prover)
    server = start_app(env.app, port=0)
    base = f"http://127.0.0.1:{server.server_address[1]}"

    def http(path, body=None):
        data = None if body is None else json.dumps(body).encode()
        req = urllib.request.Request(base + path, data=data,
                                     method="GET" if body is None else "POST")
        with urllib.request.urlopen(req, timeout=600) as r:
            return json.load(r)

    try:
        for pub in env.pubs:
            http("/chain/deposit", {"publicKey": [str(pub[0]), str(pub[1])],
                                    "value": str(wei(1.0))})
        for nonce, amount, fee in ((1, 0.1, 0.01), (2, 0.3, 0.02)):
            reply = http("/send", env.send_body(nonce, amount, fee))
            if reply != {"status": "Transaction accepted"}:
                raise AssertionError(f"POST /send: {reply}")
        t0 = time.time()
        reply = http("/admin/prove-batch", {})
        log(f"  HTTP on port {server.server_address[1]}: POST "
            f"/admin/prove-batch (a proof on a server thread) "
            f"{time.time() - t0:.3f} s: {reply}")
        if reply.get("processed") is not True:
            raise AssertionError(f"POST /admin/prove-batch: {reply}")
        users = [http(f"/users/index/{i}") for i in (0, 1)]
        log(f"  GET /users/index/0: {users[0]['balance']} wei nonce "
            f"{users[0]['nonce']}; /users/index/1: {users[1]['balance']} wei")
        if ((users[0]["balance"], users[0]["nonce"], users[1]["balance"])
                != (str(wei(0.57)), 2, str(wei(1.4)))):
            raise AssertionError(f"GET /users after the batch: {users}")
        log(f"  GET /metrics: {http('/metrics')}")
    finally:
        server.shutdown()
        server.server_close()
    env.check("after the HTTP batch", 0.57, 2, 1.4, 0.03)
    torch.cuda.synchronize()
    count_path(launches, "operator")


def formats_round_trip(dev, pk, r1cs, res, proof):
    """Phase 9, the withdraw key through the reference stack's formats
    (groth16/interop.py): the proving key as snarkjs JSON text and as the
    websnark binary, the verifying key and the proof as snarkjs JSON, each
    loaded back; the loaded keys prove on the card at the pinned (r, s)
    with the bytes of `proof`."""
    from zkrollup_torch.groth16 import interop
    from zkrollup_torch.groth16.prove import prove

    t0 = time.time()
    text = json.dumps(interop.proving_key_to_snarkjs(pk, r1cs))
    raw = interop.binarify_proving_key(json.loads(text))
    vk = interop.verifying_key_from_snarkjs(json.loads(json.dumps(
        interop.verifying_key_to_snarkjs(pk.vk))))
    back = interop.proof_from_snarkjs(json.loads(json.dumps(
        interop.proof_to_snarkjs(proof))))
    log(f"  withdraw key as snarkjs JSON {len(text)} bytes, websnark binary "
        f"{len(raw)} bytes: {time.time() - t0:.3f} s")
    if vk != pk.vk or proof_bytes(back) != proof_bytes(proof):
        raise AssertionError("the verifying key or the proof changed "
                             "through snarkjs JSON")
    r0, s0 = PINNED_RS
    for fmt, kj in (("snarkjs JSON", json.loads(text)),
                    ("websnark binary", interop.stringify_bigints(
                        interop.parse_websnark_proving_key(raw)))):
        loaded = interop.proving_key_from_snarkjs(kj, vk=vk)
        got = prove(loaded, res.r1cs, res.witness, r=r0, s=s0, device=dev,
                    c=12)
        if proof_bytes(got) != proof_bytes(proof):
            raise AssertionError(f"the withdraw key loaded from {fmt} proves"
                                 " other bytes")
        log(f"  the key loaded from {fmt} proves on {dev} with the same "
            "bytes")


def withdraw_path(dev, launches):
    """Phase 9, the "withdraw" path: WithdrawProver's key made on the card
    against setup_host's, a proof at pinned (r, s) against the native
    engine's, the contract's payout and its refusal of the nullifier's
    reuse, steady proofs, then demo-withdraw through the CLI."""
    import random
    import tempfile
    import torch
    from zkrollup_torch import kernels
    from zkrollup_torch.chain.simulator import RollUpContract
    from zkrollup_torch.config import RollupConfig
    from zkrollup_torch.groth16.prove import prove_host
    from zkrollup_torch.groth16.setup import setup_host
    from zkrollup_torch.operator.prover import WithdrawProver
    from zkrollup_torch.r1cs.circuits import synthesize_withdraw
    from zkrollup_torch.ref import eddsa
    from zkrollup_torch.ref.bn254 import R as FR_MOD

    wp = WithdrawProver(key_path=None, setup_seed=SETUP_SEED, device=dev,
                        c=12)
    r1cs = wp.structure_r1cs()
    kernels.reset_launches()
    t0 = time.time()
    pk = wp.ensure_keys()
    torch.cuda.synchronize()
    card_s = time.time() - t0
    at_setup = {k: (kernels.LAUNCHES[k], kernels.LANES[k])
                for k in kernels.LAUNCHES}
    t0 = time.time()
    host = setup_host(r1cs, seed=SETUP_SEED)
    log(f"  withdraw key ({pk.n_vars} vars, {pk.n_public} public, domain "
        f"{pk.domain_size}) on {dev}: {card_s:.3f} s; setup_host "
        f"{time.time() - t0:.3f} s")
    bad = same_key(pk, host)
    if bad:
        raise AssertionError(f"card-made withdraw key differs from "
                             f"setup_host's: {bad}")
    log("  the two withdraw keys are equal byte for byte")

    fpriv = eddsa.format_priv_key_for_babyjub(LOOP_PRIV[0])
    r0, s0 = PINNED_RS
    t0 = time.time()
    proof, signals = wp.prove_withdraw(fpriv, WITHDRAW_NULLIFIER, r0, s0)
    first_s = time.time() - t0
    st = wp.stats
    log(f"  first withdraw proof (self-verified): {first_s:.3f} s (witness "
        f"{st.witness_s:.3f}, prove {st.prove_s:.3f}, verify "
        f"{st.verify_s:.3f})")
    prove_only = {k: (kernels.LAUNCHES[k] - at_setup[k][0],
                      kernels.LANES[k] - at_setup[k][1])
                  for k in kernels.LAUNCHES}
    log("  its launches (lanes per launch): " + ", ".join(
        f"{k} {n} ({lanes / n:.1f})" for k, (n, lanes) in prove_only.items()
        if n))
    res = synthesize_withdraw(fpriv, WITHDRAW_NULLIFIER)
    want = prove_host(pk, res.r1cs, res.witness, r=r0, s=s0)
    if proof_bytes(proof) != proof_bytes(want) or signals != \
            res.public_signals:
        raise AssertionError("the withdraw proof differs from the native "
                             "engine's")
    log("  its bytes equal the native engine's")
    formats_round_trip(dev, pk, r1cs, res, proof)

    contract = RollUpContract(RollupConfig(), tx_vk=None, withdraw_vk=pk.vk)
    pub = eddsa.gen_public_key(LOOP_PRIV[0])
    contract.deposit(pub[0], pub[1], wei(1.0))
    paid = contract.withdraw(wei(0.4), proof, signals)
    try:
        contract.withdraw(wei(0.1), proof, signals)
    except ValueError as e:
        refused = str(e)
    else:
        raise AssertionError("the contract accepted a reused nullifier")
    log(f"  the contract paid {paid / 1e18} ETH, then refused the reuse: "
        f"{refused}")
    if paid != wei(0.4) or refused != "Nullifier has been used":
        raise AssertionError(f"withdraw: paid {paid}, refused {refused!r}")

    rng = random.Random(SEED)
    steady = []
    for i in range(3):
        r, s = rng.randrange(1, FR_MOD), rng.randrange(1, FR_MOD)
        t0 = time.time()
        wp.prove_withdraw(fpriv, WITHDRAW_NULLIFIER + i + 1, r, s)
        steady.append(time.time() - t0)
        log(f"  withdraw proof {i + 1} at random (r, s): {steady[-1]:.3f} s "
            f"(witness {st.witness_s:.3f}, prove {st.prove_s:.3f}, verify "
            f"{st.verify_s:.3f})")
    log(f"  steady withdraw proofs: {len(steady) / sum(steady):.3f}/s")

    with tempfile.TemporaryDirectory() as keys_dir:
        pk.save(os.path.join(keys_dir, "withdraw.npz"))
        t0 = time.time()
        rc, out = run_cli(["--keys-dir", keys_dir, "--device", str(dev),
                           "demo-withdraw"])
    log(f"  demo-withdraw through zkrollup_torch.cli.main: exit code {rc}, "
        f"{time.time() - t0:.3f} s")
    for want_line in ("withdrew 0.4 ETH; remaining 0.6",
                      "nullifier reuse rejected: Nullifier has been used",
                      "DEMO WITHDRAW OK"):
        if rc != 0 or want_line not in out:
            raise AssertionError(f"demo-withdraw: exit code {rc}, no "
                                 f"{want_line!r}")
    torch.cuda.synchronize()
    count_path(launches, "withdraw")


# -- phase 10: the bulk MiMC tree ---------------------------------------------

# one Merkle level of 2^17 pairs (bench.py:185's batch, BASELINE.md:43);
# a depth-18 tree at its capacity, 2^17 - 1 leaves (the capacity quirk,
# 2^(depth-1) - 1); 2^17 four-wide leaf rows (helpers.ts:80)
MIMC_PAIRS = 1 << 17
MIMC_DEPTH = 18
MIMC_ROWS = 1 << 17
# the native engine's one-core rate, on a subsample (bench.py:196-204)
MIMC_ENGINE_SUB = 1 << 13
ENGINE_THREADS = 8


def engine_rows(rows) -> list:
    """engine.mimc_multi_hash_many over rows, in ENGINE_THREADS chunks on
    threads (the call releases the interpreter lock)."""
    from concurrent.futures import ThreadPoolExecutor
    from zkrollup_torch.native import engine
    step = -(-len(rows) // ENGINE_THREADS)
    with ThreadPoolExecutor(ENGINE_THREADS) as ex:
        parts = ex.map(engine.mimc_multi_hash_many,
                       [rows[i:i + step] for i in range(0, len(rows), step)])
    return [h for part in parts for h in part]


def engine_levels(leaves, depth: int, zeros: dict) -> list:
    """The levels of a tree over `leaves` hashed level by level on the
    native engine, each padded to even with its zero value as the
    incremental tree pads it; the last is [root]."""
    levels, nodes = [], list(leaves)
    for i in range(depth):
        nodes = nodes + ([zeros[i]] if len(nodes) % 2 else [])
        levels.append(nodes)
        nodes = engine_rows([nodes[j:j + 2]
                             for j in range(0, len(nodes), 2)])
    return levels + [nodes]


def mimc_phase(dev, ops, launches):
    """Phase 10, the "mimc" path: hash/mimc.py and tree/bulk.py on the card,
    one mimc_sponge[fr] launch a level or a batch. Counted from 0:
    merkle_level_up over MIMC_PAIRS pairs, bit for bit against the native
    engine; from_leaves over a depth-MIMC_DEPTH tree at its capacity, whose
    root and caches equal the engine's levels; multi_hash_rows over
    MIMC_ROWS four-wide rows against the engine; verify_integrity on a
    store holding that tree, True, then False once a leaf hash is
    corrupted; limbs.normalize never on a CUDA tensor. Then the level
    timed (host clock and CUDA events; hashes/s beside the engine's
    one-core rate on MIMC_ENGINE_SUB pairs) in turns with mimc_loop on the
    add and sub kernels and on the carry loop (carry_loop_route: the route
    before both kernels), and profiled (the device's busy time by kernel
    name, read in a whole window: profiled; limbs.normalize never)."""
    import torch
    from zkrollup_torch import kernels
    from zkrollup_torch.fields import limbs as L
    from zkrollup_torch.fields.mont import FR
    from zkrollup_torch.hash import mimc
    from zkrollup_torch.native import engine
    from zkrollup_torch.tree import bulk
    from zkrollup_torch.tree.merkle import MerkleTree
    from zkrollup_torch.tree.store import TreeStore

    pairs, want_level = ops["pairs"], ops["want_level"]
    leaves, rows, want_rows = ops["leaves"], ops["rows"], ops["want_rows"]
    zeros = MerkleTree(MIMC_DEPTH).zeros
    levels = engine_levels(leaves, MIMC_DEPTH, zeros)
    nodes = L.to_device(FR.to_mont_host(ops["vals"]), dev)
    torch.cuda.synchronize()

    kernels.reset_launches()
    with cuda_normalize_calls() as norm:
        t0 = time.time()
        got_level = FR.from_mont_host(mimc.merkle_level_up(nodes))
        level_s = time.time() - t0
        t0 = time.time()
        tree = bulk.from_leaves(leaves, MIMC_DEPTH, device=dev)
        tree_s = time.time() - t0
        t0 = time.time()
        got_rows = bulk.multi_hash_rows(rows, device=dev)
        rows_s = time.time() - t0
        store = TreeStore()
        try:
            store.save_all_leaves("balanceTree", tree)
            t0 = time.time()
            intact = store.verify_integrity("balanceTree", device=dev)
            verify_s = time.time() - t0
            store.conn.execute("UPDATE leaves SET hash='12345' WHERE idx=3")
            store.conn.commit()
            corrupted = store.verify_integrity("balanceTree", device=dev)
        finally:
            store.close()
        torch.cuda.synchronize()
    count_path(launches, "mimc")
    if got_level != want_level:
        raise AssertionError("merkle_level_up differs from the engine")
    log(f"  merkle_level_up, {MIMC_PAIRS} pairs: equal to the engine's "
        f"mimc_multi_hash_many bit for bit ({level_s:.3f} s, first call)")
    n = len(leaves)
    want_paths = {i: dict(enumerate(lv)) for i, lv in enumerate(
        levels[:MIMC_DEPTH])}
    want_sub = {i: levels[i][((n - 1) >> i) & ~1] for i in range(MIMC_DEPTH)}
    if (tree.root, tree.filled_paths, tree.filled_subtrees, tree.zeros) != (
            levels[-1][0], want_paths, want_sub, zeros):
        raise AssertionError("from_leaves: root or caches differ from the "
                             "engine's levels")
    log(f"  from_leaves, depth {MIMC_DEPTH}, {n} leaves (its capacity): "
        f"root and caches equal the engine's levels ({tree_s:.3f} s, "
        f"{sum(len(lv) >= 2 * bulk.MIN_BATCH_LEAVES for lv in levels[:-1])}"
        f" levels batched on {dev})")
    if got_rows != want_rows:
        raise AssertionError("multi_hash_rows differs from the engine")
    log(f"  multi_hash_rows, {MIMC_ROWS} four-wide rows: equal to the "
        f"engine ({rows_s:.3f} s)")
    log(f"  verify_integrity on a store of that tree: {intact} "
        f"({verify_s:.3f} s), after one leaf hash is corrupted: "
        f"{corrupted}")
    if (intact, corrupted) != (True, False):
        raise AssertionError(f"verify_integrity gave {intact}, {corrupted}")
    check_no_normalize("the mimc path", norm[0])

    # the level through the kernel, through mimc_loop on the add and sub
    # kernels and on the carry loop, in turns, each equal to the engine
    x = nodes.reshape(-1, 2, L.N_LIMBS)
    routes = {"kernel": ("mimc_sponge[fr]",
                         lambda: mimc.merkle_level_up(nodes)),
              "loop": ("mimc_loop on mont_mul[fr] and add[fr]",
                       lambda: mimc_loop(x)),
              "carry": ("mimc_loop with FR.add on the carry loop",
                        lambda: mimc_loop(x))}
    secs = {r: [] for r in routes}
    for r in ("kernel", "loop", "carry", "carry", "loop", "kernel"):
        with (carry_loop_route() if r == "carry"
              else contextlib.nullcontext()):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = routes[r][1]()
            torch.cuda.synchronize()
            secs[r].append(time.perf_counter() - t0)
        if FR.from_mont_host(out) != want_level:
            raise AssertionError(f"{routes[r][0]} differs from the engine")
    wall = wall_ms(lambda: mimc.merkle_level_up(nodes), 3) / 1e3
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    e0.record()
    mimc.merkle_level_up(nodes)
    e1.record()
    torch.cuda.synchronize()
    events_s = e0.elapsed_time(e1) / 1e3
    # as it was read before, and in a whole window: the profiler may drop
    # the first device events of a session (trace_prove.whole_window),
    # here the level's one launch
    with cuda_normalize_calls() as calls:
        w = profiled(dev, lambda: mimc.merkle_level_up(nodes), whole=False)
        bare = sum(c for _, c, _ in device_time(w["prof"])[1])
        w = profiled(dev, lambda: mimc.merkle_level_up(nodes))
    prof, prof_wall = w["prof"], w["wall_s"]
    busy_s, by_name = device_time(prof)
    sub = pairs[:MIMC_ENGINE_SUB]
    t0 = time.time()
    engine.mimc_multi_hash_many(sub)
    engine_rate = len(sub) / (time.time() - t0)
    log(f"  merkle_level_up, {MIMC_PAIRS} pairs, seconds in turns, each "
        "equal to the engine: " + "; ".join(
            f"{routes[r][0]} " + " ".join(f"{t:.4f}" for t in secs[r])
            for r in routes))
    log(f"  merkle_level_up, {MIMC_PAIRS} pairs on {dev}: {wall:.4f} s "
        f"wall (median of 3), {events_s:.4f} s between CUDA events, "
        f"{MIMC_PAIRS / wall:,.0f} hashes/s; the native engine on one core "
        f"{engine_rate:,.0f} hashes/s ({MIMC_ENGINE_SUB} pairs); "
        f"{smi_line()}")
    log(f"  one level under torch.profiler: {bare} device events as it was "
        f"read before; in a whole window ({lead_note(w)}): wall "
        f"{prof_wall:.4f} s, device busy "
        f"{busy_s:.4f} s ({busy_s / prof_wall:.3f} of the wall), "
        f"{sum(c for _, c, _ in by_name)} device events")
    check_no_normalize("the profiled level", calls[0])
    if not any("mimc_sponge_kernel" in key for _, _, key in by_name):
        raise AssertionError("the profiled level recorded no sponge kernel "
                             "in a whole window")
    for t, count, key in by_name[:8]:
        log(f"    {t / 1e3:9.3f} ms  {count:6d} x  {key[:90]}")


# -- phase 11: the multi-device prover on a virtual mesh ------------------------

# shards of the virtual mesh on the one card (make_mesh(DIST_SHARDS,
# device="cuda:0")), and the sharded NTT's size (the (2,6) domain)
DIST_SHARDS = 4
DIST_NTT_LOG = 17


def dist_phase(dev, prover, prep, want_bytes, launches):
    """Phase 11, the "dist" path: zkrollup_torch/dist on a virtual mesh of
    DIST_SHARDS shards of the card, counted from 0. prove(mesh=) of phase
    4's batch with phase 3's key at the pinned (r, s), with table_groups 1
    and 2 (each group's MSMs on CUDA streams of their own), each
    self-verified and equal to phase 4's bytes (the native engine's);
    their wall seconds beside prove(device=) on one card; the sharded NTT
    of 2^DIST_NTT_LOG rows and its inverse against ntt.transform and the
    input, and the relayout against cyclic_shard; sharded_msm_g1 / g2 over
    the key's a and b2 tables (padded by infinity to a multiple of the
    mesh, the a table's duplicates and infinity rows included) against the
    native engine's Pippenger, as affine points; the path's launches,
    lanes and limbs.normalize calls on CUDA tensors. Then
    zkrollup_torch/tools/multihost_sim.py on the card over gloo, as a
    subprocess, which must print MULTIHOST OK."""
    import numpy as np
    import torch
    from zkrollup_torch import kernels
    from zkrollup_torch.curve import g1, g2
    from zkrollup_torch.dist import mesh as dm
    from zkrollup_torch.fields import limbs as L
    from zkrollup_torch.fields.mont import FR
    from zkrollup_torch.groth16 import prove as P
    from zkrollup_torch.groth16.verify import verify
    from zkrollup_torch.native import engine
    from zkrollup_torch.ntt import ntt
    from zkrollup_torch.ref.bn254 import R as FR_MOD

    pk, r1cs = prover.pk, prover.structure_r1cs()
    r0, s0 = PINNED_RS
    w = [v % FR_MOD for v in prep.witness]

    def wall(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    one = [wall(lambda: P.prove(pk, r1cs, prep.witness, r=r0, s=s0,
                                device=dev, c=prover.c))[1]
           for _ in range(2)]
    mesh = dm.make_mesh(DIST_SHARDS, device=dev)
    log(f"  {mesh}")
    d = mesh.size
    # The references first, so that the counted window below holds the
    # path's own calls only: the single-device transform and its time, the
    # key's padded tables, the scalars and the engine's Pippenger sums.
    rng = np.random.RandomState(SEED + 11)
    n = 1 << DIST_NTT_LOG
    x = L.to_device(FR.to_mont_host(
        [int.from_bytes(rng.bytes(32), "little") % FR.p
         for _ in range(n)]), dev)
    want_ntt = ntt.transform(x)
    one_ms = wall_ms(lambda: ntt.transform(x))
    tbl = P._dist_tables(pk, d, dev)
    sc = L.to_device(L.ints_to_limbs(w), dev)
    sc = torch.cat([sc, sc.new_zeros((tbl["pad_to"] - sc.shape[0], 16))])
    w_bytes = engine.ints_to_fr_bytes(w)
    want = {"g1": engine.g1_msm_pip(engine.pack_g1_table_mont(pk.a_g1),
                                    w_bytes, pk.n_vars),
            "g2": engine.g2_msm_pip(engine.pack_g2_table_mont(pk.b2_g2),
                                    w_bytes, pk.n_vars)}
    msms = (("g1", g1, g1.G1, dm.sharded_msm_g1, "a"),
            ("g2", g2, g2.G2, dm.sharded_msm_g2, "b2"))

    # The counted window: the mesh proofs, the sharded NTT, its relayout
    # and inverse, and the sharded MSMs. Their results are checked after it.
    kernels.reset_launches()
    proofs, times, msm_out = [], {}, {}
    with cuda_normalize_calls() as norm:
        for groups in (1, 2):
            for rep in range(2):
                proof, secs = wall(lambda: P.prove(
                    pk, r1cs, prep.witness, r=r0, s=s0, mesh=mesh,
                    table_groups=groups, c=prover.c))
                times.setdefault(groups, []).append(secs)
                proofs.append((groups, proof))
        proof_norm = norm[0]
        fwd, fwd_s = wall(lambda: dm.sharded_ntt(mesh, dm.cyclic_shard(x, d),
                                                 DIST_NTT_LOG))
        cyc = dm.blocked_to_cyclic(mesh, fwd)
        back, back_s = wall(lambda: dm.sharded_ntt(mesh, cyc, DIST_NTT_LOG,
                                                   inverse=True))
        for name, mod, curve, fn, t in msms:
            msm_out[name] = wall(lambda: fn(mesh, tbl[t], sc, c=12))
        torch.cuda.synchronize()
    count_path(launches, "dist")
    launches["dist_normalize_cuda"] = norm[0]

    for groups, proof in proofs:
        if not verify(pk.vk, proof, prep.public_signals):
            raise AssertionError(f"the mesh proof (table_groups={groups}) "
                                 "does not verify")
        if proof_bytes(proof) != want_bytes:
            raise AssertionError(f"the mesh proof (table_groups={groups}) "
                                 "differs from phase 4's and the native "
                                 "engine's")
    for groups, secs in times.items():
        log(f"  prove(mesh=, table_groups={groups}), self-verified, "
            f"bytes equal phase 4's and the native engine's: "
            + ", ".join(f"{t:.3f}" for t in secs) + " s wall (the key's"
            " padded tables were placed on the card before the first)")
    log(f"  prove(device=) on one card: "
        + ", ".join(f"{t:.3f}" for t in one) + " s wall")
    check_no_normalize("the four mesh proofs", proof_norm)

    if max_abs_err([dm.unblock(fwd)], [want_ntt]):
        raise AssertionError("the sharded NTT differs from ntt.transform")
    if max_abs_err(cyc, list(dm.cyclic_shard(dm.unblock(fwd), d))):
        raise AssertionError("blocked_to_cyclic differs from cyclic_shard")
    if max_abs_err([dm.unblock(back)], [x]):
        raise AssertionError("the sharded inverse NTT does not give the "
                             "input back")
    log(f"  sharded NTT of 2^{DIST_NTT_LOG} rows over {d} shards: "
        f"{fwd_s * 1e3:.3f} ms, inverse {back_s * 1e3:.3f} ms wall (one "
        f"device's ntt.transform {one_ms:.3f} ms); equal to "
        "ntt.transform, the relayout to cyclic_shard, the inverse to "
        "the input")

    for name, mod, curve, fn, t in msms:
        pt, secs = msm_out[name]
        got = mod.to_affine_host(curve.map(lambda a: a.reshape(1, 16), pt))[0]
        if got != want[name]:
            raise AssertionError(f"sharded_msm_{name} over the key's {t} "
                                 "table differs from the native engine's")
        log(f"  sharded_msm_{name} over the key's {t} table "
            f"({tbl['pad_to']} rows, {d} shards): {secs:.3f} s wall, "
            "equal to the native engine's")
    check_no_normalize("the dist path", norm[0])

    # the steady mesh proof with FieldCtx.add / sub on their kernels and
    # on the carry loop, in turns, each giving phase 4's bytes
    secs = {"kernels": [], "carry loop": []}
    for route in ("kernels", "carry loop", "carry loop", "kernels"):
        with (carry_loop_route() if route == "carry loop"
              else contextlib.nullcontext()):
            proof, t = wall(lambda: P.prove(
                pk, r1cs, prep.witness, r=r0, s=s0, mesh=mesh,
                table_groups=1, c=prover.c))
        secs[route].append(t)
        if proof_bytes(proof) != want_bytes:
            raise AssertionError(f"the mesh proof with the adds on the "
                                 f"{route} differs from phase 4's")
    log("  prove(mesh=, table_groups=1) seconds, FieldCtx.add / sub on the "
        "add and sub kernels " + " ".join(f"{t:.3f}" for t in
                                          secs["kernels"])
        + ", on the carry loop " + " ".join(f"{t:.3f}" for t in
                                            secs["carry loop"])
        + "; each equal to phase 4's bytes")

    t0 = time.time()
    res = subprocess.run(
        [sys.executable, "-m", "zkrollup_torch.tools.multihost_sim",
         "--device", str(dev), "--backend", "gloo"], cwd=HERE,
        capture_output=True, text=True, timeout=600)
    for line in res.stdout.splitlines():
        log(f"    {line}")
    log(f"  multihost_sim --device {dev} --backend gloo: exit code "
        f"{res.returncode}, {time.time() - t0:.1f} s")
    if res.returncode or "MULTIHOST OK" not in res.stdout:
        raise AssertionError("multihost_sim failed:\n" + res.stderr[-3000:])


def launch_table(launches, paths):
    log(f"  {'kernel':15s} " + " ".join(f"{p:>19s}" for p in paths))
    for k in KERNELS:
        cells = []
        for p in paths:
            count, lanes, _ = launches[p][k]
            cells.append(f"{count:7d} x {lanes / max(1, count):9.1f}")
        log(f"  {k:15s} " + " ".join(cells))


def log_add_sub_widths(launches) -> None:
    """The add and sub kernels' launches on each path, their lanes and
    widest launch, with the bound at that width (3 values of 32 B a lane
    over the memory rate)."""
    for k in KERNELS:
        if not k.startswith(("add[", "sub[")):
            continue
        for p in PATHS:
            count, lanes, widths = launches[p][k]
            if count:
                w = max(widths)
                log(f"  {k} on {p}: {count} launches, {lanes} lanes, widest "
                    f"{w} lanes (bound there "
                    f"{bound(0, 3 * VALUE_BYTES * w)[0]:.4f} ms), "
                    f"{widths[w]} launches at it")


def check_paths(launches, paths):
    """Each kernel of each of `paths` launched on it."""
    missing = [(p, k) for p in paths for k in PATHS[p]
               if launches[p][k][0] <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on their path: "
                             f"{missing}")


def check_ab_cases(cases: list) -> None:
    """--ab: the cases name every kernel of AB_KERNELS and no other, and no
    (kernel, lanes, operands) twice."""
    names = collections.Counter(c[0] for c in cases)
    keys = collections.Counter(c[:3] for c in cases)
    missing = sorted(set(AB_KERNELS) - set(names))
    extra = sorted(set(names) - set(AB_KERNELS))
    twice = sorted(k for k, v in keys.items() if v > 1)
    if missing or extra or twice:
        raise AssertionError(f"--ab cases: missing {missing}, not named "
                             f"{extra}, twice {twice}")


def ab_run(dev, bases: list, keep) -> list:
    """--ab: the point kernels of PROVE_SHAPES and SETUP_SHAPES, the
    doubles, the Horner kernels, the z01 adds (at 2^16 lanes, Z01_SHAPES
    and one lane), g1_add_nd and g2_add_nd (ND_SHAPES: 2^16 lanes and one
    lane) and the
    inversion kernels (at the widest of INV_SHAPES and
    one lane, random operands with zero lanes) of this checkout against
    those built from each csrc/ directory of `bases`. Every unit they live
    in (kernels.UNITS) is built from each base, one nvcc each, all started
    together with this checkout's flags into a temporary directory, and
    bound through the same wrappers (the C signatures do not change; a
    base without a Horner entry skips its rows);
    `keep()`, called while they build, gives one proof's operands
    (keep_prove_operands). For each kernel, at 2^16 lanes with phase 2's
    special lanes, at widths_of (PROVE_SHAPES and, over G1, WAVE_LANES;
    SETUP_SHAPES and MSM_MADD_LANES), on the proof's operands of g1_add's
    two widest launches and of one g1_madd_nd launch, and on one lane (the
    doubles at 2^16 lanes and one lane; the Horner kernels on phase 2's
    W = 22, c = 12 window sums): every build bit for bit against the plain
    version, then timed in turns, base, this, this, base (cuda_ms, 20
    calls, 264 on one lane). The fields unit is built from each base too,
    for ab_fields; a fields.cu with the earlier C interface is bound as a
    StageRoute."""
    import tempfile
    import torch
    from zkrollup_torch import kernels
    from zkrollup_torch.curve import cuda_curve
    from zkrollup_torch.curve.g1 import G1
    from zkrollup_torch.curve.g2 import G2
    from zkrollup_torch.curve.weierstrass import FqOps, Fq2Ops
    from zkrollup_torch.fields import cuda_mont
    from zkrollup_torch.fields.mont import FQ

    libs = kernels.load()
    curves = {"g1": G1, "g2": G2}
    units = sorted({kernels._SIGS[k][0] for k in (*PROVE_SHAPES,
                                                   *SETUP_SHAPES)}
                   | {"fields"})
    with tempfile.TemporaryDirectory() as tmp:
        procs = {}
        try:
            for b, base in enumerate(bases):
                for u in units:
                    so = os.path.join(tmp, f"{b}_{u}.so")
                    procs[b, u] = (so, subprocess.Popen(
                        [kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", so,
                         os.path.join(base, kernels.UNITS[u])],
                        stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                        text=True))
            adds, madd = keep()
            builds = []
            for b, base in enumerate(bases):
                bound_libs, logs = {}, {}
                for u in units:
                    so, proc = procs[b, u]
                    out, err = proc.communicate()
                    logs[u] = so[:-3] + ".log"
                    with open(logs[u], "w") as f:
                        f.write(out + err)
                    if proc.returncode:
                        raise RuntimeError(f"nvcc failed on {base}/"
                                           f"{kernels.UNITS[u]}:\n"
                                           f"{err[-4000:]}")
                    bound_libs[u] = (StageRoute(so) if u == "fields"
                                     and StageRoute.is_stage_route(so)
                                     else kernels.bind(u, so))
                builds.append(bound_libs)
                log(f"  base {base}:")
                log_ptxas(ptxas_report(logs), "base ")
        finally:
            for _, proc in procs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()

        ops = {g: point_operands(curves[g], dev, 1 << 16)
               for g in units if g in curves}
        proof_ops = {"g1_add": widest(adds), "g1_madd_nd": [madd]}
        cases = []     # (kernel, lanes, operands, curve, fn, plain, sub)
        for name in (*PROVE_SHAPES, *SETUP_SHAPES):
            g = name.split("_")[0]
            curve = curves[g]
            fn, plain, args, _ = ops[g][name]
            widths = ((1 << 16,) + tuple(m for m, _ in widths_of(name))
                      + (1,))
            for m in widths:
                sub, _ = take_lanes(curve, args, m, 5 if m == 1 else 0)
                cases.append((name, m, "phase 2", curve, fn, plain, sub))
            for sub in proof_ops.get(name, []):
                cases.append((name, curve.leaves(sub[0])[0].shape[0],
                              "the proof's", curve, fn, plain, sub))
        for g, curve in curves.items():
            fn, plain, args, _ = ops[g][f"{g}_double"]
            for m in (1 << 16, 1):
                sub, _ = take_lanes(curve, args, m, 5 if m == 1 else 0)
                cases.append((f"{g}_double", m, "phase 2", curve, fn, plain,
                              sub))
            wsum, c, _ = horner_cases(curve, ops[g][f"{g}_add"][2][0])[
                f"W={HORNER_W}, c={HORNER_C}"]
            cases.append((f"{g}_horner", 1, "phase 2", curve,
                          cuda_curve.horner, horner_plain_host, (wsum, c)))
        for name in (*Z01_SHAPES, *ND_SHAPES):
            curve = curves[name.split("_")[0]]
            fn, plain, args, _ = ops[curve.name][name]
            for m in (1 << 16, *(w for w, _ in widths_of(name)), 1):
                sub, _ = take_lanes(curve, args, m, 5 if m == 1 else 0)
                cases.append((name, m, "phase 2", curve, fn, plain, sub))
        gen = torch.Generator(device=dev)
        gen.manual_seed(SEED + 3)

        def rand_fe(n):
            a = torch.randint(0, 1 << 16, (n, 16), generator=gen,
                              device=dev, dtype=torch.int32)
            a[:, 15] &= 0x0FFF
            return a

        for name, (big, _) in INV_SHAPES.items():
            F = FqOps if name == "inv[fq]" else Fq2Ops
            plain = ((lambda F, a: cuda_mont.inv_plain(FQ, a))
                     if F is FqOps else
                     (lambda F, a: cuda_mont.inv_fq2_plain(FQ, a)))
            for m in (big, 1):
                cases.append((name, m, "random", F, lambda F, a: F.inv(a),
                              plain, (inv_operand(rand_fe, name, m,
                                                  edges=m > 1),)))
        check_ab_cases(cases)

        own = dict(libs)
        runs = [{"base": base, "rows": []} for base in bases]
        try:
            for name, m, what, curve, fn, plain, sub in cases:
                unit, sym, _ = kernels._SIGS[name]
                want = curve.leaves(plain(curve, *sub))
                for run, bound_libs in zip(runs, builds):
                    if not hasattr(bound_libs[unit], sym):
                        log(f"  {name}: base {run['base']} has no {sym}")
                        continue
                    pair = {"base": bound_libs[unit], "this": own[unit]}
                    ms = {"base": [], "this": []}
                    for b in ("base", "this", "this", "base"):
                        libs[unit] = pair[b]
                        if max_abs_err(curve.leaves(fn(curve, *sub)), want):
                            raise AssertionError(
                                f"{name} ({b} build of {run['base']}) "
                                f"disagrees with its plain version at {m} "
                                f"lanes ({what} operands)")
                        ms[b].append(cuda_ms(lambda: fn(curve, *sub),
                                             264 if m == 1 else 20))
                    run["rows"].append({"kernel": name, "lanes": m,
                                        "operands": what, **ms})
                    log(f"  {name:11s} {m:6d} lanes ({what} operands), "
                        f"base {run['base']}: "
                        + " ".join(f"{t:.4f}" for t in ms["base"])
                        + " ms, this "
                        + " ".join(f"{t:.4f}" for t in ms["this"]) + " ms")
            ab_fields(dev, runs, builds)
        finally:
            libs.update(own)
    return runs


class StageRoute:
    """The field route of a fields.cu with the earlier C interface
    (mont_mul without an index, one butterfly launch a stage; commit
    cea5215), as the Python of that commit ran
    it: the NTT as an index_select gather, 17 butterfly launches and the
    n^-1 and coset scalings as mont_mul launches; the quotient as three
    iNTTs, three coset NTTs, the pointwise step with FR.sub's carry loop,
    a coset iNTT and from_mont; the fold as _fold_lazy (the carry loop,
    two products, FR.add); the spmv product as index_select, then
    mont_mul."""

    @staticmethod
    def is_stage_route(so: str) -> bool:
        import ctypes
        return not hasattr(ctypes.CDLL(so), "zkt_ntt_pass_fr")

    def __init__(self, so: str):
        import ctypes
        P, I64 = ctypes.c_void_p, ctypes.c_int64
        self.lib = lib = ctypes.CDLL(so)
        lib.zkt_mont_mul_fr.argtypes = [P, P, ctypes.c_int, P, I64, P]
        lib.zkt_butterfly_fr.argtypes = [P, P, I64, I64, P]
        lib.zkt_set_device.argtypes = [ctypes.c_int]
        for fn in (lib.zkt_mont_mul_fr, lib.zkt_butterfly_fr,
                   lib.zkt_set_device):
            fn.restype = ctypes.c_int
        self.tables = {}

    def _call(self, fn, *args):
        import torch
        rc = fn(*args, torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"stage route: CUDA error {rc}")

    def mont_mul(self, a, b):
        import torch
        out = torch.empty_like(a)
        self.lib.zkt_set_device(a.device.index or 0)
        self._call(self.lib.zkt_mont_mul_fr, a.data_ptr(), b.data_ptr(),
                   int(b.numel() == 16 and a.numel() != 16), out.data_ptr(),
                   a.numel() // 16)
        return out

    def butterfly(self, x, tw, m):
        self._call(self.lib.zkt_butterfly_fr, x.data_ptr(), tw.data_ptr(),
                   x.shape[0] // 2, m)

    def _table(self, kind, log_n, dev):
        from zkrollup_torch.fields import limbs as L
        from zkrollup_torch.ntt import ntt
        key = (kind, log_n)
        if key not in self.tables:
            if kind in ("tw", "tw_inv"):
                t = [L.to_device(a, dev) for a in
                     ntt._stage_twiddles_host(log_n, kind == "tw_inv")]
            elif kind == "perm":
                import torch
                t = torch.from_numpy(ntt.bit_rev_perm(log_n)).to(dev)
            else:
                t = L.to_device(ntt._coset_powers_host(
                    log_n, kind == "coset_inv"), dev)
            self.tables[key] = t
        return self.tables[key]

    def ntt(self, a, inverse=False):
        from zkrollup_torch.fields.mont import FR
        n, dev = a.shape[0], a.device
        log_n = n.bit_length() - 1
        x = a.index_select(0, self._table("perm", log_n, dev))
        for s, tw in enumerate(self._table("tw_inv" if inverse else "tw",
                                           log_n, dev)):
            self.butterfly(x, tw, 1 << s)
        if inverse:
            x = self.mont_mul(x, FR.const_mont(pow(n, FR.p - 2, FR.p), dev))
        return x

    def quotient(self, a_e, b_e, c_e, zinv):
        from zkrollup_torch.fields import limbs as L
        from zkrollup_torch.fields.mont import FR
        log_n = a_e.shape[0].bit_length() - 1
        coset = lambda x, inv: self.mont_mul(x, self._table(
            "coset_inv" if inv else "coset", log_n, x.device))
        ca, cb, cc = (self.ntt(coset(self.ntt(e, True), False))
                      for e in (a_e, b_e, c_e))
        h = self.mont_mul(FR.sub(self.mont_mul(ca, cb), cc), zinv)
        h = coset(self.ntt(h, True), True)
        return self.mont_mul(h, L.to_device(L.int_to_limbs(1), h.device))

    def fold(self, sums):
        import torch
        from zkrollup_torch.fields import limbs as L
        from zkrollup_torch.fields.mont import FR
        n, dev = sums.shape[0], sums.device
        ext = L.propagate_carries(torch.cat(
            [sums, torch.zeros((n, 2), dtype=torch.int64, device=dev)], 1))
        lo = ext[:, :16].to(L.DTYPE).contiguous()
        hi = torch.cat([ext[:, 16:], torch.zeros(
            (n, 14), dtype=torch.int64, device=dev)], 1).to(L.DTYPE)
        return FR.add(self.mont_mul(lo, FR.one_mont(dev)),
                      self.mont_mul(hi, FR.r2_limbs(dev)))

    def gather_mul(self, a, w, idx):
        return self.mont_mul(a, w.index_select(0, idx))


def ab_fields(dev, runs, builds):
    """--ab, the field route: on 2^17 rows (the (2,6) domain) the forward
    transform, the inverse with n^-1, the quotient, the 17 stages as
    one-stage passes (the butterfly launches) and the fold; the
    gathered mont_mul at GATHER_LANES and GATHER_WIDEST over WITNESS_ROWS
    and mont_mul[fr] at 2^17 and GATHER_LANES lanes. A base with the earlier C
    interface runs
    StageRoute; one with this interface runs this checkout's Python over
    its library. Every result of every build equals this checkout's, bit
    for bit; then timed in turns, base, this, this, base (cuda_ms, 20
    calls)."""
    import torch
    from zkrollup_torch import kernels
    from zkrollup_torch.fields import cuda_mont, limbs as L
    from zkrollup_torch.fields.mont import FR
    from zkrollup_torch.groth16 import prove as P
    from zkrollup_torch.ntt import ntt

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 2)

    def fe(n):
        a = torch.randint(0, 1 << 16, (n, 16), generator=gen, device=dev,
                          dtype=torch.int32)
        a[:, 15] &= 0x0FFF
        return a

    n = 1 << DOMAIN_LOG
    x, evals, zinv = fe(n), [fe(n) for _ in range(3)], fe(1)[0]
    sums = torch.randint(0, 64 * 65536, (n, 16), generator=gen, device=dev,
                         dtype=torch.int64)
    a, w, b2 = fe(GATHER_WIDEST), fe(WITNESS_ROWS), fe(GATHER_LANES)
    idx = torch.randint(0, WITNESS_ROWS, (GATHER_WIDEST,), generator=gen,
                        device=dev)
    a1, i1 = a[:GATHER_LANES].contiguous(), idx[:GATHER_LANES].contiguous()
    a17, b17 = a[:n].contiguous(), b2[:n].contiguous()
    tws = [fe(1 << s) for s in range(DOMAIN_LOG)]

    def stages(stage, y):
        for s, t in enumerate(tws):
            stage(y, t, 1 << s)
        return y

    lanes = {"transform": n, "inverse transform": n, "quotient": n,
             "17 one-stage passes": n, "fold[fr]": n,
             "mont_mul[fr] gathered": GATHER_LANES,
             "mont_mul[fr] gathered, widest": GATHER_WIDEST,
             "mont_mul[fr] 2^17": n, "mont_mul[fr] 164,215": GATHER_LANES}
    ours = {
        "transform": lambda: ntt.transform(x),
        "inverse transform": lambda: ntt.intt_mont(x),
        "quotient": lambda: P._quotient_plain(*evals, zinv),
        "17 one-stage passes": lambda: stages(
            lambda y, t, m: cuda_mont.ntt_stage_(FR, y, t, m), x.clone()),
        "fold[fr]": lambda: cuda_mont.fold(FR, sums),
        "mont_mul[fr] gathered": lambda: FR.mont_mul(a1, w, i1),
        "mont_mul[fr] gathered, widest": lambda: FR.mont_mul(a, w, idx),
        "mont_mul[fr] 2^17": lambda: FR.mont_mul(a17, b17),
        "mont_mul[fr] 164,215": lambda: FR.mont_mul(a1, b2),
    }

    def stage_route(r):
        return {
            "transform": lambda: r.ntt(x),
            "inverse transform": lambda: r.ntt(x, True),
            "quotient": lambda: r.quotient(*evals, zinv),
            "17 one-stage passes": lambda: stages(r.butterfly, x.clone()),
            "fold[fr]": lambda: r.fold(sums),
            "mont_mul[fr] gathered": lambda: r.gather_mul(a1, w, i1),
            "mont_mul[fr] gathered, widest": lambda: r.gather_mul(a, w, idx),
            "mont_mul[fr] 2^17": lambda: r.mont_mul(a17, b17),
            "mont_mul[fr] 164,215": lambda: r.mont_mul(a1, b2),
        }

    libs = kernels.load()
    own = libs["fields"]
    want = {k: fn() for k, fn in ours.items()}
    for run, bound_libs in zip(runs, builds):
        base = bound_libs["fields"]
        stage = isinstance(base, StageRoute)
        fns = {"base": stage_route(base) if stage else ours, "this": ours}
        for name in ours:
            ms = {"base": [], "this": []}
            for b in ("base", "this", "this", "base"):
                libs["fields"] = own if (b == "this" or stage) else base
                if max_abs_err([fns[b][name]()], [want[name]]):
                    raise AssertionError(f"{name} ({b} build of "
                                         f"{run['base']}) disagrees with "
                                         "this checkout's")
                ms[b].append(cuda_ms(fns[b][name], 20))
            libs["fields"] = own
            run["rows"].append({"kernel": name, "lanes": lanes[name],
                                "operands": "random",
                                "route": "stages" if stage else "passes",
                                **ms})
            log(f"  {name:29s} base {run['base']} "
                f"({'stage route' if stage else 'this route'}): "
                + " ".join(f"{t:.4f}" for t in ms["base"]) + " ms, this "
                + " ".join(f"{t:.4f}" for t in ms["this"]) + " ms")


def main() -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ab", metavar="CSRC", action="append", default=[],
                    help="time the point kernels of PROVE_SHAPES and "
                         "SETUP_SHAPES, the doubles, the Horner kernels "
                         "and the field route against those built from "
                         "CSRC")
    opts = ap.parse_args()
    if not os.path.isdir(os.path.join(HERE, "zkrollup_torch")):
        print("chip_smoke.py: run it from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device", file=sys.stderr)
        return 2
    smi = smi_line()
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
    ptxas = ptxas_report(info["logs"])
    log_ptxas(ptxas)
    check_spill(ptxas)
    t0 = time.time()
    if not engine.available():
        raise RuntimeError("the native engine did not build (g++, native/src)")
    log(f"  native engine: {time.time() - t0:.1f} s ({engine._LIB_PATH})")

    if opts.ab:
        from zkrollup_torch.config import RollupConfig
        from zkrollup_torch.operator.prover import TxProver

        def keep():
            prover = TxProver(RollupConfig(), key_path=None,
                              setup_seed=SETUP_SEED, device=dev, c=12)
            return keep_prove_operands(prover, demo_batch(prover))

        log(f"A/B against {', '.join(opts.ab)}")
        out = ab_run(dev, opts.ab, keep)
        log(smi)
        print(json.dumps({"ab": out}))
        return 0

    log("phase 2: kernels against their plain versions")
    results = {}
    check_kernels(dev, results)
    check_alu(dev, results)
    mimc_ops = mimc_operands()
    check_mimc(dev, mimc_ops, results)

    launches = {}
    log("phase 3: setup on the card, BatchProcessTx(2, 6)")
    prover = setup_phase(dev, launches)

    log("phase 4: main path, BatchProcessTx(2, 6)")
    prep, want_bytes = main_path(dev, prover, launches)
    check_prove_operands(*keep_prove_operands(prover, prep), results)
    profiler_check(dev, "after phase 4")

    log("phase 5: the MSMs over the key's tables, four bucket strategies "
        "and GLV")
    msm_phase(dev, prover.pk, prep.witness, launches)
    profiler_check(dev, "after phase 5")

    log("phase 6: the GLV prover with the Jacobian merge tree, "
        "BatchProcessTx(2, 6)")
    glv_phase(dev, prover, prep, want_bytes, launches)
    profiler_check(dev, "after phase 6")

    log("phase 7: tools")
    tools_phase(dev, results, launches)
    curve_path(dev, launches)
    measure_phase(dev, prover, launches)
    profiler_check(dev, "after phase 7")

    log("phase 8: launches, and lanes per launch, on each path")
    earlier = [p for p in PATHS
               if p not in LOOP_PATHS + MIMC_PATHS + DIST_PATHS]
    launch_table(launches, earlier)
    check_widest("prove", launches["prove"], PROVE_SHAPES)
    check_prove_limits(launches)
    for path, limits in MSM_LIMITS.items():
        check_limits(path, launches[path], limits)
    check_paths(launches, earlier)

    log("phase 9: the operator loop, BatchProcessTx(2, 6) and withdraw")
    operator_loop(dev, prover, launches)
    withdraw_path(dev, launches)
    log("  launches, and lanes per launch, on the loop's paths")
    launch_table(launches, LOOP_PATHS)
    check_paths(launches, LOOP_PATHS)
    profiler_check(dev, "after phase 9")

    log("phase 10: the bulk MiMC tree on the card")
    mimc_phase(dev, mimc_ops, launches)
    launch_table(launches, MIMC_PATHS)
    check_paths(launches, MIMC_PATHS)

    log("phase 11: the multi-device prover on a virtual mesh of the card")
    dist_phase(dev, prover, prep, want_bytes, launches)
    launch_table(launches, DIST_PATHS)
    check_paths(launches, DIST_PATHS)
    log_add_sub_widths(launches)
    unlaunched = [k for k in KERNELS
                  if not any(launches[p][k][0] for p in PATHS)]
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
         "launches": sum(launches[p][k][0] for p in PATHS),
         "launches_by_path": {p: launches[p][k][0] for p in PATHS},
         "lanes_by_path": {p: launches[p][k][1] for p in PATHS},
         **results[k]} for k in KERNELS]}))
    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
