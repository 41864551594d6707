"""Integer-unit throughput on an NVIDIA GPU: u32 multiply against add,
shift, a 12-bit f32 multiply, a masked 16-bit multiply and __umulhi, and
beside them chains of multiplies alone (mad.lo, mad.hi).

Counterpart of tools/profile_vpu.py, the TPU vector-unit probe. The kernel
(csrc/alu.cu, alu_throughput_kernel<OP>) computes what that tool's Pallas
body computes, per lane of a (16, n) uint32 array:

    acc = 0; repeat reps times: acc ^= op(a, b); a ^= acc;   out = acc

Beside it, a multiply-only body (mad_chain_kernel<HI>, "mad_lo" and
"mad_hi"), per lane:

    acc = a ^ b; repeat reps times: acc = mad(acc, a, b);   out = acc

with mad.lo.u32 (low 32 bits of acc * a + b) or mad.hi.u32 (high 32 bits
of acc * a, plus b): one multiply instruction a rep, on 16 independent
chains a thread.

The plain version is the same loop in torch int64, masked to 32 bits; it
is exact for every op. Rates are lane-ops per second, 16 n reps over the
kernel's device time (CUDA events). reps must be large: a lane reads 8 B
and writes 4 B, so at the TPU tool's 16 reps device memory alone caps the
rate at 3.35 TB/s / 12 B x 16 = 4.5 T lane-ops/s, below the multiply peak.

sass_counts reads the instructions of each kernel's loop from the built
library (cuobjdump -sass), by class, per rep of one row: what the bound
of each kernel counts.

    python -m zkrollup_torch.tools.profile_alu [--log-n 19] [--reps 1024]
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import re
import shutil
import subprocess

import torch

from .. import kernels

ROWS = 16
M32 = 0xFFFFFFFF
# op name -> the kernel instantiation (kernels._SIGS) and the TPU tool's
# label; "umulhi" has no TPU counterpart
OPS = {
    "mul": "u32 mul",
    "add": "u32 add",
    "shift_add": "u32 shift+mask",
    "f32_mul12": "u32 mul via f32 (12-bit safe)",
    "mul16": "u16->u32 widening-style mul (masked)",
    "umulhi": "u32 mulhi (__umulhi)",
    "mad_lo": "u32 mad.lo chain (multiplies alone)",
    "mad_hi": "u32 mad.hi chain (multiplies alone)",
}
# the multiply-only bodies: op name -> whether it is mad.hi
CHAINS = {"mad_lo": False, "mad_hi": True}
# a kernel's loop body holds REPS_PER_ITER reps of every row: alu.cu's
# `#pragma unroll 4` over reps, ROWS rows each
REPS_PER_ITER = 4
# the C++ kernel each op runs (sass_counts finds its loop by this name)
KERNEL_OF = {**{op: f"alu_throughput_kernel<{i}>" for i, op in enumerate(
    ("mul", "add", "shift_add", "f32_mul12", "mul16", "umulhi"))},
             "mad_lo": "mad_chain_kernel<false>",
             "mad_hi": "mad_chain_kernel<true>"}


def _mul_lo(a, b):
    """Low 32 bits of a * b for a, b in [0, 2^32), in int64 without
    overflow: split b into 16-bit halves."""
    lo = a * (b & 0xFFFF)
    hi = ((a * (b >> 16)) & 0xFFFF) << 16
    return (lo + hi) & M32


def _mul_hi(a, b):
    """High 32 bits of a * b for a, b in [0, 2^32), in int64."""
    a0, a1 = a & 0xFFFF, a >> 16
    b0, b1 = b & 0xFFFF, b >> 16
    mid = a1 * b0 + a0 * b1 + ((a0 * b0) >> 16)
    return a1 * b1 + (mid >> 16)


def _op(name: str, a, b):
    if name == "mul":
        return _mul_lo(a, b)
    if name == "add":
        return (a + b) & M32
    if name == "shift_add":
        return (((a >> 16) & 0xFFFF) + b) & M32
    if name == "f32_mul12":
        return (a & 0xFFF) * (b & 0xFFF)
    if name == "mul16":
        return (a & 0xFFFF) * (b & 0xFFFF)
    if name == "umulhi":
        return _mul_hi(a, b)
    raise ValueError(f"unknown op {name!r}: one of {sorted(OPS)}")


def alu_plain(name: str, a: torch.Tensor, b: torch.Tensor,
              reps: int) -> torch.Tensor:
    """The kernel's loop in int64 on (16, n) int32 tensors holding uint32
    bits; returns int32 with the same bits."""
    x = a.to(torch.int64) & M32
    y = b.to(torch.int64) & M32
    if name in CHAINS:
        acc = x ^ y
        mad = _mul_hi if CHAINS[name] else _mul_lo
        for _ in range(reps):
            acc = (mad(acc, x) + y) & M32
    else:
        acc = torch.zeros_like(x)
        for _ in range(reps):
            acc = acc ^ _op(name, x, y)
            x = x ^ acc
    return torch.where(acc >= 1 << 31, acc - (1 << 32), acc).to(torch.int32)


def alu(name: str, a: torch.Tensor, b: torch.Tensor,
        reps: int) -> torch.Tensor:
    """alu_throughput_kernel<name> on (16, n) int32 CUDA tensors (uint32
    bits); the plain version on CPU tensors."""
    if name not in OPS:
        raise ValueError(f"unknown op {name!r}: one of {sorted(OPS)}")
    if a.device.type == "cpu" and b.device.type == "cpu":
        return alu_plain(name, a, b, reps)
    n = a.shape[-1]
    for t, what in ((a, "a"), (b, "b")):
        kernels.check_cuda(t, f"alu {what}", last_dim=n)
        if t.shape != (ROWS, n) or t.device != a.device:
            raise ValueError(f"alu {what}: expected ({ROWS}, {n}) on "
                             f"{a.device}, got {tuple(t.shape)} on "
                             f"{t.device}")
    if not 1 <= reps < 1 << 31:
        raise ValueError(f"alu: reps {reps} out of range")
    out = torch.empty_like(a)
    kernels.launch(f"alu_{name}", a.device, a.data_ptr(), b.data_ptr(),
                   out.data_ptr(), n, reps, lanes=ROWS * n)
    return out


def inputs(n: int, device, seed: int = 0):
    """(a, b): (16, n) random 16-bit values, as the TPU tool draws them."""
    gen = torch.Generator().manual_seed(seed)
    a = torch.randint(0, 1 << 16, (ROWS, n), generator=gen,
                      dtype=torch.int32)
    b = torch.randint(0, 1 << 16, (ROWS, n), generator=gen,
                      dtype=torch.int32)
    return a.to(device), b.to(device)


def kernel_ms(fn, iters: int) -> float:
    """Mean device milliseconds per call: CUDA events around `iters` calls
    after a warm-up call, queued behind a GPU sleep so that the host's
    launch time does not count."""
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


def check(device, n: int = 4096, reps: int = 256) -> dict:
    """Each op's kernel against its plain version at (16, n), bit for bit.
    Returns {op: max_abs_err} and raises on a difference."""
    a, b = inputs(n, device, seed=1)
    errs = {}
    for name in OPS:
        got, want = alu(name, a, b, reps), alu_plain(name, a, b, reps)
        errs[name] = int((got.to(torch.int64)
                          - want.to(torch.int64)).abs().max())
        if errs[name]:
            raise AssertionError(f"alu {name}: kernel disagrees with its "
                                 "plain version")
    return errs


# instruction classes of sm_90 SASS and their throughput in thread-
# instructions a clock an SM for compute capability 9.0 (CUDA C++
# Programming Guide, "Throughput of Native Arithmetic Instructions"): 32-bit
# integer multiply and multiply-add (IMAD, IMAD.HI, IMAD.WIDE, and IMAD.MOV,
# the moves ptxas writes as a multiply-add) 64; 32-bit integer add,
# logic, shift, compare and select 64; 32-bit floating-point add,
# multiply and fused multiply-add 128; conversions between 32-bit integer
# and floating-point types 16. I2FP, the H100's integer-to-float
# conversion, counts as an integer op: at 16 a clock the loop of
# alu_f32_mul12 (one I2FP and one F2I a product) would take 4.11 ms at
# (16, 2^19) and 1024 reps, where the card ran it in 2.25 (chip_smoke.py
# phase 7 on an H100). Every other instruction counts only toward the
# issue rate: 4 schedulers an SM, one warp-instruction a clock each, 128
# thread-instructions a clock.
SASS_CLASSES = {
    "imad": ("IMAD", "IMUL"),
    "int": ("IADD3", "IADD", "VIADD", "VIADDMNMX", "LOP3", "LOP", "SHF",
            "SHL", "SHR", "ISETP", "SEL", "LEA", "IMNMX", "IABS", "PRMT",
            "BMSK", "SGXT", "I2FP"),
    "fp32": ("FMUL", "FADD", "FFMA", "FSETP", "FMNMX", "FSEL"),
    "conv": ("I2F", "F2I", "F2IP", "FRND"),
}
CC90_PER_CLOCK = {"imad": 64, "int": 64, "fp32": 128, "conv": 16}
ISSUE_PER_CLOCK = 128


def _cuobjdump() -> str:
    path = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(path):
        raise RuntimeError("cuobjdump not found (PATH or /usr/local/cuda/bin)")
    return path


def _loop_opcodes(sass: str) -> list:
    """The opcodes of the largest loop of one function's SASS: the
    instructions from a branch's target to the branch back to it. The
    target is an address (`BRA 0x190`, as cuobjdump prints it) or a label
    (`BRA `(.L_x_3)`, with `.L_x_3:` before its instruction)."""
    insts, labels = [], {}       # (address, opcode, branch target)
    for line in sass.splitlines():
        m = re.match(r"\s*(\.L_x_\d+):", line)
        if m:
            labels[m.group(1)] = len(insts)
            continue
        m = re.match(r"\s*/\*([0-9a-f]+)\*/\s+(?:@!?U?P\w+\s+)?"
                     r"([A-Z][A-Z0-9_.]*)(.*)", line)
        if not m:
            continue
        target = None
        if m.group(2).split(".")[0] == "BRA":
            t = re.search(r"(\.L_x_\d+)|0x([0-9a-f]+)", m.group(3))
            target = t and (t.group(1) or int(t.group(2), 16))
        insts.append((int(m.group(1), 16), m.group(2), target))
    best = []
    for k, (addr, _, target) in enumerate(insts):
        if target is None:
            continue
        start = (labels.get(target) if isinstance(target, str) else
                 next((i for i, x in enumerate(insts) if x[0] == target),
                      None))
        if start is not None and start <= k and k + 1 - start > len(best):
            best = insts[start:k + 1]
    return [op for _, op, _ in best]


def classify(opcodes: list) -> dict:
    """{class: instructions} over SASS_CLASSES and "other"; "total" is
    every instruction."""
    out = {c: 0 for c in (*SASS_CLASSES, "other")}
    for op in opcodes:
        base = op.split(".")[0]
        cls = next((c for c, names in SASS_CLASSES.items() if base in names),
                   "other")
        out[cls] += 1
    out["total"] = len(opcodes)
    return out


def sass_counts(lib_path: str) -> dict:
    """{op: {class: instructions per rep of one row}} from the loop of each
    kernel in the built alu library (cuobjdump -sass): the loop's
    instructions by class over REPS_PER_ITER x ROWS, its counter and
    branch included; with the loop's opcodes under "opcodes". Raises if a
    chain kernel's loop holds fewer IMADs than one a rep of every row."""
    text = subprocess.run([_cuobjdump(), "-sass", lib_path], check=True,
                          capture_output=True, text=True).stdout
    funcs = re.split(r"\n\s*Function : ", text)[1:]
    per = REPS_PER_ITER * ROWS
    out = {}
    for op, kernel in KERNEL_OF.items():
        name, arg = re.match(r"(\w+)<(\w+)>", kernel).groups()
        # Itanium mangling: alu_throughput_kernel<2> is ...ILi2EE...,
        # mad_chain_kernel<true> ...ILb1EE...
        code = {"false": "Lb0E", "true": "Lb1E"}.get(arg, f"Li{arg}E")
        body = [f for f in funcs if f.startswith("_ZN3zkt")
                and f"{len(name)}{name}I{code}E" in f.split()[0]]
        if len(body) != 1:
            raise RuntimeError(f"{kernel}: {len(body)} functions in the SASS")
        ops = _loop_opcodes(body[0])
        counts = classify(ops)
        if op in CHAINS and counts["imad"] < per:
            raise AssertionError(f"{kernel}: {counts['imad']} IMADs in its "
                                 f"loop, fewer than its {per} products")
        out[op] = {c: v / per for c, v in counts.items()}
        out[op]["opcodes"] = dict(collections.Counter(ops))
    return out


def issue_clocks(counts: dict) -> float:
    """Clocks an SM needs per thread-rep of one row for `counts` (a value
    of sass_counts): the largest of each class over its CC 9.0 throughput
    and of every instruction over the issue rate."""
    return max([counts[c] / r for c, r in CC90_PER_CLOCK.items()]
               + [counts["total"] / ISSUE_PER_CLOCK])


def rates(device, log_n: int = 19, reps: int = 1024,
          iters: int = 10) -> dict:
    """{op: {"ms", "lane_ops_per_s"}} at (16, 2^log_n) and `reps`."""
    n = 1 << log_n
    a, b = inputs(n, device)
    out = {}
    for name in OPS:
        ms = kernel_ms(lambda: alu(name, a, b, reps), iters)
        out[name] = {"ms": ms, "lane_ops_per_s": ROWS * n * reps / ms * 1e3}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--log-n", type=int, default=19)
    ap.add_argument("--reps", type=int, default=1024)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_alu: no CUDA device")
        return 2
    dev = torch.device("cuda", 0)
    check(dev)
    print(f"device: {torch.cuda.get_device_name(0)}; (16, 2^{args.log_n}) "
          f"lanes, {args.reps} reps; each op equals its plain version")
    res = rates(dev, args.log_n, args.reps)
    for name, r in res.items():
        print(f"{OPS[name]:44s} {r['ms']:9.4f} ms  "
              f"{r['lane_ops_per_s'] / 1e12:7.3f} T lane-ops/s")
    print(json.dumps({"reps": args.reps, "log_n": args.log_n, "rates": res}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
