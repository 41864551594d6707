"""Integer-unit throughput on an NVIDIA GPU: u32 multiply against add,
shift, a 12-bit f32 multiply, a masked 16-bit multiply and __umulhi.

Counterpart of tools/profile_vpu.py, the TPU vector-unit probe. The kernel
(csrc/alu.cu, alu_throughput_kernel<OP>) computes what that tool's Pallas
body computes, per lane of a (16, n) uint32 array:

    acc = 0; repeat reps times: acc ^= op(a, b); a ^= acc;   out = acc

The plain version is the same loop in torch int64, masked to 32 bits; it
is exact for every op. Rates are lane-ops per second, 16 n reps over the
kernel's device time (CUDA events). reps must be large: a lane reads 8 B
and writes 4 B, so at the TPU tool's 16 reps device memory alone caps the
rate at 3.35 TB/s / 12 B x 16 = 4.5 T lane-ops/s, below the multiply peak.

    python -m zkrollup_torch.tools.profile_alu [--log-n 19] [--reps 1024]
"""

from __future__ import annotations

import argparse
import json

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
}


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
