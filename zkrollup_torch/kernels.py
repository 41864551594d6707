"""Build, load and launch the hand-written CUDA kernels (csrc/).

Each source unit of csrc/ (fields.cu, g1.cu, g2.cu, mimc.cu, alu.cu) is
compiled by its own nvcc for sm_90a into a shared library with a plain C
interface, bound with ctypes. The first launch builds all five at once, in
parallel,
into build/kernels/ at the repository root, keyed by a hash of the
sources, so an edited source rebuilds and an unchanged one loads in
milliseconds.

Every launch goes through `launch`, which passes PyTorch's current stream,
raises on a non-zero cudaGetLastError(), adds one to the kernel's count in
LAUNCHES, its lanes (the launch's work items) to its sum in LANES and one
to the count of that width in WIDTHS. The wrappers that call it live beside their plain PyTorch versions
(fields/cuda_mont.py, curve/cuda_curve.py, hash/mimc.py,
tools/profile_alu.py).
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

import torch

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
# source unit -> its .cu file; every unit includes some of the headers
UNITS = {"fields": "fields.cu", "g1": "g1.cu", "g2": "g2.cu",
         "mimc": "mimc.cu", "alu": "alu.cu"}
_HEADERS = ("capi.cuh", "field.cuh", "fq2_pair.cuh", "fq_call.cuh",
            "curve.cuh", "points.cuh")
BUILD_DIR = os.path.join(os.path.dirname(_CSRC), "..", "build", "kernels")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_POINT = [_P, _P, _I64, _P]
_ALU = [_P, _P, _P, _I64, ctypes.c_int, _P]
_ADD_SUB = [_P, _P, ctypes.c_int, ctypes.c_int, _P, _I64, _P]
# kernel name -> (source unit, C symbol, argtypes)
_SIGS = {
    "mont_mul[fr]": ("fields", "zkt_mont_mul_fr",
                     [_P, _P, _P, ctypes.c_int, _P, _I64, _P]),
    "mont_mul[fq]": ("fields", "zkt_mont_mul_fq",
                     [_P, _P, _P, ctypes.c_int, _P, _I64, _P]),
    "ntt_pass": ("fields", "zkt_ntt_pass_fr",
                 [_P, _P, _P, _I64, _P, _P, ctypes.c_int, _P, _P, _P, _I64,
                  _I64] + [ctypes.c_int] * 4 + [_P]),
    "fold[fr]": ("fields", "zkt_fold_fr", [_P, _P, _P, _P, _I64, _P]),
    "inv[fq]": ("fields", "zkt_inv_fq", [_P, _P, _I64, _P]),
    "inv[fq2]": ("fields", "zkt_inv_fq2", [_P, _P, _P, _P, _I64, _P]),
    **{f"{op}[{f}]": ("fields", f"zkt_{op}_{f}", _ADD_SUB)
       for op in ("add", "sub") for f in ("fr", "fq")},
    "mimc_sponge[fr]": ("mimc", "zkt_mimc_sponge_fr",
                        [_P, ctypes.c_int, _P, ctypes.c_int, _P, _P, _I64,
                         _P]),
    **{f"{g}_{k}": (g, f"zkt_{g}_{k}", _POINT) for g in ("g1", "g2")
       for k in ("add", "madd_nd", "double", "madd", "add_nd", "add_z01")},
    **{f"{g}_horner": (g, f"zkt_{g}_horner", [_P, _P, _I64, ctypes.c_int,
                                              _P]) for g in ("g1", "g2")},
    **{f"alu_{op}": ("alu", f"zkt_alu_{op}", _ALU)
       for op in ("mul", "add", "shift_add", "f32_mul12", "mul16",
                  "umulhi", "mad_lo", "mad_hi")},
}

# launches per kernel since the last reset_launches(), their lanes, and
# the launches at each width (lanes a launch)
LAUNCHES = {name: 0 for name in _SIGS}
LANES = {name: 0 for name in _SIGS}
WIDTHS = {name: collections.Counter() for name in _SIGS}

_libs = None
_lock = threading.Lock()
build_info = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
        LANES[k] = 0
        WIDTHS[k].clear()


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (PATH or /usr/local/cuda/bin)")
    return path


def inv_per_thread() -> int:
    """The lanes a thread of the inversion kernels (inv[fq], inv[fq2])
    takes: INV_PER_THREAD, set in csrc/fields.cu and nowhere else."""
    import re
    with open(os.path.join(_CSRC, UNITS["fields"])) as f:
        m = re.search(r"^constexpr int INV_PER_THREAD = (\d+);$", f.read(),
                      re.M)
    if m is None:
        raise RuntimeError("csrc/fields.cu declares no "
                           "'constexpr int INV_PER_THREAD = <n>;'")
    return int(m.group(1))


def _source_tag() -> str:
    h = hashlib.sha256()
    for name in sorted(_HEADERS + tuple(UNITS.values())):
        with open(os.path.join(_CSRC, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build() -> dict:
    """Compile every unit of csrc/ into build/kernels/libzkt_<unit>_<hash>.so
    (once per source hash), all nvcc processes started together, and return
    {unit: path}. Each unit's ptxas report lands beside its library."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tag = _source_tag()
    paths = {u: os.path.abspath(os.path.join(BUILD_DIR,
                                             f"libzkt_{u}_{tag}.so"))
             for u in UNITS}
    todo = [u for u, p in paths.items() if not os.path.exists(p)]
    t0 = time.time()
    procs = {}
    try:
        for u in todo:
            tmp = f"{paths[u]}.{os.getpid()}.tmp"
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
                   os.path.join(_CSRC, UNITS[u])]
            procs[u] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                         stderr=subprocess.PIPE, text=True),
                        cmd, tmp)
        failed = []
        for u, (proc, cmd, tmp) in procs.items():
            out, err = proc.communicate()
            with open(paths[u][:-3] + ".log", "w") as f:
                f.write(" ".join(cmd) + "\n" + out + err)
            if proc.returncode != 0:
                failed.append(f"{UNITS[u]} ({proc.returncode}):\n"
                              f"{err[-4000:]}")
            else:
                os.replace(tmp, paths[u])
    finally:
        for proc, _, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    build_info.update(paths=paths, seconds=time.time() - t0,
                      built=todo, logs={u: p[:-3] + ".log"
                                        for u, p in paths.items()})
    return paths


def bind(unit: str, path: str) -> ctypes.CDLL:
    """Load a built library of source unit `unit` and declare the C
    signatures of its entry points. An entry point the library lacks (a
    build of other sources, chip_smoke.py --ab) stays undeclared, and
    launching it raises."""
    lib = ctypes.CDLL(path)
    for u, sym, argtypes in _SIGS.values():
        if u == unit and hasattr(lib, sym):
            fn = getattr(lib, sym)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    lib.zkt_set_device.argtypes = [ctypes.c_int]
    lib.zkt_set_device.restype = ctypes.c_int
    lib.zkt_error_string.argtypes = [ctypes.c_int]
    lib.zkt_error_string.restype = ctypes.c_char_p
    return lib


def load() -> dict:
    """The kernel libraries, {unit: ctypes.CDLL}, built on first use."""
    global _libs
    with _lock:
        if _libs is None:
            _libs = {u: bind(u, p) for u, p in build().items()}
    return _libs


def launch(name: str, device: torch.device, *args, lanes: int) -> None:
    """Launch kernel `name` on `device`'s current PyTorch stream. `args` are
    the kernel's arguments before the stream (data pointers as ints);
    `lanes` is the launch's count of work items (points, products,
    rows, butterflies), summed in LANES and counted by width in WIDTHS."""
    unit, sym, _ = _SIGS[name]
    lib = load()[unit]
    rc = lib.zkt_set_device(device.index or 0)
    if rc == 0:
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, sym)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name}: error {rc} "
                           f"({lib.zkt_error_string(rc).decode()})")
    LAUNCHES[name] += 1
    LANES[name] += lanes
    WIDTHS[name][lanes] += 1


def check_cuda(t: torch.Tensor, what: str, last_dim: int = 16) -> None:
    """Raise unless `t` is a contiguous int32 CUDA tensor (..., last_dim)
    whose rows are 16-byte aligned."""
    if t.device.type != "cuda":
        raise ValueError(f"{what}: expected a CUDA tensor, got {t.device}")
    if t.dtype != torch.int32:
        raise ValueError(f"{what}: expected int32 limbs, got {t.dtype}")
    if t.dim() < 1 or t.shape[-1] != last_dim:
        raise ValueError(f"{what}: expected (..., {last_dim}), got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous tensor")
    if t.data_ptr() % 16:
        raise ValueError(f"{what}: rows must be 16-byte aligned")
