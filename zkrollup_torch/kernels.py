"""Build, load and launch the hand-written CUDA kernels (csrc/).

The sources are compiled with nvcc for sm_90a into a shared library with a
plain C interface and bound with ctypes. The first launch builds them into
build/kernels/ at the repository root, keyed by a hash of the sources, so
an edited source rebuilds and an unchanged one loads in milliseconds.

Every launch goes through `launch`, which passes PyTorch's current stream,
raises on a non-zero cudaGetLastError() and adds one to the kernel's count
in LAUNCHES. The wrappers that call it live beside their plain PyTorch
versions (fields/cuda_mont.py, curve/cuda_curve.py).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

import torch

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
_SOURCES = ("kernels.cu", "field.cuh", "curve.cuh")
BUILD_DIR = os.path.join(os.path.dirname(_CSRC), "..", "build", "kernels")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
# kernel name -> (C symbol, argtypes)
_SIGS = {
    "mont_mul[fr]": ("zkt_mont_mul_fr", [_P, _P, ctypes.c_int, _P, _I64, _P]),
    "mont_mul[fq]": ("zkt_mont_mul_fq", [_P, _P, ctypes.c_int, _P, _I64, _P]),
    "butterfly": ("zkt_butterfly_fr", [_P, _P, _I64, _I64, _P]),
    "g1_add": ("zkt_g1_add", [_P, _P, _I64, _P]),
    "g1_madd_nd": ("zkt_g1_madd_nd", [_P, _P, _I64, _P]),
    "g2_add": ("zkt_g2_add", [_P, _P, _I64, _P]),
    "g2_madd_nd": ("zkt_g2_madd_nd", [_P, _P, _I64, _P]),
    "g1_double": ("zkt_g1_double", [_P, _P, _I64, _P]),
    "g2_double": ("zkt_g2_double", [_P, _P, _I64, _P]),
    "g1_madd": ("zkt_g1_madd", [_P, _P, _I64, _P]),
    "g2_madd": ("zkt_g2_madd", [_P, _P, _I64, _P]),
}

# launches per kernel since the last reset_launches()
LAUNCHES = {name: 0 for name in _SIGS}

_lib = None
_lock = threading.Lock()
build_info = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (PATH or /usr/local/cuda/bin)")
    return path


def _source_tag() -> str:
    h = hashlib.sha256()
    for name in _SOURCES:
        with open(os.path.join(_CSRC, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build() -> str:
    """Compile csrc/ into build/kernels/libzkt_<hash>.so (once per source
    hash) and return its path; nvcc's ptxas report lands beside it."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tag = _source_tag()
    out = os.path.abspath(os.path.join(BUILD_DIR, f"libzkt_{tag}.so"))
    log = out[:-3] + ".log"
    if os.path.exists(out):
        build_info.update(path=out, seconds=0.0, cached=True, log=log)
        return out
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(_CSRC, "kernels.cu")]
    t0 = time.time()
    res = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.time() - t0
    with open(log, "w") as f:
        f.write(" ".join(cmd) + "\n" + res.stdout + res.stderr)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                           f"{res.stderr[-4000:]}")
    os.replace(tmp, out)
    build_info.update(path=out, seconds=seconds, cached=False, log=log)
    return out


def load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            for sym, argtypes in _SIGS.values():
                fn = getattr(lib, sym)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.zkt_set_device.argtypes = [ctypes.c_int]
            lib.zkt_set_device.restype = ctypes.c_int
            lib.zkt_error_string.argtypes = [ctypes.c_int]
            lib.zkt_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def launch(name: str, device: torch.device, *args) -> None:
    """Launch kernel `name` on `device`'s current PyTorch stream. `args` are
    the kernel's arguments before the stream (data pointers as ints)."""
    lib = load()
    sym, _ = _SIGS[name]
    rc = lib.zkt_set_device(device.index or 0)
    if rc == 0:
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, sym)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name}: error {rc} "
                           f"({lib.zkt_error_string(rc).decode()})")
    LAUNCHES[name] += 1


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
