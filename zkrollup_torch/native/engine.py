"""ctypes binding for libzkhost — the host-native crypto engine.

The port's copy of zkrollup/native/engine.py. The native tier of the
framework: BN254 pairing / Groth16 verification, MiMC hashing, and
BabyJubJub point arithmetic in C++ (native/src/ at the repository root),
playing the role websnark's WASM bn128 engine and circomlib's generated
bytecode play for the reference. Pure-Python ground truth lives in ref/.

The port builds its own library from the repository's sources with g++ and
the flags of native/Makefile, into build/native/libzkhost.so at the
repository root; it never runs that Makefile and writes nothing into the
zkrollup package. `build()` compiles to a temporary file and renames it, so
several processes may build at once. Use `available()` to gate dispatch
(it builds the library once per process when it is missing or older than
its sources).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import List, Optional, Sequence, Tuple

_ROOT = os.path.abspath(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                     "..", ".."))
_SRC_DIR = os.path.join(_ROOT, "native", "src")
_SOURCES = ("api.cc", "fp.h", "tower.h", "curve.h", "pairing.h", "keccak.h",
            "mimc.h", "babyjubjub.h", "prover.h")
BUILD_DIR = os.path.join(_ROOT, "build", "native")
_LIB_PATH = os.path.join(BUILD_DIR, "libzkhost.so")
# native/Makefile's CXXFLAGS, then its -shared link of src/api.cc
CXXFLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra",
            "-fno-exceptions", "-pthread", "-shared")


def stale(lib_path: str, srcs: Sequence[str]) -> bool:
    """True where lib_path is missing or older than one of srcs."""
    if not os.path.exists(lib_path):
        return True
    built = os.path.getmtime(lib_path)
    return any(os.path.getmtime(p) > built for p in srcs if os.path.exists(p))


def compile_shared(cmd: Sequence[str], lib_path: str,
                   timeout: float) -> Optional[str]:
    """Run the compiler command `cmd` with `-o` a temporary file beside
    lib_path, then rename that file to lib_path, so several processes may
    build at once. Returns None on success, else what went wrong (the
    compiler's standard error where it ran)."""
    os.makedirs(os.path.dirname(lib_path), exist_ok=True)
    tmp = f"{lib_path}.{os.getpid()}.tmp"
    try:
        res = subprocess.run([*cmd, "-o", tmp], capture_output=True,
                             timeout=timeout)
        err = (None if res.returncode == 0 and os.path.exists(tmp) else
               res.stderr.decode(errors="replace").strip()
               or f"exit code {res.returncode}")
    except (OSError, subprocess.TimeoutExpired) as e:
        err = str(e)
    if err is not None:
        if os.path.exists(tmp):
            os.remove(tmp)
        return err
    os.replace(tmp, lib_path)
    return None


def load_once(open_lib):
    """A function that returns open_lib()'s result (a library, or None),
    calling open_lib at most once a process, under a lock."""
    lock = threading.Lock()
    opened = []

    def load():
        with lock:
            if not opened:
                opened.append(open_lib())
            return opened[0]
    return load


def build() -> bool:
    """Compile native/src/api.cc into build/native/libzkhost.so. Returns
    True on success."""
    src = os.path.join(_SRC_DIR, "api.cc")
    if not os.path.exists(src):
        return False
    cmd = [os.environ.get("CXX", "g++"), *CXXFLAGS, src]
    return compile_shared(cmd, _LIB_PATH, timeout=300) is None


def _open():
    if stale(_LIB_PATH, [os.path.join(_SRC_DIR, f) for f in _SOURCES]):
        if os.environ.get("ZKROLLUP_NATIVE", "auto") == "0":
            return None
        if not build():
            return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError:
        return None
    lib.zkh_version.restype = ctypes.c_int
    if lib.zkh_version() < 4:
        return None
    return lib


_load = load_once(_open)


def available() -> bool:
    if os.environ.get("ZKROLLUP_NATIVE", "auto") == "0":
        return False
    return _load() is not None


# -- serialization helpers ---------------------------------------------------

def _fe(x: int) -> bytes:
    """field element -> 32-byte LE (value must already be < 2^256)."""
    return (x % (1 << 256)).to_bytes(32, "little")


def _fe_out() -> ctypes.Array:
    return ctypes.create_string_buffer(32)


def _read_fe(buf) -> int:
    return int.from_bytes(bytes(buf[:32]), "little")


def _g1(p: Optional[Tuple[int, int]]) -> bytes:
    if p is None:
        return b"\x00" * 64 + b"\x01"
    return _fe(p[0]) + _fe(p[1]) + b"\x00"


def _read_g1(buf) -> Optional[Tuple[int, int]]:
    b = bytes(buf[:65])
    if b[64]:
        return None
    return (int.from_bytes(b[:32], "little"),
            int.from_bytes(b[32:64], "little"))


def _g2(p) -> bytes:
    if p is None:
        return b"\x00" * 128 + b"\x01"
    (x0, x1), (y0, y1) = p
    return _fe(x0) + _fe(x1) + _fe(y0) + _fe(y1) + b"\x00"


def _read_g2(buf):
    b = bytes(buf[:129])
    if b[128]:
        return None
    vals = [int.from_bytes(b[32 * i:32 * (i + 1)], "little")
            for i in range(4)]
    return ((vals[0], vals[1]), (vals[2], vals[3]))


# -- keccak / MiMC -----------------------------------------------------------

def keccak256(data: bytes) -> bytes:
    lib = _load()
    out = ctypes.create_string_buffer(32)
    lib.zkh_keccak256(data, ctypes.c_size_t(len(data)), out)
    return bytes(out)


def mimc_multi_hash(values: Sequence[int], key: int = 0) -> int:
    lib = _load()
    vals = b"".join(_fe(v) for v in values)
    out = _fe_out()
    lib.zkh_mimc_multihash(vals, ctypes.c_size_t(len(values)), _fe(key), out)
    return _read_fe(out)


def mimc_multi_hash_many(rows: Sequence[Sequence[int]], key: int = 0
                         ) -> List[int]:
    """Hash many same-width rows in one native call."""
    if not rows:
        return []
    row_len = len(rows[0])
    lib = _load()
    flat = b"".join(_fe(v) for row in rows for v in row)
    out = ctypes.create_string_buffer(32 * len(rows))
    lib.zkh_mimc_multihash_many(flat, ctypes.c_size_t(len(rows)),
                                ctypes.c_size_t(row_len), _fe(key), out)
    raw = bytes(out)
    return [int.from_bytes(raw[32 * i:32 * (i + 1)], "little")
            for i in range(len(rows))]


def mimc7_hash(x: int, k: int) -> int:
    lib = _load()
    out = _fe_out()
    lib.zkh_mimc7_hash(_fe(x), _fe(k), out)
    return _read_fe(out)


def mimc7_multi_hash(values: Sequence[int], key: int = 0) -> int:
    lib = _load()
    vals = b"".join(_fe(v) for v in values)
    out = _fe_out()
    lib.zkh_mimc7_multihash(vals, ctypes.c_size_t(len(values)), _fe(key), out)
    return _read_fe(out)


# -- BN254 curve ops ----------------------------------------------------------

def g1_add(a, b):
    lib = _load()
    out = ctypes.create_string_buffer(65)
    rc = lib.zkh_g1_add(_g1(a), _g1(b), out)
    if rc != 1:
        raise ValueError("invalid G1 point")
    return _read_g1(out)


def g1_mul(p, k: int):
    lib = _load()
    out = ctypes.create_string_buffer(65)
    kb = k.to_bytes((max(k.bit_length(), 1) + 7) // 8, "little")
    rc = lib.zkh_g1_mul(_g1(p), kb, ctypes.c_size_t(len(kb)), out)
    if rc != 1:
        raise ValueError("invalid G1 point")
    return _read_g1(out)


def g2_add(a, b):
    lib = _load()
    out = ctypes.create_string_buffer(129)
    rc = lib.zkh_g2_add(_g2(a), _g2(b), out)
    if rc != 1:
        raise ValueError("invalid G2 point")
    return _read_g2(out)


def g2_mul(p, k: int):
    lib = _load()
    out = ctypes.create_string_buffer(129)
    kb = k.to_bytes((max(k.bit_length(), 1) + 7) // 8, "little")
    rc = lib.zkh_g2_mul(_g2(p), kb, ctypes.c_size_t(len(kb)), out)
    if rc != 1:
        raise ValueError("invalid G2 point")
    return _read_g2(out)


def g1_msm(points, scalars) -> Optional[Tuple[int, int]]:
    lib = _load()
    out = ctypes.create_string_buffer(65)
    pts = b"".join(_g1(p) for p in points)
    sc = b"".join(_fe(s) for s in scalars)
    rc = lib.zkh_g1_msm(pts, sc, ctypes.c_size_t(len(points)), out)
    if rc != 1:
        raise ValueError("invalid G1 point in msm")
    return _read_g1(out)


def pairing_check(pairs) -> bool:
    """prod e(P_i, Q_i) == 1; raises on malformed/off-curve points."""
    lib = _load()
    g1s = b"".join(_g1(p) for p, _ in pairs)
    g2s = b"".join(_g2(q) for _, q in pairs)
    rc = lib.zkh_pairing_check(g1s, g2s, ctypes.c_size_t(len(pairs)))
    if rc < 0:
        raise ValueError("malformed pairing input")
    return rc == 1


def groth16_verify(vk, proof, public_signals: Sequence[int]) -> int:
    """Returns 1 accept, 0 reject, -1 malformed. `vk`/`proof` are the
    dataclasses from groth16/keys.py."""
    lib = _load()
    vk_buf = (_g1(vk.alpha1) + _g2(vk.beta2) + _g2(vk.gamma2)
              + _g2(vk.delta2) + b"".join(_g1(p) for p in vk.ic))
    proof_buf = _g1(proof.a) + _g2(proof.b) + _g1(proof.c)
    inputs = b"".join(_fe(s) for s in public_signals)
    return lib.zkh_groth16_verify(
        vk_buf, ctypes.c_size_t(len(vk.ic)), proof_buf, inputs,
        ctypes.c_size_t(len(public_signals)))


def pairing(p, q) -> tuple:
    """e(P, Q) as a 6-tuple of Fq2 pairs (test introspection)."""
    lib = _load()
    out = ctypes.create_string_buffer(384)
    lib.zkh_pairing(_g1(p), _g2(q), out)
    raw = bytes(out)
    vals = [int.from_bytes(raw[32 * i:32 * (i + 1)], "little")
            for i in range(12)]
    return tuple((vals[2 * i], vals[2 * i + 1]) for i in range(6))


# -- GLV decomposition ---------------------------------------------------------

def glv_decompose_batch(scalars: Sequence[int]):
    """scalars (ints < r) -> (abs (2n, 16) uint32 limbs, neg (2n, 1) bool):
    |k1| rows then |k2| rows with k = k1 + k2*lambda (mod r). One C call;
    limb conversion is a zero-copy uint16 view of the output buffer."""
    buf = b"".join(_fe(s) for s in scalars)
    return _glv_decompose_raw(buf, len(scalars))


def glv_decompose_limbs(limbs):
    """(n, 16) uint32 canonical limbs (< r) -> same contract as
    glv_decompose_batch, but the input packing is one vectorized numpy
    narrowing instead of n python int.to_bytes calls (~10x)."""
    import numpy as np
    a = np.ascontiguousarray(np.asarray(limbs, dtype=np.uint32),
                             dtype=np.uint32)
    buf = a.astype("<u2").tobytes()
    return _glv_decompose_raw(buf, a.shape[0])


def _glv_decompose_raw(buf: bytes, n: int):
    import numpy as np
    lib = _load()
    abs_out = ctypes.create_string_buffer(64 * n)
    neg_out = ctypes.create_string_buffer(2 * n)
    lib.zkh_glv_decompose(buf, ctypes.c_size_t(n), abs_out, neg_out)
    abs_limbs = np.frombuffer(abs_out, dtype="<u2").reshape(
        2 * n, 16).astype(np.uint32)
    neg = np.frombuffer(neg_out, dtype=np.uint8).reshape(2 * n, 1) != 0
    return abs_limbs, neg


# -- BabyJubJub ----------------------------------------------------------------

def bjj_add(a: Tuple[int, int], b: Tuple[int, int]) -> Tuple[int, int]:
    lib = _load()
    out = ctypes.create_string_buffer(64)
    lib.zkh_bjj_add(_fe(a[0]) + _fe(a[1]), _fe(b[0]) + _fe(b[1]), out)
    raw = bytes(out)
    return (int.from_bytes(raw[:32], "little"),
            int.from_bytes(raw[32:], "little"))


def bjj_mul(p: Tuple[int, int], k: int) -> Tuple[int, int]:
    """Raw-scalar double-and-add (no reduction) — babyjub.js semantics."""
    lib = _load()
    out = ctypes.create_string_buffer(64)
    kb = k.to_bytes((max(k.bit_length(), 1) + 7) // 8, "little")
    lib.zkh_bjj_mul(_fe(p[0]) + _fe(p[1]), kb, ctypes.c_size_t(len(kb)), out)
    raw = bytes(out)
    return (int.from_bytes(raw[:32], "little"),
            int.from_bytes(raw[32:], "little"))


def bjj_on_curve(p: Tuple[int, int]) -> bool:
    lib = _load()
    return lib.zkh_bjj_on_curve(_fe(p[0]) + _fe(p[1])) == 1

# -- host Groth16 prover core --------------------------------------------------

def _limbs_to_bytes(limbs) -> bytes:
    """(n, 16) uint32 16-bit-limb array -> n*32 bytes LE (zero-copy
    narrowing: the uint16 planes ARE the byte layout)."""
    import numpy as np
    a = np.ascontiguousarray(np.asarray(limbs, dtype=np.uint32))
    return a.astype("<u2").tobytes()


def _bytes_to_limbs(buf: bytes, n: int):
    import numpy as np
    return np.frombuffer(buf, dtype="<u2").reshape(n, 16).astype(np.uint32)


def fr_ntt_bytes(data: bytes, n: int, inverse: bool) -> bytes:
    """In-place NTT over n standard-form 32-byte-LE Fr elements."""
    lib = _load()
    buf = ctypes.create_string_buffer(data, len(data))
    lib.zkh_fr_ntt(buf, ctypes.c_size_t(n), ctypes.c_int(int(inverse)))
    return buf.raw[:32 * n]


def groth16_quotient(coo, witness_bytes: bytes, nv: int, m: int) -> bytes:
    """COO matrices (qap.CooMatrices: int32 row/var + (nnz, 16) mont coeff
    limbs) + standard-form witness bytes -> h coefficient bytes (m*32,
    standard form; only the first m-1 are meaningful)."""
    import numpy as np
    lib = _load()

    def arrs(row, var, coeff):
        r = np.ascontiguousarray(row, dtype=np.uint32)
        v = np.ascontiguousarray(var, dtype=np.uint32)
        cb = _limbs_to_bytes(coeff)
        return (r.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
                v.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
                cb, ctypes.c_size_t(len(r)), (r, v, cb))

    a = arrs(coo.a_row, coo.a_var, coo.a_coeff)
    b = arrs(coo.b_row, coo.b_var, coo.b_coeff)
    c = arrs(coo.c_row, coo.c_var, coo.c_coeff)
    h_out = ctypes.create_string_buffer(32 * m)
    lib.zkh_groth16_quotient(a[0], a[1], a[2], a[3],
                             b[0], b[1], b[2], b[3],
                             c[0], c[1], c[2], c[3],
                             witness_bytes, ctypes.c_size_t(nv),
                             ctypes.c_size_t(m), h_out)
    return h_out.raw


def g1_msm_pip(table_bytes, scalars_bytes: bytes, n: int, c: int = 0):
    """table_bytes = (xs, ys, infs) raw-mont planes; scalars standard-form
    bytes. Returns affine (x, y) ints or None."""
    lib = _load()
    xs, ys, infs = table_bytes
    out = ctypes.create_string_buffer(65)
    lib.zkh_g1_msm_pip(xs, ys, infs, scalars_bytes, ctypes.c_size_t(n),
                       ctypes.c_int(c), out)
    return _read_g1(out)


def g2_msm_pip(table_bytes, scalars_bytes: bytes, n: int, c: int = 0):
    lib = _load()
    xs0, xs1, ys0, ys1, infs = table_bytes
    out = ctypes.create_string_buffer(129)
    lib.zkh_g2_msm_pip(xs0, xs1, ys0, ys1, infs, scalars_bytes,
                       ctypes.c_size_t(n), ctypes.c_int(c), out)
    return _read_g2(out)


def pack_g1_table_mont(table) -> tuple:
    """(x, y, inf) packed 16-limb mont arrays -> raw byte planes for
    g1_msm_pip (cache the result: zero arithmetic, pure relayout)."""
    import numpy as np
    x, y, inf = table
    infb = np.ascontiguousarray(
        np.asarray(inf).reshape(-1), dtype=np.uint8).tobytes()
    return (_limbs_to_bytes(x), _limbs_to_bytes(y), infb)


def pack_g1_points_mont(points) -> tuple:
    """Affine G1 points as ints ((x, y), or None at infinity) -> the raw
    Montgomery byte planes (xs, ys, infs) of g1_msm_pip: each coordinate
    x * 2^256 mod q, 32 bytes little-endian; an infinity entry is zero
    with its infs byte set."""
    from ..ref.bn254 import Q
    zero = bytes(32)
    xs, ys, infs = [], [], bytearray(len(points))
    for i, p in enumerate(points):
        if p is None:
            xs.append(zero)
            ys.append(zero)
            infs[i] = 1
        else:
            xs.append(((p[0] << 256) % Q).to_bytes(32, "little"))
            ys.append(((p[1] << 256) % Q).to_bytes(32, "little"))
    return b"".join(xs), b"".join(ys), bytes(infs)


def pack_g2_table_mont(table) -> tuple:
    import numpy as np
    (x0, x1), (y0, y1), inf = table
    infb = np.ascontiguousarray(
        np.asarray(inf).reshape(-1), dtype=np.uint8).tobytes()
    return (_limbs_to_bytes(x0), _limbs_to_bytes(x1), _limbs_to_bytes(y0),
            _limbs_to_bytes(y1), infb)


def g1_fixed_base_mont(scalars_bytes: bytes, n: int):
    """scalars (std form) -> packed-affine mont limb arrays
    ((n,16) x, (n,16) y, (n,1) inf) — the setup-table fast path."""
    import numpy as np
    lib = _load()
    xs = ctypes.create_string_buffer(32 * n)
    ys = ctypes.create_string_buffer(32 * n)
    infs = ctypes.create_string_buffer(n)
    lib.zkh_g1_fixed_base_mont(scalars_bytes, ctypes.c_size_t(n),
                               xs, ys, infs)
    inf = np.frombuffer(infs, dtype=np.uint8).reshape(n, 1).astype(bool)
    return (_bytes_to_limbs(xs.raw, n), _bytes_to_limbs(ys.raw, n), inf)


def g2_fixed_base_mont(scalars_bytes: bytes, n: int):
    import numpy as np
    lib = _load()
    bufs = [ctypes.create_string_buffer(32 * n) for _ in range(4)]
    infs = ctypes.create_string_buffer(n)
    lib.zkh_g2_fixed_base_mont(scalars_bytes, ctypes.c_size_t(n),
                               bufs[0], bufs[1], bufs[2], bufs[3], infs)
    inf = np.frombuffer(infs, dtype=np.uint8).reshape(n, 1).astype(bool)
    x0, x1, y0, y1 = (_bytes_to_limbs(b.raw, n) for b in bufs)
    return ((x0, x1), (y0, y1), inf)


def ints_to_fr_bytes(vals) -> bytes:
    """host ints -> n*32 LE standard-form bytes (reduced mod r)."""
    r = 21888242871839275222246405745257275088548364400416034343698204186575808495617
    return b"".join((v % r).to_bytes(32, "little") for v in vals)
