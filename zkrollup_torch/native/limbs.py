"""ctypes binding for native/limbs.c: the witness's Python ints to the
scalar field's canonical limb rows in one native pass (fields/limbs.py's
encode_fr calls it).

Built and loaded as engine.py builds and loads libzkhost.so (its
compile_shared and load_once): gcc with -O3 -fPIC -shared against this
interpreter's headers, into build/native/ at the repository root under a
name that carries the interpreter's extension suffix, only when the
library is missing or older than its source. It is opened once a process
with ctypes.PyDLL, which holds the interpreter lock for each call, as the
C API needs. Where it cannot be built or opened, a RuntimeWarning says
why, once, and fr_rows() returns None: the caller then encodes in Python.
"""

from __future__ import annotations

import ctypes
import os
import sysconfig
import warnings
from typing import Optional

import numpy as np

from .engine import BUILD_DIR, compile_shared, load_once, stale

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "limbs.c")
_LIB_PATH = os.path.join(
    BUILD_DIR, "liblimbs" + (sysconfig.get_config_var("EXT_SUFFIX") or ".so"))
CFLAGS = ("-O3", "-fPIC", "-shared", "-Wall", "-Wextra")


def _open():
    err = None
    if stale(_LIB_PATH, [_SRC]):
        err = compile_shared(
            ["gcc", *CFLAGS, "-I", sysconfig.get_paths()["include"], _SRC],
            _LIB_PATH, timeout=120)
    if err is None:
        try:
            lib = ctypes.PyDLL(_LIB_PATH)
        except OSError as e:
            err = str(e)
    if err is not None:
        warnings.warn(f"{_SRC} did not build or load, so the witness is "
                      f"encoded in Python: {err}", RuntimeWarning)
        return None
    lib.zkl_fr_rows.argtypes = (ctypes.py_object, ctypes.c_ssize_t,
                                ctypes.c_void_p, ctypes.c_void_p)
    lib.zkl_fr_rows.restype = ctypes.c_ssize_t
    return lib


_load = load_once(_open)


def fr_rows(xs: list, out: np.ndarray) -> Optional[np.ndarray]:
    """Write the rows of the entries of `xs` that are ints in [0, r) into
    `out`, a C-contiguous (len(xs), 16) int32 array, and return the
    indices of the other entries (int64, ascending), whose rows it leaves
    as they were; None, writing nothing, where the library is missing."""
    n = len(xs)
    if (not isinstance(xs, list) or out.dtype != np.int32
            or out.shape != (n, 16) or not out.flags.c_contiguous
            or not out.flags.writeable):
        raise ValueError("fr_rows: a list and a writable C-contiguous "
                         "(len, 16) int32 array")
    lib = _load()
    if lib is None:
        return None
    slow = np.empty(n, dtype=np.int64)
    k = lib.zkl_fr_rows(xs, n, out.ctypes.data, slow.ctypes.data)
    if k < 0:
        raise RuntimeError("zkl_fr_rows refused its list")
    return slow[:k]
