"""Radix-2 NTT / iNTT over BN254 Fr on limb tensors.

Counterpart of zkrollup/ntt/ntt.py: iterative Cooley-Tukey over a
bit-reversed copy, one butterfly launch per stage (in place, through
fields/cuda_mont.ntt_stage_), per-stage twiddle tables in Montgomery form,
and the n^-1 scaling of the inverse as one Montgomery product. Coset
transforms use the shift g = 5.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..fields.mont import FR
from ..fields import limbs as L
from ..fields.cuda_mont import ntt_stage_

TWO_ADICITY = 28
GENERATOR = 5
ROOT_OF_UNITY = pow(GENERATOR, (FR.p - 1) >> TWO_ADICITY, FR.p)
COSET_SHIFT = GENERATOR


@lru_cache(maxsize=None)
def domain_root(log_n: int) -> int:
    if log_n > TWO_ADICITY:
        raise ValueError("domain exceeds the 2-adicity of Fr")
    return pow(ROOT_OF_UNITY, 1 << (TWO_ADICITY - log_n), FR.p)


@lru_cache(maxsize=None)
def bit_rev_perm(log_n: int) -> np.ndarray:
    n = 1 << log_n
    idx = np.arange(n)
    rev = np.zeros(n, dtype=np.int64)
    for b in range(log_n):
        rev |= ((idx >> b) & 1) << (log_n - 1 - b)
    return rev


@lru_cache(maxsize=None)
def _stage_twiddles_host(log_n: int, inverse: bool) -> tuple:
    """Per-stage twiddle tables (host numpy, Montgomery form); stage s has
    m = 2^s entries w_m^j."""
    w_n = domain_root(log_n)
    if inverse:
        w_n = pow(w_n, FR.p - 2, FR.p)
    tables = []
    for s in range(log_n):
        m = 1 << s
        w_m = pow(w_n, 1 << (log_n - 1 - s), FR.p)
        tw = [1] * m
        for j in range(1, m):
            tw[j] = tw[j - 1] * w_m % FR.p
        tables.append(FR.to_mont_host(tw))
    return tuple(tables)


@lru_cache(maxsize=None)
def _coset_powers_host(log_n: int, inverse: bool) -> np.ndarray:
    n = 1 << log_n
    g = pow(COSET_SHIFT, FR.p - 2, FR.p) if inverse else COSET_SHIFT
    pw = [1] * n
    for i in range(1, n):
        pw[i] = pw[i - 1] * g % FR.p
    return FR.to_mont_host(pw)


class _DeviceTables:
    """Twiddle, permutation and coset tables per (log_n, device)."""

    def __init__(self):
        self._cache = {}

    def get(self, kind: str, log_n: int, inverse: bool, device):
        key = (kind, log_n, inverse, str(torch.device(device)))
        t = self._cache.get(key)
        if t is None:
            if kind == "twiddles":
                t = [L.to_device(a, device)
                     for a in _stage_twiddles_host(log_n, inverse)]
            elif kind == "perm":
                t = torch.from_numpy(bit_rev_perm(log_n)).to(device)
            else:
                t = L.to_device(_coset_powers_host(log_n, inverse), device)
            self._cache[key] = t
        return t


_TABLES = _DeviceTables()


def _log2(n: int) -> int:
    log_n = int(n).bit_length() - 1
    if n <= 0 or 1 << log_n != n:
        raise ValueError("domain must be a power of two")
    return log_n


def ntt_mont(a: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """In-order -> in-order transform of (n, 16) Montgomery-form values.
    Forward: evaluations at w^0..w^{n-1}. Inverse: interpolation, with the
    1/n scaling."""
    n = a.shape[0]
    log_n = _log2(n)
    perm = _TABLES.get("perm", log_n, False, a.device)
    x = a.to(L.DTYPE).index_select(0, perm)
    tables = _TABLES.get("twiddles", log_n, inverse, a.device)
    for s in range(log_n):
        ntt_stage_(FR, x, tables[s], 1 << s)
    if inverse:
        x = FR.mont_mul(x, FR.const_mont(pow(n, FR.p - 2, FR.p), a.device))
    return x


def intt_mont(a: torch.Tensor) -> torch.Tensor:
    return ntt_mont(a, inverse=True)


def coset_scale_mont(a: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """Multiply coefficient i by g^i (or g^-i)."""
    log_n = _log2(a.shape[0])
    return FR.mont_mul(a.to(L.DTYPE).contiguous(),
                       _TABLES.get("coset", log_n, inverse, a.device))


def coset_ntt_mont(coeffs: torch.Tensor) -> torch.Tensor:
    """Evaluate the polynomial on the coset g*H."""
    return ntt_mont(coset_scale_mont(coeffs))


def coset_intt_mont(evals: torch.Tensor) -> torch.Tensor:
    """Interpolate from evaluations on g*H back to coefficients."""
    return coset_scale_mont(intt_mont(evals), inverse=True)
