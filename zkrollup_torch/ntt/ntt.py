"""Radix-2 NTT / iNTT over BN254 Fr on limb tensors.

Counterpart of zkrollup/ntt/ntt.py: iterative Cooley-Tukey over a
bit-reversed copy, with twiddle tables in Montgomery form and coset shift
g = 5. A transform of 2^log_n rows is ceil(log_n / 10) passes of up to ten
stages each (fields/cuda_mont.ntt_pass, one launch a pass on CUDA): the
first pass gathers its rows in bit-reversed order as it loads them and
takes the prologue (a pre table, or the quotient's pointwise step), the
last multiplies each output row by the post table, so the n^-1 scaling of
the inverse and the coset shifts cost no launch of their own. `transform`
takes a batch (B, n, 16) of transforms of one size in each launch.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..fields.mont import FR
from ..fields import limbs as L
from ..fields.cuda_mont import ntt_pass

TWO_ADICITY = 28
GENERATOR = 5
ROOT_OF_UNITY = pow(GENERATOR, (FR.p - 1) >> TWO_ADICITY, FR.p)
COSET_SHIFT = GENERATOR
PASS_STAGES = 10   # stages a pass: a tile of 2^10 rows in shared memory


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
def _twiddles_host(log_n: int, inverse: bool) -> np.ndarray:
    """Every stage's table in one (2^log_n, 16) array, stage s at rows
    2^s .. 2^(s+1) - 1 (row 0 unused, zero): ntt_pass's layout."""
    return np.concatenate([np.zeros((1, L.N_LIMBS), np.uint32),
                           *_stage_twiddles_host(log_n, inverse)])


@lru_cache(maxsize=None)
def _powers_host(log_n: int, base: int, scale: int, mont: bool) -> np.ndarray:
    """scale * base^i mod r for i < 2^log_n, in Montgomery form if `mont`,
    else plain."""
    pw = [scale % FR.p] * (1 << log_n)
    for i in range(1, 1 << log_n):
        pw[i] = pw[i - 1] * base % FR.p
    return FR.to_mont_host(pw) if mont else L.ints_to_limbs(pw)


def _coset_powers_host(log_n: int, inverse: bool) -> np.ndarray:
    g = pow(COSET_SHIFT, FR.p - 2, FR.p) if inverse else COSET_SHIFT
    return _powers_host(log_n, g, 1, True)


def _n_inv(log_n: int) -> int:
    return pow(1 << log_n, FR.p - 2, FR.p)


_G_INV = pow(COSET_SHIFT, FR.p - 2, FR.p)
# table kind -> host builder of log_n
_KINDS = {
    "twiddles": lambda log_n: _twiddles_host(log_n, False),
    "twiddles_inv": lambda log_n: _twiddles_host(log_n, True),
    # coefficient i of a coset transform: g^i (forward), n^-1 g^-i (inverse)
    "coset": lambda log_n: _coset_powers_host(log_n, False),
    "ninv": lambda log_n: FR.to_mont_host([_n_inv(log_n)]),
    "ninv_coset_inv": lambda log_n: _powers_host(log_n, _G_INV,
                                                 _n_inv(log_n), True),
    # the quotient's tables: the iNTT's n^-1 and the forward coset shift
    # g^i in one product; the coset iNTT's n^-1 g^-i in plain form, so that
    # its product also leaves the Montgomery domain
    "ninv_coset": lambda log_n: _powers_host(log_n, COSET_SHIFT,
                                             _n_inv(log_n), True),
    "ninv_coset_inv_plain": lambda log_n: _powers_host(log_n, _G_INV,
                                                       _n_inv(log_n), False),
}


class _DeviceTables:
    """The tables of _KINDS per (kind, log_n, device)."""

    def __init__(self):
        self._cache = {}

    def get(self, kind: str, log_n: int, device):
        key = (kind, log_n, str(torch.device(device)))
        t = self._cache.get(key)
        if t is None:
            t = L.to_device(_KINDS[kind](log_n), device)
            self._cache[key] = t
        return t


_TABLES = _DeviceTables()


def _log2(n: int) -> int:
    log_n = int(n).bit_length() - 1
    if n <= 0 or 1 << log_n != n:
        raise ValueError("domain must be a power of two")
    return log_n


def passes(log_n: int) -> list:
    """(first stage, stages) of each pass of a 2^log_n transform."""
    return [(s0, min(PASS_STAGES, log_n - s0))
            for s0 in range(0, max(log_n, 1), PASS_STAGES)]


def transform(x: torch.Tensor, inverse: bool = False, *, pre=None,
              post=None, pointwise=None) -> torch.Tensor:
    """The in-order -> in-order radix-2 transform (forward, or inverse
    WITHOUT the 1/n scaling) of x, (n, 16) or a batch (B, n, 16) of
    canonical Fr limbs, as passes of ntt_pass: `pointwise` (b, c, z) and
    `pre` (n, 16) apply to the input rows, `post` (n, 16) or one element
    to the output rows (see ntt_pass). Returns a new tensor."""
    n = x.shape[-2]
    log_n = _log2(n)
    tw = _TABLES.get("twiddles_inv" if inverse else "twiddles", log_n,
                     x.device)
    plan = passes(log_n)
    y = None
    for p, (s0, k) in enumerate(plan):
        last = p == len(plan) - 1
        if p == 0:
            y = ntt_pass(FR, x, tw, s0, k, bitrev=True, pre=pre,
                         pointwise=pointwise, post=post if last else None)
        else:
            ntt_pass(FR, y, tw, s0, k, out=y, post=post if last else None)
    return y


def _limbs(a: torch.Tensor) -> torch.Tensor:
    return a.to(L.DTYPE).contiguous()


def ntt_mont(a: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """In-order -> in-order transform of (n, 16) Montgomery-form values.
    Forward: evaluations at w^0..w^{n-1}. Inverse: interpolation, with the
    1/n scaling."""
    post = None
    if inverse:
        post = _TABLES.get("ninv", _log2(a.shape[0]), a.device)
    return transform(_limbs(a), inverse, post=post)


def intt_mont(a: torch.Tensor) -> torch.Tensor:
    return ntt_mont(a, inverse=True)


def coset_ntt_mont(coeffs: torch.Tensor) -> torch.Tensor:
    """Evaluate the polynomial on the coset g*H."""
    log_n = _log2(coeffs.shape[0])
    return transform(_limbs(coeffs),
                     pre=_TABLES.get("coset", log_n, coeffs.device))


def coset_intt_mont(evals: torch.Tensor) -> torch.Tensor:
    """Interpolate from evaluations on g*H back to coefficients."""
    log_n = _log2(evals.shape[0])
    return transform(_limbs(evals), True, post=_TABLES.get(
        "ninv_coset_inv", log_n, evals.device))
