"""zkrollup_torch's Groth16 quotient on the NTT passes, the lazy-sum fold and
the gathered Montgomery product, on the CPU (their plain versions).

The quotient (groth16/prove.py:_quotient_plain: one batched iNTT with the
coset shift folded into its post table, one batched NTT, one coset iNTT
with the pointwise step in its prologue) against the JAX reference's
_quotient_plain, against the route it replaces (intt / coset_ntt /
pointwise / coset_intt / from_mont through the public NTT functions) and
against the native engine's NTT with the coset arithmetic in Python ints;
the plain fold against Python-int V mod r; the gathered mont_mul against
mont_mul(a, b[idx]) and Python ints. Every comparison is bit for bit
(tolerance 0).
"""

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from zkrollup.fields.mont import FR as JFR
from zkrollup.native import engine
from zkrollup_torch.fields import cuda_mont, limbs as L
from zkrollup_torch.fields.mont import FR, FQ
from zkrollup_torch.groth16 import prove as P
from zkrollup_torch.ntt import ntt

jprove_mod = importlib.import_module("zkrollup.groth16.prove")

# One intra-op thread per process: the suite runs in several worker
# processes, whose torch thread pools would otherwise fight for the cores.
torch.set_num_threads(1)


def _values(p: int, n: int, seed: int) -> list:
    rng = np.random.RandomState(seed)
    words = rng.randint(0, 1 << 32, size=(n, 8), dtype=np.uint64)
    return [sum(int(w) << (32 * i) for i, w in enumerate(row)) % p
            for row in words]


def _evals(log_n: int, seed: int):
    """Three (2^log_n, 16) Montgomery-form evaluation vectors with 0, 1
    and r - 1 in their first rows, and Z^-1 of the coset."""
    out = []
    for k in range(3):
        vals = _values(FR.p, 1 << log_n, seed + k)
        vals[:3] = [0, 1, FR.p - 1]
        out.append(torch.from_numpy(FR.to_mont_host(vals).astype(np.int32)))
    m = 1 << log_n
    z = (pow(P.COSET_SHIFT, m, FR.p) - 1) % FR.p
    return out, pow(z, FR.p - 2, FR.p)


def _old_route(a_e, b_e, c_e, zinv_mont):
    """The quotient as it was written before the passes: three iNTTs,
    three coset NTTs, the pointwise step, one coset iNTT, from_mont."""
    pa, pb, pc = (ntt.intt_mont(e) for e in (a_e, b_e, c_e))
    ca, cb, cc = (ntt.coset_ntt_mont(q) for q in (pa, pb, pc))
    h_cos = FR.mont_mul(FR.sub(FR.mont_mul(ca, cb), cc), zinv_mont)
    return FR.from_mont(ntt.coset_intt_mont(h_cos))


@pytest.mark.parametrize("log_n", [10, 11])
def test_quotient_equals_the_stage_route(log_n):
    evals, zinv = _evals(log_n, 3)
    zinv_mont = FR.const_mont(zinv, "cpu")
    assert torch.equal(P._quotient_plain(*evals, zinv_mont),
                       _old_route(*evals, zinv_mont))


def test_quotient_matches_jax_on_random_evaluations():
    evals, zinv = _evals(10, 7)
    got = P._quotient_plain(*evals, FR.const_mont(zinv, "cpu"))
    want = jprove_mod._quotient_plain(
        *(jnp.asarray(e.numpy().astype(np.uint32)) for e in evals),
        JFR.const_mont(zinv))
    assert np.array_equal(got.numpy().astype(np.uint32), np.asarray(want))


def _engine_ntt(vals, inverse):
    raw = engine.fr_ntt_bytes(engine.ints_to_fr_bytes(vals), len(vals),
                              inverse)
    return [int.from_bytes(raw[32 * i:32 * (i + 1)], "little")
            for i in range(len(vals))]


def test_quotient_matches_native_engine_ntt():
    """h = coset_intt((A B - C) Z^-1) with the engine's NTT and the coset
    shifts and the pointwise step in Python ints, at 2^12."""
    log_n = 12
    evals, zinv = _evals(log_n, 11)
    p, g = FR.p, P.COSET_SHIFT
    ginv = pow(g, p - 2, p)
    cos = []
    for e in evals:
        coeffs = _engine_ntt(FR.from_mont_host(e), True)
        cos.append(_engine_ntt([c * pow(g, i, p) % p
                                for i, c in enumerate(coeffs)], False))
    h_cos = [(a * b - c) * zinv % p for a, b, c in zip(*cos)]
    want = [c * pow(ginv, i, p) % p
            for i, c in enumerate(_engine_ntt(h_cos, True))]
    got = P._quotient_plain(*evals, FR.const_mont(zinv, "cpu"))
    assert L.limbs_to_ints(got) == want


def _lazy_sums(n: int, seed: int) -> torch.Tensor:
    """(n, 16) int64 limb sums as index_add_ leaves them: random sums of
    up to 3,000 canonical limbs, then the edge rows V = 0, V = 2^288 - 1,
    V = 7 r and V = 2^256 + r - 1 (lo >= r)."""
    rng = np.random.RandomState(seed)
    s = rng.randint(0, 3000 * 65535, size=(n, 16)).astype(np.int64)
    s[0] = 0
    s[1, :15], s[1, 15] = 0xFFFF, (1 << 48) - 1
    for row, v in ((2, 7 * FR.p), (3, (1 << 256) + FR.p - 1)):
        s[row] = [(v >> (16 * i)) & 0xFFFF for i in range(15)] + [v >> 240]
    return torch.from_numpy(s)


def _lazy_value(row) -> int:
    return sum(int(v) << (16 * i) for i, v in enumerate(row))


def test_plain_fold_equals_python_ints():
    sums = _lazy_sums(64, 5)
    got = cuda_mont.fold(FR, sums)
    want = [_lazy_value(r) % FR.p for r in sums.tolist()]
    assert L.limbs_to_ints(got) == want
    assert want[:3] == [0, ((1 << 288) - 1) % FR.p, 0]
    assert got.dtype == L.DTYPE


def test_fold_in_spmv_equals_python_ints():
    """_spmv's gathered products, index_add_ and fold: eval[j] = sum of
    coeff_k w[var_k] over the terms of row j, mod r."""
    rng = np.random.RandomState(9)
    m, nnz, nv = 32, 400, 50
    row = torch.from_numpy(rng.randint(0, m, size=nnz))
    var = torch.from_numpy(rng.randint(0, nv, size=nnz))
    coeff, w = _values(FR.p, nnz, 10), _values(FR.p, nv, 12)
    got = P._spmv(row, var, torch.from_numpy(
        FR.to_mont_host(coeff).astype(np.int32)), torch.from_numpy(
        FR.to_mont_host(w).astype(np.int32)), m)
    want = [0] * m
    for j, k, c in zip(row.tolist(), var.tolist(), coeff):
        want[j] = (want[j] + c * w[k]) % FR.p
    assert FR.from_mont_host(got) == want


@pytest.mark.parametrize("F", [FR, FQ], ids=["fr", "fq"])
def test_gathered_mont_mul_equals_mont_mul_of_the_gather(F):
    a = torch.from_numpy(L.ints_to_limbs(_values(F.p, 300, 1)).astype(
        np.int32))
    b_vals = _values(F.p, 40, 2)
    b = torch.from_numpy(L.ints_to_limbs(b_vals).astype(np.int32))
    idx = torch.from_numpy(np.random.RandomState(3).randint(0, 40, 300))
    got = F.mont_mul(a, b, idx)
    assert torch.equal(got, F.mont_mul(a, b.index_select(0, idx)))
    rinv = pow(1 << 256, F.p - 2, F.p)
    assert L.limbs_to_ints(got) == [
        x * b_vals[k] * rinv % F.p
        for x, k in zip(L.limbs_to_ints(a), idx.tolist())]


@pytest.mark.parametrize("F", [FR, FQ], ids=["fr", "fq"])
def test_neg_is_a_product_by_minus_one(F):
    vals = _values(F.p, 50, 4) + [0, 1, F.p - 1]
    a = torch.from_numpy(L.ints_to_limbs(vals).astype(np.int32))
    assert L.limbs_to_ints(F.neg(a)) == [(-v) % F.p for v in vals]
    assert L.limbs_to_ints(F.neg(a[:, None][10:20])) == \
        [(-v) % F.p for v in vals[10:20]]
