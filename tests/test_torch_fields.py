"""zkrollup_torch fields against zkrollup.fields (JAX): Montgomery multiply,
add, sub, neg, to/from Montgomery and the Fermat inverse over Fr and Fq, and
Fq2 mul/sqr/inv.

Inputs are made with numpy from a seed and handed to both packages; results
must be equal limb for limb. The CUDA kernels are compared with their plain
versions on the card in test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from zkrollup.fields import fq2 as jfq2
from zkrollup.fields.mont import FR as JFR, FQ as JFQ
from zkrollup_torch import kernels
from zkrollup_torch.fields import cuda_mont, fq2, limbs as L
from zkrollup_torch.fields.mont import FR, FQ

# One intra-op thread per process: the suite runs in several worker
# processes, whose torch thread pools would otherwise fight for the cores.
torch.set_num_threads(1)

FIELDS = {"fr": (FR, JFR), "fq": (FQ, JFQ)}


def _values(p: int, seed: int) -> list:
    """128 random elements plus 0, 1, p - 1 and R mod p."""
    rng = np.random.RandomState(seed)
    words = rng.randint(0, 1 << 32, size=(128, 8), dtype=np.uint64)
    vals = [sum(int(w) << (32 * i) for i, w in enumerate(row)) % p
            for row in words]
    return vals + [0, 1, p - 1, (1 << 256) % p]


def _pair(F, seed):
    a = F.to_mont_host(_values(F.p, seed))
    b = F.to_mont_host(_values(F.p, seed + 1)[::-1])
    return a, b


def _t(a):
    return torch.from_numpy(a.astype(np.int32))


def _eq(got, want):
    return np.array_equal(got.numpy().astype(np.uint32), np.asarray(want))


@pytest.mark.parametrize("name", sorted(FIELDS))
@pytest.mark.parametrize("op", ["mont_mul", "add", "sub"])
def test_binary_op_matches_jax(name, op):
    F, JF = FIELDS[name]
    a, b = _pair(F, 11)
    got = getattr(F, op)(_t(a), _t(b))
    want = getattr(JF, op)(jnp.asarray(a), jnp.asarray(b))
    assert _eq(got, want)


@pytest.mark.parametrize("name", sorted(FIELDS))
def test_neg_and_montgomery_conversions_match_jax(name):
    F, JF = FIELDS[name]
    a, _ = _pair(F, 21)
    plain = L.ints_to_limbs(_values(F.p, 21))
    assert _eq(F.neg(_t(a)), JF.neg(jnp.asarray(a)))
    assert _eq(F.to_mont(_t(plain)), JF.to_mont(jnp.asarray(plain)))
    assert _eq(F.from_mont(_t(a)), JF.from_mont(jnp.asarray(a)))
    assert F.from_mont_host(a) == _values(F.p, 21)


@pytest.mark.parametrize("name", sorted(FIELDS))
def test_mont_mul_broadcast_and_lazy_operand(name):
    """b broadcast from one element; a may be any value < 2^256 (the spmv
    fold passes such lazy operands)."""
    F, JF = FIELDS[name]
    a, b = _pair(F, 31)
    a[0] = 0xFFFF
    got = F.mont_mul(_t(a), _t(b[3]))
    want = JF.mont_mul(jnp.asarray(a), jnp.asarray(b[3]))
    assert _eq(got, want)
    vals = L.limbs_to_ints(a)
    rinv = pow(1 << 256, -1, F.p)
    b3 = F.from_mont_host(b[3:4])[0]
    assert F.from_mont_host(got) == [v * rinv % F.p * b3 % F.p for v in vals]


@pytest.mark.parametrize("op", ["mul", "sqr", "inv"])
def test_fq2_matches_jax(op):
    a = (_pair(FQ, 41)[0], _pair(FQ, 43)[0])
    b = (_pair(FQ, 45)[0], _pair(FQ, 47)[0])
    if op == "mul":
        got = fq2.mul((_t(a[0]), _t(a[1])), (_t(b[0]), _t(b[1])))
        want = jfq2.mul((jnp.asarray(a[0]), jnp.asarray(a[1])),
                        (jnp.asarray(b[0]), jnp.asarray(b[1])))
    elif op == "sqr":
        got = fq2.sqr((_t(a[0]), _t(a[1])))
        want = jfq2.sqr((jnp.asarray(a[0]), jnp.asarray(a[1])))
    else:
        a = (a[0][:16], a[1][:16])
        got = fq2.inv((_t(a[0]), _t(a[1])))
        want = jfq2.inv((jnp.asarray(a[0]), jnp.asarray(a[1])))
        prod = fq2.mul(got, (_t(a[0]), _t(a[1])))
        assert FQ.from_mont_host(prod[0]) == [1] * 16
    assert _eq(got[0], want[0]) and _eq(got[1], want[1])


@pytest.mark.parametrize("name", sorted(FIELDS))
def test_mont_inv_matches_jax(name):
    """Fermat inverse a^(p-2) over 0, 1, p - 1, R mod p and random
    elements; 0 maps to 0."""
    F, JF = FIELDS[name]
    a = F.to_mont_host(_values(F.p, 71))[-20:]
    got = F.mont_inv(_t(a))
    assert _eq(got, JF.mont_inv(jnp.asarray(a)))
    vals = F.from_mont_host(a)
    assert F.from_mont_host(got) == [pow(v, F.p - 2, F.p) for v in vals]
    assert _eq(F.mont_pow_const(_t(a), 5),
               JF.mont_pow_const(jnp.asarray(a), 5))


def test_limb_codec_roundtrip():
    vals = _values(FQ.p, 51) + [(1 << 256) - 1]
    arr = L.ints_to_limbs(vals)
    assert L.limbs_to_ints(arr) == vals
    assert L.limbs_to_ints(_t(arr)) == vals
    lazy = np.zeros((1, 16), np.int64)
    lazy[0, 0] = 1 << 20                       # non-canonical limb
    assert L.limbs_to_ints(lazy) == [1 << 20]


def test_cpu_tensors_take_the_plain_version():
    a, b = _pair(FR, 61)
    before = dict(kernels.LAUNCHES)
    got = FR.mont_mul(_t(a), _t(b))
    x = _t(a[:128])
    cuda_mont.ntt_stage_(FR, x, _t(b[:64]), 64)
    assert kernels.LAUNCHES == before
    assert torch.equal(got, cuda_mont.mont_mul_plain(FR, _t(a), _t(b)))
    v = cuda_mont.mont_mul_plain(FR, _t(a[64:128]), _t(b[:64]))
    assert torch.equal(x[:64], FR.add(_t(a[:64]), v))
    assert torch.equal(x[64:], FR.sub(_t(a[:64]), v))
