"""FieldCtx.add and sub of zkrollup_torch against zkrollup (JAX), and a
word-level model of csrc/fields.cu's add_kernel / sub_kernel.

The plain versions (cuda_mont.add_plain, sub_plain: the carry loop the CPU
runs) are held against the reference's FR and FQ add and sub
(zkrollup/fields/mont.py:71,76, lax.scan carry chains) limb for limb, on
operands made with numpy from a seed with 0, 1, p - 1, sums of exactly p
and differences that borrow among them.

The model follows field.cuh's Fp::add and Fp::sub on 8 x 32-bit words with
explicit carries (the PTX chains: sum, trial subtraction of p, keep the
difference on a carry or no borrow; difference, p added under the borrow's
mask) and Fp::mul's CIOS (the MiMC sponge's product, test_torch_mimc.py),
and is held against the same reference limbs. The wrappers' launches are
modelled too: with the launch replaced by the model reading the operands
at their addresses (a row a lane, or one broadcast row), the broadcast,
strided and int64 operands the wrappers accept give the plain versions'
results. The kernels themselves are held against their plain versions on
the card (test_torch_cuda.py, chip_smoke.py phase 2).
"""

import ctypes

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from zkrollup.fields.mont import FR as JFR, FQ as JFQ
from zkrollup_torch import kernels
from zkrollup_torch.fields import cuda_mont, limbs as L
from zkrollup_torch.fields.mont import FR, FQ

# One intra-op thread per process: the suite runs in several worker
# processes, whose torch thread pools would otherwise fight for the cores.
torch.set_num_threads(1)

M32 = (1 << 32) - 1
NW = 8
R = 1 << 256
FIELDS = {"fr": (FR, JFR), "fq": (FQ, JFQ)}


# -- the word-level model of field.cuh ----------------------------------------

def words(x: int) -> list:
    return [(x >> (32 * i)) & M32 for i in range(NW)]


def value(ws) -> int:
    return sum(w << (32 * i) for i, w in enumerate(ws))


def load(row) -> list:
    """Fp::load: 16 int32 limbs -> 8 words, low limb masked to 16 bits,
    the high limb shifted into the word's top half."""
    return [(int(row[2 * i]) & 0xFFFF) | ((int(row[2 * i + 1]) << 16) & M32)
            for i in range(NW)]


def store(ws) -> list:
    """Fp::store: 8 words -> 16 limbs."""
    return [v for w in ws for v in (w & 0xFFFF, w >> 16)]


def add_words(a: list, b: list, p: list) -> list:
    """Fp::add: s = a + b over the add.cc chain (carry out of word 7),
    d = s - p over the sub.cc chain (borrow out); d on a carry or no
    borrow, else s."""
    s, c = [], 0
    for x, y in zip(a, b):
        v = x + y + c
        s.append(v & M32)
        c = v >> 32
    d, br = [], 0
    for x, q in zip(s, p):
        v = x - q - br
        d.append(v & M32)
        br = int(v < 0)
    return d if c or not br else s


def sub_words(a: list, b: list, p: list) -> list:
    """Fp::sub: d = a - b over the sub.cc chain, bw = 0 - borrow (all ones
    on a borrow), then d + (p & bw) over the add.cc chain, its carry out
    dropped."""
    d, br = [], 0
    for x, y in zip(a, b):
        v = x - y - br
        d.append(v & M32)
        br = int(v < 0)
    bw = M32 if br else 0
    r, c = [], 0
    for x, q in zip(d, p):
        v = x + (q & bw) + c
        r.append(v & M32)
        c = v >> 32
    return r


def _mac(t: list, a: list, b: int) -> None:
    """t[0..9] += a b as the PTX of Fp::mul: the low halves into t[0..7]
    (mad.lo.cc chain, carry into t8, then t9), then the high halves into
    t[1..8] (a new chain, its carry into t9)."""
    c = 0
    for j in range(NW):
        v = t[j] + ((a[j] * b) & M32) + c
        t[j], c = v & M32, v >> 32
    v = t[8] + c
    t[8], c = v & M32, v >> 32
    t[9] = (t[9] + c) & M32
    c = 0
    for j in range(NW):
        v = t[j + 1] + ((a[j] * b) >> 32) + c
        t[j + 1], c = v & M32, v >> 32
    t[9] = (t[9] + c) & M32


def mul_words(a: list, b: list, p: list, inv: int) -> list:
    """Fp::mul: CIOS over a 10-word window, t += a b_i, m = t0 inv,
    t += m p (t0 becomes 0), shift down a word; then one conditional
    subtraction of p over 9 words."""
    t = [0] * (NW + 2)
    for i in range(NW):
        _mac(t, a, b[i])
        m = (t[0] * inv) & M32
        _mac(t, p, m)
        assert t[0] == 0
        t = t[1:] + [0]
    d, br = [], 0
    for x, q in zip(t[:NW], p):
        v = x - q - br
        d.append(v & M32)
        br = int(v < 0)
    hi = (t[NW] - br) & M32
    return t[:NW] if hi == M32 else d


def field_words(F):
    """(p as words, -p^-1 mod 2^32): FrParams / FqParams."""
    return words(F.p), (-pow(F.p, -1, 1 << 32)) % (1 << 32)


def kernel_rows(op: str, F, a_rows, b_rows) -> np.ndarray:
    """The add or sub kernel's output rows on (n, 16) limb rows."""
    p, _ = field_words(F)
    fn = add_words if op == "add" else sub_words
    return np.array([store(fn(load(x), load(y), p))
                     for x, y in zip(a_rows, b_rows)], dtype=np.int64)


# -- operands -----------------------------------------------------------------

def _operands(F, n: int, seed: int):
    """(a, b) lists of n canonical values: random ones, with 0, 1, p - 1,
    pairs summing to exactly p, pairs whose difference borrows (a < b),
    equal pairs and the largest sum 2p - 2 first."""
    p = F.p
    rng = np.random.RandomState(seed)
    w = rng.randint(0, 1 << 32, size=(2 * n, NW), dtype=np.uint64)
    rand = [sum(int(x) << (32 * i) for i, x in enumerate(row)) % p
            for row in w]
    x = rand[3]
    edges = [(0, 0), (0, 1), (1, 0), (p - 1, 1), (1, p - 1), (p - 1, p - 1),
             (x, p - x), (p - x, x), (1, 2), (0, p - 1), (x, x), (x, x + 1),
             (x - 1, x), (p // 2, p // 2 + 1), (p // 2 + 1, p // 2)]
    a = [e[0] for e in edges] + rand[:n - len(edges)]
    b = [e[1] for e in edges] + rand[n:2 * n - len(edges)]
    return a, b


def _want(op: str, p: int, a: list, b: list) -> list:
    return [(x + y) % p if op == "add" else (x - y) % p
            for x, y in zip(a, b)]


CASES = [(f, op) for f in FIELDS for op in ("add", "sub")]


@pytest.mark.parametrize("field,op", CASES)
def test_plain_add_sub_match_reference(field, op):
    """add_plain / sub_plain and FieldCtx.add / sub on CPU tensors, 256
    lanes, equal to the reference's limb for limb and to Python ints."""
    F, JF = FIELDS[field]
    a, b = _operands(F, 256, 1 + len(op) + F.p % 7)
    ea, eb = L.ints_to_limbs(a), L.ints_to_limbs(b)
    ta, tb = L.to_device(ea, "cpu"), L.to_device(eb, "cpu")
    plain = getattr(cuda_mont, f"{op}_plain")(F, ta, tb)
    assert plain.dtype == L.DTYPE
    assert torch.equal(getattr(F, op)(ta, tb), plain)
    want = np.asarray(getattr(JF, op)(jnp.asarray(ea), jnp.asarray(eb)))
    np.testing.assert_array_equal(plain.numpy().astype(np.uint32), want)
    assert L.limbs_to_ints(plain) == _want(op, F.p, a, b)


@pytest.mark.parametrize("field,op", CASES)
def test_kernel_model_matches_reference(field, op):
    """The word-level model of add_kernel / sub_kernel on the same kind of
    operands, equal to the reference's limbs."""
    F, JF = FIELDS[field]
    a, b = _operands(F, 128, 11 + len(op) + F.p % 5)
    ea, eb = L.ints_to_limbs(a), L.ints_to_limbs(b)
    got = kernel_rows(op, F, ea, eb)
    want = np.asarray(getattr(JF, op)(jnp.asarray(ea), jnp.asarray(eb)))
    np.testing.assert_array_equal(got.astype(np.uint32), want)
    assert L.limbs_to_ints(got) == _want(op, F.p, a, b)


@pytest.mark.parametrize("field", FIELDS)
def test_mul_model_is_montgomery(field):
    """The model of Fp::mul (the sponge's product) gives a b R^-1 mod p on
    canonical operands and edge values, as mont_mul_plain does."""
    F, _ = FIELDS[field]
    p, inv = field_words(F)
    a, b = _operands(F, 48, 21)
    rinv = pow(R, -1, F.p)
    got = [value(mul_words(words(x), words(y), p, inv)) for x, y in zip(a, b)]
    assert got == [x * y * rinv % F.p for x, y in zip(a, b)]
    plain = cuda_mont.mont_mul_plain(F, L.to_device(L.ints_to_limbs(a), "cpu"),
                                     L.to_device(L.ints_to_limbs(b), "cpu"))
    assert L.limbs_to_ints(plain) == got


def test_kernel_contract_is_canonical_input():
    """The contract the kernels state: canonical operands (16-bit limbs,
    values below p) only. Outside it the model answers otherwise than the
    plain version, which takes any int64 limbs: a limb above 16 bits (a
    lazy sum) is cut by the kernel's load, and 2^256 - 1 + 0 stays above
    p."""
    p = FQ.p
    lazy = np.zeros((1, 16), dtype=np.int64)
    lazy[0, 0] = 1 << 16                          # 2^16 held in limb 0
    one = L.ints_to_limbs([1])
    plain = cuda_mont.add_plain(FQ, torch.from_numpy(lazy),
                                L.to_device(one, "cpu"))
    assert L.limbs_to_ints(plain) == [(1 << 16) + 1]
    assert L.limbs_to_ints(kernel_rows("add", FQ, lazy, one)) == [1]
    top = L.ints_to_limbs([R - 1])
    got = L.limbs_to_ints(kernel_rows("add", FQ, top, L.ints_to_limbs([0])))
    assert got == [R - 1 - p] and got[0] >= p


# -- the wrappers' launches, modelled -----------------------------------------

def rows_at(ptr: int, n_rows: int) -> np.ndarray:
    """n_rows limb rows of a CPU tensor at address ptr."""
    buf = (ctypes.c_int32 * (16 * n_rows)).from_address(ptr)
    return np.ctypeslib.as_array(buf).reshape(n_rows, 16)


def check_cuda_but_device(t, what, last_dim=16):
    """kernels.check_cuda's checks but the device's, for modelled launches
    over CPU tensors."""
    assert t.dtype == torch.int32 and t.is_contiguous()
    assert t.shape[-1] == last_dim and t.data_ptr() % 16 == 0


@pytest.fixture
def modelled_launch(monkeypatch):
    """kernels.launch replaced by the model of the add and sub kernels over
    CPU memory (lane i reads a at row i, or row 0 when a is broadcast, and
    b so), and check_cuda by a check of what it checks but the device."""
    seen = []

    def launch(name, device, a, b, a_bcast, b_bcast, out, n, lanes):
        op, field = name[:3], name[4:6]
        F = FIELDS[field][0]
        rows = lambda ptr, bc: np.repeat(rows_at(ptr, 1), n, 0) if bc \
            else rows_at(ptr, n)
        rows_at(out, n)[:] = kernel_rows(op, F, rows(a, a_bcast),
                                          rows(b, b_bcast))
        seen.append((name, a_bcast, b_bcast, n, lanes))

    monkeypatch.setattr(kernels, "launch", launch)
    monkeypatch.setattr(kernels, "check_cuda", check_cuda_but_device)
    return seen


SHAPES = {
    "same": ((40, 16), (40, 16)),
    "b_row": ((40, 16), (16,)),
    "a_row": ((16,), (3, 40, 16)),
    "b_one_row": ((40, 16), (1, 16)),
    "outer": ((5, 1, 16), (1, 8, 16)),
    "one_lane": ((16,), (16,)),
}


@pytest.mark.parametrize("case", sorted(SHAPES))
@pytest.mark.parametrize("field,op", CASES)
def test_wrapper_launch_model_matches_plain(modelled_launch, field, op, case):
    """cuda_mont's launch of add / sub over broadcast operands (one row
    read for every lane, or expanded), a strided view (a[0::2]) and int64
    limbs: the modelled kernel equals the plain version, shape included,
    one launch of the result's lanes."""
    F, _ = FIELDS[field]
    sa, sb = SHAPES[case]
    a, b = _operands(F, 2 * 120, 31)
    ta = L.to_device(L.ints_to_limbs(a), "cpu")
    tb = L.to_device(L.ints_to_limbs(b), "cpu")
    na, nb = int(np.prod(sa[:-1])), int(np.prod(sb[:-1]))
    x = ta[0:2 * na:2].reshape(sa)                   # strided
    y = tb[:nb].to(torch.int64).reshape(sb)          # int64 limbs
    got = cuda_mont._add_sub(op, F, x, y)
    want = getattr(cuda_mont, f"{op}_plain")(F, x, y)
    assert got.shape == want.shape and torch.equal(got, want)
    n = got.numel() // 16
    assert modelled_launch == [(f"{op}[{field}]", int(na == 1),
                                int(nb == 1), n, n)]
