"""The Fq and Fq2 inversion of zkrollup_torch against zkrollup (JAX).

A word-level model of csrc/fields.cu's inv_kernel (the lane-to-thread map,
INV_PER_THREAD lanes a thread strided by the thread count, the prefix
products kept in the output rows, zero lanes entering the product as one
and stored as zero, the ragged last threads, one lane, the exponent chain
of q - 2 over the words of q) is fed the reference's limbs and held
against the reference's FQ.mont_inv (zkrollup/fields/mont.py:176) and
fq2.inv (zkrollup/fields/fq2.py:51), exact limbs. The port's plain
batch_inverse (the product tree the CPU runs) is held against the
reference's weierstrass.batch_inverse; CPU tensors take the plain route
and launch nothing; the prover's window sums leave the card through one
from_mont. The kernel itself is held against its plain version on the card
in test_torch_cuda.py.
"""


import numpy as np
import pytest
import torch

import jax.numpy as jnp

from zkrollup.curve import weierstrass as jw
from zkrollup.fields import fq2 as jfq2
from zkrollup.fields.mont import FQ as JFQ
from zkrollup_torch import kernels
from zkrollup_torch.curve import g1, g2, weierstrass
from zkrollup_torch.fields import cuda_mont, fq2, limbs as L
from zkrollup_torch.fields.mont import FQ
from zkrollup_torch.groth16 import prove as P

# One intra-op thread per process: the suite runs in several worker
# processes, whose torch thread pools would otherwise fight for the cores.
torch.set_num_threads(1)

Q = FQ.p
R = 1 << 256
RINV = pow(R, -1, Q)
ONE = R % Q
N = 1025
# (offset, lanes): one lane (a zero one and a finite one), ragged launches
# of 22 and 33 lanes, and the whole 1,025
SLICES = ((0, 1), (5, 1), (0, 22), (7, 33), (0, N))


PER_THREAD = sorted({8, 16, 32, kernels.inv_per_thread()})


class Model:
    """inv_kernel over Python ints: mont(x, y) = x y R^-1 mod q, every
    product counted."""

    def __init__(self):
        self.products = 0

    def mont(self, x, y):
        assert 0 <= x < Q and 0 <= y < Q
        self.products += 1
        return x * y * RINV % Q

    def pow_q_minus_2(self, a):
        """fields.cu:pow_q_minus_2: from bit 253 (acc = a), words 7 .. 0 of
        q - 2, bits 28 (word 7) or 31 .. 0."""
        e = [((Q - 2) >> (32 * w)) & 0xFFFFFFFF for w in range(8)]
        assert e[7] >> 29 == 1
        acc = a
        for w in range(7, -1, -1):
            for b in range(28 if w == 7 else 31, -1, -1):
                acc = self.mont(acc, acc)
                if (e[w] >> b) & 1:
                    acc = self.mont(acc, a)
        return acc

    def run(self, lanes, per_thread, key, finish):
        """The kernel over n lanes: thread t of T = ceil(n / per_thread)
        takes lanes t + j T < n. key(i) is lane i's key (stashed by the
        caller as the kernel does), finish(i, inverse of the key)."""
        n = len(lanes)
        T = -(-n // per_thread)
        out0 = [None] * n
        seen, done = [], []
        for t in range(T):
            cnt = (n - 1 - t) // T + 1
            assert 1 <= cnt <= per_thread
            acc = None
            for j in range(cnt):
                i = t + j * T
                seen.append(i)
                k = key(i)
                x = ONE if k == 0 else k
                acc = x if j == 0 else self.mont(acc, x)
                out0[i] = acc                      # the prefix row
            inv = self.pow_q_minus_2(acc)
            for j in range(cnt - 1, 0, -1):
                i = t + j * T
                k = key(i, again=True)
                kinv = self.mont(inv, out0[i - T])
                inv = self.mont(inv, ONE if k == 0 else k)
                finish(i, 0 if k == 0 else kinv)
                done.append(i)
            finish(t, 0 if key(t, again=True) == 0 else inv)
            done.append(t)
        assert sorted(seen) == sorted(done) == list(range(n))
        return T


def _ints(a) -> list:
    return L.limbs_to_ints(np.asarray(a))


def _inputs(per_thread: int, seed: int) -> np.ndarray:
    """N canonical Montgomery-form limbs: random, with 0, 1, q - 1 and
    R mod q as limb values, and zeros at the first, middle and last lane of
    thread 0 and of the last thread of a launch of N lanes at per_thread
    lanes a thread, and every lane of thread 1."""
    rng = np.random.RandomState(seed)
    vals = [int.from_bytes(rng.bytes(32), "little") % Q for _ in range(N)]
    T = -(-N // per_thread)
    for t in (0, T - 1):
        own = list(range(t, N, T))
        for i in (own[0], own[len(own) // 2], own[-1]):
            vals[i] = 0
    for i in range(1, N, T):
        vals[i] = 0
    vals[2:6] = [1, Q - 1, ONE, 0]
    return L.ints_to_limbs(vals)


@pytest.mark.parametrize("per_thread", PER_THREAD)
def test_inv_model_matches_reference_fq(per_thread):
    """inv[fq]'s batching, per thread and per lane, against FQ.mont_inv of
    the reference on the same limbs, exact, on one lane, ragged launches and
    1,025 lanes; 3 products a lane and 362 a thread."""
    a = _inputs(per_thread, 11 + per_thread)
    want = _ints(JFQ.mont_inv(jnp.asarray(a)))
    vals = _ints(a)
    for off, n in SLICES:
        lanes = vals[off:off + n]
        m = Model()
        out = [None] * n
        key = lambda i, again=False: lanes[i]
        T = m.run(lanes, per_thread, key, out.__setitem__)
        assert out == want[off:off + n], (per_thread, off, n)
        assert m.products == 3 * (n - T) + 362 * T


@pytest.mark.parametrize("per_thread", PER_THREAD)
def test_inv_model_matches_reference_fq2(per_thread):
    """inv[fq2]'s batching: the norm a0^2 + a1^2 stashed in the second
    output row between the sweeps, its Fq inverse batched as inv[fq]'s,
    then (a0 n^-1, -(a1 n^-1)); against the reference's fq2.inv, exact;
    7 products a lane and 362 a thread."""
    a0 = _inputs(per_thread, 21 + per_thread)
    a1 = _inputs(per_thread, 31 + per_thread)
    a1[np.any(a0 != 0, axis=1) & (np.arange(N) % 5 == 0)] = 0  # a1 = 0
    w0, w1 = jfq2.inv((jnp.asarray(a0), jnp.asarray(a1)))
    want = list(zip(_ints(w0), _ints(w1)))
    v0, v1 = _ints(a0), _ints(a1)
    for off, n in SLICES:
        x0, x1 = v0[off:off + n], v1[off:off + n]
        m = Model()
        out0, out1 = [None] * n, [None] * n

        def key(i, again=False):
            if again:
                return out1[i]                    # the stashed norm
            out1[i] = (m.mont(x0[i], x0[i]) + m.mont(x1[i], x1[i])) % Q
            return out1[i]

        def finish(i, kinv):
            out0[i] = m.mont(x0[i], kinv)
            out1[i] = -m.mont(x1[i], kinv) % Q

        T = m.run(x0, per_thread, key, finish)
        assert list(zip(out0, out1)) == want[off:off + n], (per_thread, off,
                                                            n)
        assert m.products == 7 * n - 3 * T + 362 * T


def test_inv_chain_is_fermat():
    """The kernel's chain of q - 2: 253 squares and 109 products, equal to
    a^(q-2) in the Montgomery domain."""
    m = Model()
    a = 0x1234567890ABCDEF % Q
    got = m.pow_q_minus_2(a * R % Q)
    assert m.products == 253 + 109
    assert got == pow(a, Q - 2, Q) * R % Q


@pytest.mark.parametrize("kind", ["fq", "fq2"])
def test_plain_batch_inverse_matches_jax(kind):
    """The port's batch_inverse on CPU tensors (the product tree, its plain
    version) against the reference's weierstrass.batch_inverse, exact, on
    37 lanes (padded to 64 in the tree)."""
    m = 37
    a = _inputs(8, 41)[:2 * m]
    a[a.sum(axis=1) == 0] = L.int_to_limbs(ONE)      # nonzero lanes
    if kind == "fq":
        got = weierstrass.batch_inverse(weierstrass.FqOps,
                                        L.to_device(a[:m], "cpu"))
        want = jw.batch_inverse(jw.FqOps, jnp.asarray(a[:m]))
        pairs = [(got, want)]
    else:
        d = (L.to_device(a[:m], "cpu"), L.to_device(a[m:], "cpu"))
        got = weierstrass.batch_inverse(weierstrass.Fq2Ops, d)
        want = jw.batch_inverse(jw.Fq2Ops, (jnp.asarray(a[:m]),
                                            jnp.asarray(a[m:])))
        pairs = list(zip(got, want))
    for g, w in pairs:
        assert np.array_equal(g.numpy().astype(np.uint32), np.asarray(w))


def test_cpu_tensors_take_the_plain_route(monkeypatch):
    """On CPU tensors FQ.mont_inv, fq2.inv and batch_inverse launch no
    kernel and equal the plain versions (Fermat over the plain product, the
    product tree)."""
    def no_launch(name, *a, **k):
        raise AssertionError(f"{name} launched on CPU tensors")
    monkeypatch.setattr(kernels, "launch", no_launch)
    a = L.to_device(_inputs(8, 51)[:40], "cpu")
    b = L.to_device(_inputs(8, 52)[:40], "cpu")
    inv = FQ.mont_inv(a)
    assert torch.equal(inv, cuda_mont.inv_plain(FQ, a))
    assert _ints(inv) == [pow(v * RINV, Q - 2, Q) * R % Q for v in _ints(a)]
    got = fq2.inv((a, b))
    want = cuda_mont.inv_fq2_plain(FQ, (a, b))
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    ones = FQ.one_mont("cpu").expand(a.shape)
    d = L.select(L.is_zero(a), ones, a).contiguous()
    assert torch.equal(weierstrass.batch_inverse(weierstrass.FqOps, d),
                       weierstrass.batch_inverse_tree(weierstrass.FqOps, d))


@pytest.mark.parametrize("name", ["g1", "g2"])
def test_window_sums_leave_in_one_from_mont(monkeypatch, name):
    """groth16.prove._to_host_standard: one FQ.from_mont over every leaf's
    rows (one mont_mul[fq] launch a curve on the card), the same limbs as
    one from_mont a leaf."""
    curve = {"g1": g1.G1, "g2": g2.G2}[name]
    k = len(curve.leaves(curve.infinity((1,), "cpu")))
    rng = np.random.RandomState(61)
    leaves = [L.to_device(L.ints_to_limbs(
        [int.from_bytes(rng.bytes(32), "little") % Q for _ in range(22)]),
        "cpu") for _ in range(k)]
    wsum = curve.from_leaves(leaves)
    calls = []
    orig = FQ.from_mont
    monkeypatch.setattr(FQ, "from_mont",
                        lambda a: calls.append(a.shape) or orig(a))
    got = curve.leaves(P._to_host_standard(curve, wsum)())
    assert calls == [(k, 22, 16)]
    for g, a in zip(got, leaves):
        assert np.array_equal(g, orig(a).numpy())
