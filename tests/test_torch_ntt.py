"""zkrollup_torch NTT against zkrollup.ntt (JAX) and the native engine:
inverse, coset forward and coset inverse transforms at 2^10, limb for limb,
plus the forward transform against a naive DFT and the engine's NTT."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from zkrollup.native import engine
from zkrollup.ntt import ntt as jntt
from zkrollup_torch.fields import cuda_mont
from zkrollup_torch.fields.mont import FR
from zkrollup_torch.ntt import ntt

# One intra-op thread per process: the suite runs in several worker
# processes, whose torch thread pools would otherwise fight for the cores.
torch.set_num_threads(1)

LOG_N = 10


def _values(n: int, seed: int) -> list:
    rng = np.random.RandomState(seed)
    words = rng.randint(0, 1 << 32, size=(n, 8), dtype=np.uint64)
    return [sum(int(w) << (32 * i) for i, w in enumerate(row)) % FR.p
            for row in words]


def _mont(vals):
    return FR.to_mont_host(vals)


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int32))


@pytest.mark.parametrize("name", ["intt_mont", "coset_ntt_mont",
                                  "coset_intt_mont"])
def test_transform_matches_jax(name):
    a = _mont(_values(1 << LOG_N, 3))
    got = getattr(ntt, name)(_t(a))
    want = getattr(jntt, name)(jnp.asarray(a))
    assert np.array_equal(got.numpy().astype(np.uint32), np.asarray(want))


@pytest.mark.parametrize("inverse", [False, True])
def test_matches_native_engine(inverse):
    vals = _values(1 << LOG_N, 5)
    raw = engine.fr_ntt_bytes(engine.ints_to_fr_bytes(vals), 1 << LOG_N,
                              inverse)
    want = [int.from_bytes(raw[32 * i:32 * (i + 1)], "little")
            for i in range(1 << LOG_N)]
    got = FR.from_mont_host(ntt.ntt_mont(_t(_mont(vals)), inverse=inverse))
    assert got == want


def test_forward_matches_naive_dft():
    n = 16
    xs = _values(n, 7)
    w = ntt.domain_root(4)
    want = [sum(xs[j] * pow(w, i * j, FR.p) for j in range(n)) % FR.p
            for i in range(n)]
    assert FR.from_mont_host(ntt.ntt_mont(_t(_mont(xs)))) == want


def test_coset_roundtrip_and_tables():
    xs = _values(64, 9)
    a = _t(_mont(xs))
    assert FR.from_mont_host(
        ntt.coset_intt_mont(ntt.coset_ntt_mont(a))) == xs
    assert np.array_equal(ntt.bit_rev_perm(LOG_N), jntt._bit_rev_perm(LOG_N))
    assert ntt.ROOT_OF_UNITY == jntt.ROOT_OF_UNITY
    assert ntt.COSET_SHIFT == jntt.COSET_SHIFT


def test_stage_in_place_matches_flat_butterfly():
    """ntt_stage_ (the in-place kernel layout) equals the flat butterfly
    over the gathered (u, b, twiddle) rows."""
    n, m = 64, 8
    x = _t(_mont(_values(n, 11)))
    tw = _t(_mont(_values(m, 12)))
    grp = x.view(n // (2 * m), 2, m, 16)
    u = grp[:, 0].reshape(-1, 16)
    b = grp[:, 1].reshape(-1, 16)
    s, d = cuda_mont.butterfly_plain(FR, u, b, tw.repeat(n // (2 * m), 1))
    y = x.clone()
    cuda_mont.ntt_stage_(FR, y, tw, m)
    yg = y.view(n // (2 * m), 2, m, 16)
    assert torch.equal(yg[:, 0].reshape(-1, 16), s)
    assert torch.equal(yg[:, 1].reshape(-1, 16), d)
