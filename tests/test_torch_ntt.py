"""zkrollup_torch NTT against zkrollup.ntt (JAX) and the native engine:
inverse, coset forward and coset inverse transforms at 2^10, limb for limb,
plus the forward transform against a naive DFT and the engine's NTT; and
the passes of ntt_pass against the stage-by-stage route they replace: every
split of a transform into passes, the pre/post tables, the pointwise
prologue, batches, and a model of the kernel's tiling. Every comparison is
bit for bit (tolerance 0)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from zkrollup.native import engine
from zkrollup.ntt import ntt as jntt
from zkrollup_torch.fields import cuda_mont, limbs as L
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


# -- the passes of ntt_pass (tolerance 0: bit for bit) -------------------------

def _stage_loop(x, inverse=False):
    """The one-stage-per-launch route of the earlier design: the
    bit-reversal gather, then ntt_stage_plain_ over every stage."""
    log_n = x.shape[0].bit_length() - 1
    y = x[torch.from_numpy(ntt.bit_rev_perm(log_n))].clone()
    for s, tw in enumerate(ntt._stage_twiddles_host(log_n, inverse)):
        cuda_mont.ntt_stage_plain_(FR, y, _t(tw), 1 << s)
    return y


def _run_passes(x, split, inverse=False, **kw):
    """A transform as ntt_pass calls of `split` stages each, the first
    gathering (pre, pointwise), the last with post."""
    log_n = x.shape[-2].bit_length() - 1
    tw = _t(ntt._twiddles_host(log_n, inverse))
    post = kw.pop("post", None)
    y, s0 = None, 0
    for p, k in enumerate(split):
        last = p == len(split) - 1
        if p == 0:
            y = cuda_mont.ntt_pass(FR, x, tw, 0, k, bitrev=True,
                                   post=post if last else None, **kw)
        else:
            cuda_mont.ntt_pass(FR, y, tw, s0, k, out=y,
                               post=post if last else None)
        s0 += k
    return y


@pytest.mark.parametrize("split", [[10], [5, 5], [3, 7], [4, 3, 3],
                                   [1] * 10, [9, 1], [0, 10]])
@pytest.mark.parametrize("inverse", [False, True])
def test_every_split_into_passes_equals_the_stage_loop(split, inverse):
    x = _t(_mont(_values(1 << LOG_N, 13)))
    assert torch.equal(_run_passes(x, split, inverse), _stage_loop(x, inverse))


def test_transform_matches_the_stage_loop_and_the_public_functions():
    x = _t(_mont(_values(1 << LOG_N, 14)))
    assert torch.equal(ntt.transform(x), _stage_loop(x))
    assert torch.equal(ntt.ntt_mont(x), _stage_loop(x))
    ninv = FR.const_mont(pow(1 << LOG_N, FR.p - 2, FR.p), "cpu")
    assert torch.equal(ntt.intt_mont(x),
                       FR.mont_mul(_stage_loop(x, True), ninv))
    assert ntt.passes(17) == [(0, 10), (10, 7)]
    assert ntt.passes(20) == [(0, 10), (10, 10)]
    assert ntt.passes(3) == [(0, 3)]


def test_tables_and_batch_equal_separate_products():
    """pre (Montgomery), post (Montgomery table, one broadcast element and
    a plain-form table), the pointwise prologue and a batch of three equal
    the separate mont_mul calls around the stage loop."""
    n = 1 << LOG_N
    xs = torch.stack([_t(_mont(_values(n, 20 + b))) for b in range(3)])
    pre, post = _t(_mont(_values(n, 24))), _t(_mont(_values(n, 25)))
    plain_vals = _values(n, 26)
    plain_post = _t(L.ints_to_limbs(plain_vals))
    mm = FR.mont_mul
    got = ntt.transform(xs, pre=pre, post=post)
    for b in range(3):
        assert torch.equal(got[b], mm(_stage_loop(mm(xs[b], pre)), post))
    got = ntt.transform(xs, True, post=post[7])
    for b in range(3):
        assert torch.equal(got[b], mm(_stage_loop(xs[b], True), post[7]))
    # a plain-form post leaves the Montgomery domain: from_mont for free
    got = ntt.transform(xs[0], post=plain_post)
    coeffs = FR.from_mont_host(_stage_loop(xs[0]))
    assert L.limbs_to_ints(got) == [v * w % FR.p
                                    for v, w in zip(coeffs, plain_vals)]
    zinv = _t(_mont(_values(1, 27)))[0]
    got = ntt.transform(xs[0], True, pointwise=(xs[1], xs[2], zinv),
                        post=post)
    h = mm(FR.sub(mm(xs[0], xs[1]), xs[2]), zinv)
    assert torch.equal(got, mm(_stage_loop(h, True), post))


def _kernel_schedule(n, s0, k, tile_log):
    """csrc/fields.cu ntt_pass_kernel's index arithmetic (with the tile
    shape of zkt_ntt_pass_fr), line for line: for each block, the rows of
    its tile and, per stage, the butterflies (row of u, row of v, twiddle
    row)."""
    glog = tile_log - k
    glo = min(glog, s0)
    ghi = glog - glo
    while ghi > 0 and n % (1 << (s0 + k + ghi)):
        ghi -= 1
    glog = glo + ghi
    tile, gmask, lomask = 1 << (k + glog), (1 << glog) - 1, (1 << glo) - 1
    lo_blocks = (1 << s0) >> glo
    stride, span = 1 << s0, 1 << (s0 + k)
    for blk in range(n // tile):
        lo = (blk % lo_blocks) << glo
        hi = blk // lo_blocks
        base = lo + ((hi << ghi) << (s0 + k))
        rows = [base + ((e & gmask) & lomask) + ((e & gmask) >> glo) * span
                + (e >> glog) * stride for e in range(tile)]
        stages = []
        for t in range(k):
            m, half = 1 << (s0 + t), 1 << t
            bfs = []
            for q in range(tile // 2):
                g, r = q & gmask, q >> glog
                jlo = r & (half - 1)
                eu = ((((r >> t) << (t + 1)) | jlo) << glog) | g
                ev = eu + (half << glog)
                bfs.append((rows[eu], rows[ev],
                            m + lo + (g & lomask) + jlo * stride))
            stages.append(bfs)
        yield rows, stages


@pytest.mark.parametrize("log_n,tile_log,split", [
    (10, 10, [10]), (12, 10, [10, 2]), (8, 3, [3, 3, 2]), (7, 4, [1, 4, 2]),
    (6, 3, [0, 3, 3]), (8, 5, [1] * 8), (9, 6, [2, 1, 4, 2]), (4, 6, [4])])
def test_kernel_schedule_model_equals_the_stage_loop(log_n, tile_log, split):
    """A model of the pass kernel's tiling on Python ints: the blocks of a
    pass cover every row once, each stage's butterflies take every row of
    a tile once, and running them pass by pass gives the stage loop."""
    n, p = 1 << log_n, FR.p
    vals = _values(n, 15)
    tw = [0] + [v for t in ntt._stage_twiddles_host(log_n, False)
                for v in FR.from_mont_host(t)]
    rev = ntt.bit_rev_perm(log_n)
    x = [vals[int(rev[i])] for i in range(n)]
    s0 = 0
    for k in split:
        seen = []
        for rows, stages in _kernel_schedule(n, s0, k, tile_log):
            seen += rows
            for bfs in stages:
                assert sorted(r for u, v, _ in bfs for r in (u, v)) == \
                    sorted(rows)
                for u, v, w in bfs:
                    b = x[v] * tw[w] % p
                    x[u], x[v] = (x[u] + b) % p, (x[u] - b) % p
        assert sorted(seen) == list(range(n))
        s0 += k
    want = FR.from_mont_host(_stage_loop(_t(_mont(vals))))
    assert x == want
