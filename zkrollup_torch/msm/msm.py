"""Multi-scalar multiplication for BN254 G1/G2, with the reference's four
bucket strategies.

Counterpart of zkrollup/msm/msm.py. Every strategy turns the scalars into
c-bit window digits, sorts each window's digits and computes the per-window
bucket-weighted sums sum_b b * S_b; `tree` picks how:

  "scan"      (default) Abel summation over the sorted digits,

                sum_i d_i P_i = sum_{s=1}^{B-1} T_s,
                T_s = sum_{i: d_i >= s} P_i,

              every T_s one node of an exclusive prefix scan over the
              reversed sorted row, found by searchsorted. The scan is lazy
              and chunked: a sequential leg of K-1 mixed adds (the
              g1/g2_madd_nd kernels, or g1/g2_madd with distinct=False)
              inside chunks of K points, a Blelloch scan over chunk totals
              and one add per boundary gather (the g1/g2_add kernels). No
              scatter anywhere, and the work per window is balanced
              whatever the digit skew.
  "scan1"     the same Abel summation over one full Blelloch scan of each
              row (safe adds throughout): the reference's earlier path,
              kept as a differential check of the chunked one.
  "jacobian"  a pairwise run-merge tree over the sorted digit runs, one
              point add per node pair and level (g1/g2_add_z01 at the
              leaves, whose operands are affine or infinity; g1/g2_add
              above), closed runs scattered into a bucket array; then one
              Blelloch scan and one pairwise reduction of the buckets.
  "affine"    the same tree in affine coordinates: each level's adds share
              one batched inversion (weierstrass.batch_inverse on the
              mont_mul kernel).

All four are exact for any table (duplicate points and infinity rows
included); "scan" with distinct=True needs pairwise-distinct points.
Sort, gathers, scatters, searchsorted and index arithmetic are torch ops.
The prover brings window sums to the host for a Horner combine there
(msm/glv.py); `msm` combines them on the device instead, on the double and
add kernels. The reference reads its strategy from ZKROLLUP_MSM_TREE at
import; the port takes it as the `tree` argument and reads no environment.
"""

from __future__ import annotations

import numpy as np
import torch

from ..curve.weierstrass import affine_add_batch
from ..fields import limbs as L

# chunk length of the sequential scan leg (msm.py:CHUNK in the reference)
CHUNK = 128
# the bucket strategies (msm.py:_TREE_MODE in the reference)
TREES = ("scan", "scan1", "affine", "jacobian")


def _check_tree(tree: str) -> None:
    if tree not in TREES:
        raise ValueError(f"tree={tree!r}: must be 'scan', 'scan1', 'affine' "
                         "or 'jacobian'")


def window_digits(scalars: torch.Tensor, c: int, n_windows: int):
    """(n, 16) plain-form limbs -> (n_windows, n) int64 digits of c bits
    (c <= 16). Bits above 256 read as zero."""
    if not 1 <= c <= 16:
        raise ValueError("window width must be 1..16 bits")
    n = scalars.shape[0]
    dev = scalars.device
    ext = torch.cat([scalars.to(torch.int64),
                     torch.zeros((n, 2), dtype=torch.int64, device=dev)], 1)
    off = torch.arange(n_windows, dtype=torch.int64, device=dev) * c
    limb = off // L.LIMB_BITS
    v = ext[:, limb] | (ext[:, limb + 1] << L.LIMB_BITS)     # (n, W)
    d = (v >> (off % L.LIMB_BITS)) & ((1 << c) - 1)
    return d.T.contiguous()


def _clamp_window(c: int, n_sc: int) -> int:
    """2^c buckets are useless beyond ~n buckets (msm.py:_clamp_window)."""
    return max(2, min(c, max(n_sc.bit_length() - 1, 2)))


def _flat2d(curve, p, shape):
    return curve.map(lambda a: a.expand(shape).reshape(-1, L.N_LIMBS)
                     .contiguous(), p)


def _add_2d(curve, p, q):
    """curve.add on leaves of any leading shape; q may broadcast to p."""
    shape = curve.leaves(p)[0].shape
    out = curve.add(_flat2d(curve, p, shape), _flat2d(curve, q, shape))
    return curve.map(lambda a: a.reshape(shape), out)


def _interleave_axis1(curve, a, b):
    return curve.map(lambda l, r: torch.stack([l, r], dim=2).reshape(
        l.shape[:1] + (l.shape[1] * 2,) + l.shape[2:]), a, b)


def _excl_prefix_scan_axis1(curve, pts):
    """Work-efficient (Blelloch) exclusive prefix point-sum along axis 1 of
    (W, B, 16) leaves, B a power of two; also returns the per-row total
    (the up-sweep root). Safe adds throughout."""
    levels = []
    cur = pts
    while curve.leaves(cur)[0].shape[1] > 1:
        levels.append(cur)
        cur = _add_2d(curve, curve.map(lambda a: a[:, 0::2], cur),
                      curve.map(lambda a: a[:, 1::2], cur))
    total = curve.map(lambda a: a[:, 0], cur)
    leaf = curve.leaves(cur)[0]
    excl = curve.infinity((leaf.shape[0], 1), leaf.device)
    for lvl in reversed(levels):
        left = curve.map(lambda a: a[:, 0::2], lvl)
        excl = _interleave_axis1(curve, excl, _add_2d(curve, excl, left))
    return excl, total


def _excl_prefix_chunked(curve, p3, distinct: bool):
    """Lazy exclusive prefix scan of rows laid out chunk-major: p3 leaves
    are (K, W, nq, 16), p3[k, w, q] = row w, position q*K + k, every point
    with Z in {0, 1}. Returns (within, chunk_excl, total) with

        prefix_excl[w, q*K + k] == chunk_excl[w, q] (+) within[k, w, q].

    The sequential leg is K-1 mixed adds over W*nq lanes (distinct=True:
    the no-double kernel; the accumulator is a sum of earlier, different
    points of the same row); chunk totals go through a safe Blelloch scan,
    because totals of different chunks can be equal points."""
    lead = curve.leaves(p3)[0]
    K, W, nq = lead.shape[:3]
    dev = lead.device
    flat = lambda t: curve.map(lambda a: a.reshape(-1, L.N_LIMBS), t)
    acc = curve.map(lambda a: a[0], p3)
    ys = [curve.infinity((W, nq), dev)]
    for k in range(1, K):
        ys.append(acc)
        x = curve.map(lambda a: a[k], p3)
        acc = curve.map(lambda a: a.reshape(W, nq, L.N_LIMBS),
                        curve.madd_z01(flat(acc), flat(x), distinct=distinct))
    within = curve.map(lambda *ls: torch.stack(ls), *ys)   # (K, W, nq, 16)
    del ys
    nq_pad = 1 << max((nq - 1).bit_length(), 0)
    totals = acc
    if nq_pad != nq:
        totals = curve.map(lambda a, i: torch.cat([a, i], dim=1), totals,
                           curve.infinity((W, nq_pad - nq), dev))
    chunk_excl, total = _excl_prefix_scan_axis1(curve, totals)
    if nq_pad != nq:
        chunk_excl = curve.map(lambda a: a[:, :nq], chunk_excl)
    return within, chunk_excl, total


def _reduce_axis1(curve, pts):
    """Pairwise log-depth point sum along axis 1 -> leaves (W, 16)."""
    cur = pts
    while curve.leaves(cur)[0].shape[1] > 1:
        cur = _add_2d(curve, curve.map(lambda a: a[:, 0::2], cur),
                      curve.map(lambda a: a[:, 1::2], cur))
    return curve.map(lambda a: a[:, 0], cur)


def _flat_window_sums_scan2(curve, keys, xy, inf, c: int, n_tables: int,
                            distinct: bool, chunk: int = CHUNK):
    """Chunked-scan Abel summation over n_tables concatenated point tables
    (msm.py:_flat_window_sums_scan2). keys: (W, N) int64 with column j
    carrying (table_id << c) | digit; xy: the concatenated affine points,
    inf: (N, 1) mask; N a multiple of the chunk length. Returns window sums
    with leaves (W, n_tables, 16)."""
    W, N = keys.shape
    B = 1 << c
    dev = keys.device
    K = min(chunk, N)
    if N % K:
        raise ValueError("point count must be a multiple of the chunk")
    nq = N // K
    k_sorted, perm = torch.sort(keys, dim=1, stable=True)
    # gather straight into the chunk-major layout of the REVERSED rows:
    # p3[k, w, q] = sorted point at reversed position q*K + k of row w
    idx = perm.flip(1).reshape(W, nq, K).permute(2, 0, 1).reshape(-1)
    infm = inf.reshape(-1, 1) != 0
    # zeroed coordinates mark infinity after the gather: x == y == 0 is no
    # point of an odd-order curve
    coords = curve.F.leaves(xy[0]) + curve.F.leaves(xy[1])
    g = [torch.where(infm, 0, a).index_select(0, idx) for a in coords]
    inf_f = torch.stack([(a == 0).all(dim=1) for a in g]).all(dim=0)[:, None]
    x, y = (curve.F.from_leaves(g[:len(g) // 2]),
            curve.F.from_leaves(g[len(g) // 2:]))
    bshape = (g[0].shape[0],)
    z = curve.F.select(inf_f, curve.F.zeros(bshape, dev),
                       curve.F.one(bshape, dev))
    p3 = curve.map(lambda a: a.reshape(K, W, nq, L.N_LIMBS), (x, y, z))
    within, chunk_excl, total = _excl_prefix_chunked(curve, p3, distinct)
    del p3, g

    # thresholds, table-major: for table t the B-1 Abel cut-offs, then the
    # table-end marker (t+1) << c
    ts = torch.cat([torch.cat([torch.arange(1, B, dtype=torch.int64) + (t << c),
                               torch.tensor([(t + 1) << c])])
                    for t in range(n_tables)]).to(dev)
    j = torch.searchsorted(k_sorted, ts.expand(W, -1).contiguous())
    i_idx = N - j                                     # (W, T*B)
    rows = torch.arange(W, device=dev)[:, None]
    safe = i_idx.clamp(0, N - 1)
    q_idx, k_idx = safe // K, safe % K
    cpart = curve.map(lambda a: a[rows, q_idx], chunk_excl)
    wpart = curve.map(lambda a: a[k_idx, rows, q_idx], within)
    del within
    # safe add: a chunk prefix and a within-chunk prefix of a multi-table
    # row can be the same point
    gathered = _add_2d(curve, cpart, wpart)
    total_b = curve.map(lambda a: a[:, None].expand(W, n_tables * B,
                                                    L.N_LIMBS), total)
    sel = curve.select((i_idx == N)[..., None], total_b, gathered)
    sel = curve.select((i_idx == 0)[..., None],
                       curve.infinity((W, n_tables * B), dev), sel)

    # T_s = R(j_s) - R(table end): nested suffix sums, on the safe add
    sel3 = curve.map(lambda a: a.reshape(W, n_tables, B, L.N_LIMBS), sel)
    svals = curve.map(lambda a: a[:, :, :B - 1], sel3)
    end = curve.neg(curve.map(lambda a: a[:, :, B - 1:], sel3))
    t_vals = _add_2d(curve, svals, end)
    # per-(window, table) sum of T_s, padded B-1 -> B; adjacent T values
    # are equal when a digit is unused, so this stays on the safe add
    padded = curve.map(lambda a, i: torch.cat([a, i], dim=2), t_vals,
                       curve.infinity((W, n_tables, 1), dev))
    flat = curve.map(lambda a: a.reshape(W * n_tables, B, L.N_LIMBS), padded)
    red = _reduce_axis1(curve, flat)
    return curve.map(lambda a: a.reshape(W, n_tables, L.N_LIMBS), red)


def _gather_jacobian(curve, xy, inf, idx):
    """Gather affine points by idx and lift them to Jacobian: Z = 1
    (Montgomery), or 0 where the gathered infinity mask is set."""
    x, y = (curve.F.from_leaves([a.index_select(0, idx)
                                 for a in curve.F.leaves(v)]) for v in xy)
    inf_f = inf.reshape(-1, 1).index_select(0, idx) != 0
    bshape = (idx.shape[0],)
    z = curve.F.select(inf_f, curve.F.zeros(bshape, idx.device),
                       curve.F.one(bshape, idx.device))
    return (x, y, z)


def _flat_window_sums_scan(curve, digits, xy, inf, c: int):
    """Abel summation over one full Blelloch scan per window
    (msm.py:_flat_window_sums_scan, "scan1"): sort each row, gather, an
    exclusive prefix scan of the reversed row (2n safe adds a window), a
    (W, B-1) gather of scan nodes found by searchsorted, and a log-depth
    reduction. digits (W, n), n a power of two. Returns leaves (W, 16)."""
    W, n = digits.shape
    B = 1 << c
    dev = digits.device
    d_sorted, perm = torch.sort(digits, dim=1, stable=True)
    p = _gather_jacobian(curve, xy, inf, perm.reshape(-1))
    rev = curve.map(lambda a: a.reshape(W, n, L.N_LIMBS).flip(1), p)
    del p
    excl_rev, total = _excl_prefix_scan_axis1(curve, rev)
    del rev
    # j_s = searchsorted(row, s): the suffix from j_s is excl_rev[n - j_s];
    # n - j_s == 0 is no element (infinity), n - j_s == n is every element
    ts = torch.arange(1, B, dtype=torch.int64, device=dev)
    j = torch.searchsorted(d_sorted, ts.expand(W, -1).contiguous())
    i_idx = n - j                                      # (W, B-1)
    rows = torch.arange(W, device=dev)[:, None]
    safe = i_idx.clamp(0, n - 1)
    gathered = curve.map(lambda a: a[rows, safe], excl_rev)
    del excl_rev
    total_b = curve.map(lambda a: a[:, None].expand(W, B - 1, L.N_LIMBS),
                        total)
    sel = curve.select((i_idx == n)[..., None], total_b, gathered)
    sel = curve.select((i_idx == 0)[..., None],
                       curve.infinity((W, B - 1), dev), sel)
    padded = curve.map(lambda a, i: torch.cat([a, i], dim=1), sel,
                       curve.infinity((W, 1), dev))
    return _reduce_axis1(curve, padded)


def _tmap(fn, *ts):
    """Apply fn leafwise over nested tuples of tensors of one structure."""
    if isinstance(ts[0], torch.Tensor):
        return fn(*ts)
    return tuple(_tmap(fn, *xs) for xs in zip(*ts))


def _tleaves(t) -> list:
    if isinstance(t, torch.Tensor):
        return [t]
    return [leaf for a in t for leaf in _tleaves(a)]


def _run_merge_tree(p, empty, keys, W: int, n: int, c: int, bridge_fn):
    """The pairwise run-merge tree of msm.py:_run_merge_tree_jacobian and
    _run_merge_tree_affine over sorted keys (window << c | digit, (W*n,)).
    Each node tracks its leftmost run (key ld, sum lv, which may reach into
    earlier nodes), its rightmost run (rd, rv) and whether it is one run
    (whole). Merging two nodes costs one point add, bridge_fn(level, a_rv,
    b_lv), the sum across the boundary; a run that closes is written into
    the bucket of its key (digit 0 is never banked). After log2(n) levels
    the W roots, one per window, close their runs. p: the gathered points
    (a nested tuple of (W*n, ...) tensors); empty: the buckets' initial
    value, the same structure with W * 2^c + 1 rows. Returns the buckets,
    W * 2^c rows.

    Torch has no drop mode for the reference's .at[idx].set(v,
    mode="drop"): the buckets carry one extra row at index NB = W * 2^c,
    the sentinel, where every lane that closes nothing writes, and which
    is cut off at the end. Every real bucket closes exactly once, so only
    the sentinel row is written more than once in one scatter."""
    B = 1 << c
    NB = W * B
    buckets = _tleaves(empty)

    def close(mask, key, vals):
        bidx = torch.where(mask & ((key & (B - 1)) != 0), key, NB)
        for b, v in zip(buckets, _tleaves(vals)):
            b[bidx] = v

    def select(cond, a, b):
        return _tmap(lambda u, v: torch.where(cond, u, v), a, b)

    # strided halves are views; the kernels take contiguous copies, and
    # each level's inputs are freed before the next level
    half = lambda t, o: _tmap(lambda a: a[o::2].contiguous(), t)
    lv = rv = p
    ld = rd = keys
    whole = torch.ones(W * n, dtype=torch.bool, device=keys.device)
    del p
    for lvl in range(n.bit_length() - 1):
        a_lv, b_lv = half(lv, 0), half(lv, 1)
        if rv is lv:                     # the leaf level: one run per node
            a_rv, b_rv = a_lv, b_lv
        else:
            a_rv, b_rv = half(rv, 0), half(rv, 1)
        del lv, rv
        a_ld, b_ld = ld[0::2], ld[1::2]
        a_rd, b_rd = rd[0::2], rd[1::2]
        a_wh, b_wh = whole[0::2], whole[1::2]
        merge = a_rd == b_ld
        bridge = bridge_fn(lvl, a_rv, b_lv)
        close(~merge & ~a_wh, a_rd, a_rv)            # A's right run
        close(~merge & ~b_wh, b_ld, b_lv)            # B's left run
        close(merge & ~a_wh & ~b_wh, a_rd, bridge)   # the bridged inner run
        m2 = merge[:, None]
        lv = select(m2 & a_wh[:, None], bridge, a_lv)
        rv = select(m2 & b_wh[:, None], bridge, b_rv)
        del a_lv, b_lv, a_rv, b_rv, bridge
        ld, rd = a_ld, b_rd
        whole = a_wh & b_wh & merge
    # the W roots: the leftmost run closes, the rightmost too unless it IS
    # the leftmost
    close(torch.ones_like(whole), ld, lv)
    close(~whole, rd, rv)
    return _tmap(lambda b: b[:NB], empty)


def _run_merge_tree_jacobian(curve, xy, inf, keys, idx, W, n, c):
    """The run-merge tree in Jacobian coordinates
    (msm.py:_run_merge_tree_jacobian): at the leaf level both operands of
    every bridge are affine or infinity (Z in {0, 1}), so it takes
    add_z01 (the g1/g2_add_z01 kernel); every level above takes the
    unified add. Empty buckets stay (0, 0, 0), infinity. Returns the
    (W, 2^c) Jacobian buckets."""
    NB = W << c
    empty = _tmap(lambda a: a.new_zeros((NB + 1,) + a.shape[1:]),
                  (xy[0], xy[1], xy[0]))
    bridge = lambda lvl, a, b: (curve.add_z01(a, b) if lvl == 0
                                else curve.add(a, b))
    bk = _run_merge_tree(_gather_jacobian(curve, xy, inf, idx), empty, keys,
                         W, n, c, bridge)
    return curve.map(lambda a: a.reshape(W, 1 << c, L.N_LIMBS), bk)


def _run_merge_tree_affine(curve, xy, inf, keys, idx, W, n, c):
    """The run-merge tree in affine coordinates
    (msm.py:_run_merge_tree_affine): points are (x, y, inf) with an (m, 1)
    mask, and each level's bridges are one affine_add_batch, whose lanes
    share one batched inversion. Empty buckets stay infinite; the buckets
    are lifted to Jacobian at the end. Returns the (W, 2^c) Jacobian
    buckets."""
    F = curve.F
    NB = W << c
    empty = _tmap(lambda a: a.new_zeros((NB + 1,) + a.shape[1:]), xy) + (
        torch.ones((NB + 1, 1), dtype=torch.bool, device=idx.device),)
    bridge = lambda lvl, a, b: affine_add_batch(curve, a, b)
    bx, by, binf = _run_merge_tree(
        tuple(_tmap(lambda a: a.index_select(0, idx), v) for v in xy)
        + (inf.reshape(-1, 1).index_select(0, idx) != 0,),
        empty, keys, W, n, c, bridge)
    bz = F.select(binf, F.zeros((NB,), binf.device),
                  F.one((NB,), binf.device))
    return curve.map(lambda a: a.reshape(W, 1 << c, L.N_LIMBS), (bx, by, bz))


def _flat_window_sums(curve, digits, xy, inf, c: int, distinct: bool,
                      tree: str, chunk: int = CHUNK):
    """The bucket-weighted sums of all windows at once
    (msm.py:_flat_window_sums): digits (W, n), n a power of two; xy the
    affine coordinates, inf the (n, 1) infinity mask. Returns the
    per-window sums, Jacobian leaves (W, 16)."""
    if tree == "scan":
        out = _flat_window_sums_scan2(curve, digits, xy, inf, c, 1,
                                      distinct, chunk)
        return curve.map(lambda a: a[:, 0], out)
    if tree == "scan1":
        return _flat_window_sums_scan(curve, digits, xy, inf, c)
    W, n = digits.shape
    if n & (n - 1):
        raise ValueError("msm: pad the point count to a power of two")
    d_sorted, perm = torch.sort(digits, dim=1, stable=True)
    # key = (window << c) | digit: runs never span windows
    w_ids = torch.arange(W, dtype=torch.int64, device=digits.device)
    keys = (d_sorted + (w_ids << c)[:, None]).reshape(-1)
    idx = perm.reshape(-1)
    del d_sorted, perm
    build = (_run_merge_tree_affine if tree == "affine"
             else _run_merge_tree_jacobian)
    bk = build(curve, xy, inf, keys, idx, W, n, c)
    # sum_b b S_b = sum_j sum_{b > j} S_b: the reduction of the exclusive
    # suffix scan of the buckets, one Blelloch scan and one pairwise
    # reduction on the safe add
    flipped = curve.map(lambda a: a.flip(1), bk)
    excl, _ = _excl_prefix_scan_axis1(curve, flipped)
    return _reduce_axis1(curve, excl)


def pack_tables(tables, chunk: int = CHUNK):
    """Concatenate point tables (x, y, inf) into one flat host problem padded
    with infinity to a chunk multiple. Returns (points, bounds) with bounds
    [(start, len)] per table. Host-side, once per proving key."""
    xs, ys, infs, bounds = [], [], [], []
    start = 0
    for (x, y, inf) in tables:
        bounds.append((start, x.shape[0]))
        xs.append(x); ys.append(y); infs.append(np.asarray(inf, bool))
        start += x.shape[0]
    pad = -start % chunk
    if pad:
        xs.append(np.zeros((pad,) + xs[0].shape[1:], xs[0].dtype))
        ys.append(np.zeros((pad,) + ys[0].shape[1:], ys[0].dtype))
        infs.append(np.ones((pad, 1), bool))
    return (np.concatenate(xs), np.concatenate(ys),
            np.concatenate(infs)), bounds


def multi_window_sums(curve, points, scalars_cat, c: int, bounds,
                      distinct: bool, chunk: int = CHUNK):
    """Window sums of several tables in one scan (msm.py:_multi_window_sums).
    points: concatenated (x, y, inf) tensors from pack_tables; scalars_cat:
    (N, 16) plain scalars aligned with them (zeros in the padding). Returns
    (wsum with leaves (W, n_tables, 16), c)."""
    x, y, inf = points
    N = scalars_cat.shape[0]
    n_tables = len(bounds)
    c = _clamp_window(c, max(l for _, l in bounds))
    n_windows = (256 + c - 1) // c
    digits = window_digits(scalars_cat, c, n_windows)
    off = np.full((N,), (n_tables - 1) << c, np.int64)   # padding: last table
    for t, (s, l) in enumerate(bounds):
        off[s:s + l] = t << c
    keys = digits + torch.from_numpy(off).to(digits.device)[None]
    return _flat_window_sums_scan2(curve, keys, (x, y), inf, c, n_tables,
                                   distinct, chunk), c


def _pad_problem(curve, points_affine, scalars):
    """Pad points and scalars to a power of two with infinity points and
    zero scalars (msm.py:_pad_problem)."""
    x, y, inf = points_affine
    n = scalars.shape[0]
    n_pad = 1 << max((n - 1).bit_length(), 1)
    inf = inf.to(torch.bool)
    if n_pad != n:
        pad = n_pad - n
        zpad = lambda a: torch.cat([a, a.new_zeros((pad,) + a.shape[1:])])
        scalars = zpad(scalars)
        x, y = (curve.F.from_leaves([zpad(a) for a in curve.F.leaves(v)])
                for v in (x, y))
        inf = torch.cat([inf, inf.new_ones((pad, 1))])
    return (x, y, inf), scalars


def window_sums(curve, points_affine, scalars, c: int = 12,
                n_bits: int = 256, distinct: bool = False,
                tree: str = "scan", chunk: int = CHUNK):
    """Single-table window sums (msm.py:window_sums): points_affine (x, y,
    inf) tensors, scalars (n, 16) plain limbs, each below 2^n_bits. The
    problem is padded to a power of two. Returns (wsum with leaves (W, 16),
    c), W = ceil(n_bits / c). tree picks the bucket strategy (TREES);
    distinct=True lets "scan" take the no-double kernels and needs
    pairwise-distinct points."""
    _check_tree(tree)
    c = _clamp_window(c, scalars.shape[0])
    n_windows = (n_bits + c - 1) // c
    (x, y, inf), scalars = _pad_problem(curve, points_affine, scalars)
    digits = window_digits(scalars, c, n_windows)
    return _flat_window_sums(curve, digits, (x, y), inf, c, distinct, tree,
                             chunk), c


def msm(curve, points_affine, scalars, c: int = 12, n_bits: int = 256,
        distinct: bool = False, tree: str = "scan", chunk: int = CHUNK):
    """Full MSM on the scalars' device (msm.py:msm): the window sums, then
    the Horner combine over windows, high to low, res = 2^c res + W_w, as
    c double launches and one add launch per window on one lane. Returns
    one Jacobian point with (16,) leaves. distinct=False (the default) is
    correct for any table; distinct=True needs pairwise-distinct points."""
    wsum, c = window_sums(curve, points_affine, scalars, c, n_bits, distinct,
                          tree, chunk)
    n_windows = curve.leaves(wsum)[0].shape[0]
    res = curve.infinity((1,), scalars.device)
    for w in range(n_windows - 1, -1, -1):
        for _ in range(c):
            res = curve.double(res)
        res = curve.add(res, curve.map(lambda a: a[w:w + 1].contiguous(),
                                       wsum))
    return curve.map(lambda a: a[0], res)


def msm_host_combine(curve, points_affine, scalars, c: int = 12,
                     n_bits: int = 256, distinct: bool = False,
                     tree: str = "scan"):
    """The window sums on the scalars' device, the Horner combine on the
    host in Python ints (msm.py:msm_host_combine). G1 only. Returns a
    Jacobian point with (16,) leaves on the scalars' device, as msm()."""
    from .glv import combine_window_sums_host
    wsum, c = window_sums(curve, points_affine, scalars, c, n_bits, distinct,
                          tree)
    return combine_window_sums_host(wsum, c)
