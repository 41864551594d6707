"""Multi-scalar multiplication for BN254 G1/G2: the chunked-scan path.

Counterpart of the default ("scan") path of zkrollup/msm/msm.py. Per
window, every point's c-bit digit (with its table id in the high bits) is a
sort key; Abel summation turns the bucket-weighted window sum into a sum of
suffix sums of the sorted points,

    sum_i d_i P_i = sum_{s=1}^{B-1} T_s,   T_s = sum_{i: d_i >= s} P_i,

and every T_s is one node of an exclusive prefix scan over the reversed
sorted row, found by searchsorted. The scan is lazy and chunked: a
sequential leg of K-1 no-double mixed adds (the g1/g2_madd_nd kernels)
inside chunks of K points, a Blelloch scan over chunk totals and one add
per boundary gather (the g1/g2_add kernels). No scatter-add anywhere, and
the work per window is balanced whatever the digit skew.

Sort, gathers, searchsorted and index arithmetic are torch ops. The prover
brings window sums to the host for a Horner combine there (msm/glv.py);
`msm` combines them on the device instead, on the double and add kernels.
With distinct=False the scan leg runs the madd kernels, which take the
doubling path, so tables with duplicate points are safe.
"""

from __future__ import annotations

import numpy as np
import torch

from ..fields import limbs as L

# chunk length of the sequential scan leg (msm.py:CHUNK in the reference)
CHUNK = 128


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


def _add_nd(curve, p, q):
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
        cur = _add_nd(curve, curve.map(lambda a: a[:, 0::2], cur),
                      curve.map(lambda a: a[:, 1::2], cur))
    total = curve.map(lambda a: a[:, 0], cur)
    leaf = curve.leaves(cur)[0]
    excl = curve.infinity((leaf.shape[0], 1), leaf.device)
    for lvl in reversed(levels):
        left = curve.map(lambda a: a[:, 0::2], lvl)
        excl = _interleave_axis1(curve, excl, _add_nd(curve, excl, left))
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
        cur = _add_nd(curve, curve.map(lambda a: a[:, 0::2], cur),
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
    gathered = _add_nd(curve, cpart, wpart)
    total_b = curve.map(lambda a: a[:, None].expand(W, n_tables * B,
                                                    L.N_LIMBS), total)
    sel = curve.select((i_idx == N)[..., None], total_b, gathered)
    sel = curve.select((i_idx == 0)[..., None],
                       curve.infinity((W, n_tables * B), dev), sel)

    # T_s = R(j_s) - R(table end): nested suffix sums, on the safe add
    sel3 = curve.map(lambda a: a.reshape(W, n_tables, B, L.N_LIMBS), sel)
    svals = curve.map(lambda a: a[:, :, :B - 1], sel3)
    end = curve.neg(curve.map(lambda a: a[:, :, B - 1:], sel3))
    t_vals = _add_nd(curve, svals, end)
    # per-(window, table) sum of T_s, padded B-1 -> B; adjacent T values
    # are equal when a digit is unused, so this stays on the safe add
    padded = curve.map(lambda a, i: torch.cat([a, i], dim=2), t_vals,
                       curve.infinity((W, n_tables, 1), dev))
    flat = curve.map(lambda a: a.reshape(W * n_tables, B, L.N_LIMBS), padded)
    red = _reduce_axis1(curve, flat)
    return curve.map(lambda a: a.reshape(W, n_tables, L.N_LIMBS), red)


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


def window_sums(curve, points_affine, scalars, c: int = 12,
                distinct: bool = False, chunk: int = CHUNK):
    """Single-table window sums (msm.py:window_sums): points_affine (x, y,
    inf) tensors, scalars (n, 16) plain limbs. The problem is
    padded to a power of two. Returns (wsum with leaves (W, 16), c)."""
    x, y, inf = points_affine
    n = scalars.shape[0]
    c = _clamp_window(c, n)
    n_windows = (256 + c - 1) // c
    n_pad = 1 << max((n - 1).bit_length(), 1)
    if n_pad != n:
        pad = n_pad - n
        zpad = lambda a: torch.cat([a, a.new_zeros((pad,) + a.shape[1:])])
        scalars = zpad(scalars)
        x, y = (curve.F.from_leaves([zpad(a) for a in curve.F.leaves(v)])
                for v in (x, y))
        inf = torch.cat([inf.to(torch.bool), inf.new_ones((pad, 1),
                                                          dtype=torch.bool)])
    digits = window_digits(scalars, c, n_windows)
    out = _flat_window_sums_scan2(curve, digits, (x, y), inf, c, 1,
                                  distinct, chunk)
    return curve.map(lambda a: a[:, 0], out), c


def msm(curve, points_affine, scalars, c: int = 12, distinct: bool = False,
        chunk: int = CHUNK):
    """Full MSM on the scalars' device (msm.py:msm): the window sums, then
    the Horner combine over windows, high to low, res = 2^c res + W_w, as
    c double launches and one add launch per window on one lane. Returns
    one Jacobian point with (16,) leaves. distinct=False (the default) is
    correct for any table; distinct=True needs pairwise-distinct points."""
    wsum, c = window_sums(curve, points_affine, scalars, c, distinct, chunk)
    n_windows = curve.leaves(wsum)[0].shape[0]
    res = curve.infinity((1,), scalars.device)
    for w in range(n_windows - 1, -1, -1):
        for _ in range(c):
            res = curve.double(res)
        res = curve.add(res, curve.map(lambda a: a[w:w + 1].contiguous(),
                                       wsum))
    return curve.map(lambda a: a[0], res)
