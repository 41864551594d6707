"""Groth16 prover on a torch device.

Counterpart of the device branch of zkrollup/groth16/prove.py:prove:

  1. witness -> Montgomery limbs (mont_mul kernel)
  2. sparse A/B/C evaluation over the domain: one Montgomery product per
     term, per-limb int64 index_add_ into the rows, two-product fold mod r
  3. quotient h = (A*B - C)/Z on the coset g*H: 3 iNTT, 3 coset NTT, a
     pointwise step and 1 coset iNTT (butterfly and mont_mul kernels)
  4. per-table scalars, duplicate key points merged (_filt_dedup)
  5. one fused 4-table G1 MSM (chunked scan, g1_madd_nd / g1_add kernels);
     with glv=True instead four GLV MSMs over the full a, b1, c and h
     tables (msm/glv.py:msm_glv), each with the host Horner combine
  6. one G2 MSM over the deduplicated b2 table (g2_madd_nd / g2_add with
     the default tree="scan")
  7. window sums to standard form on the device (mont_mul over Fq), one
     copy to the host, Horner combine and blinding there

`tree` picks the bucket strategy of every single-table window sum (msm.py:
TREES): the G2 MSM, and with glv=True the four G1 MSMs. The fused G1 MSM
of the default path stays on the chunked scan, as in the reference. The
reference selects both with ZKROLLUP_PROVE_GLV and ZKROLLUP_MSM_TREE at
import; the port takes them as arguments.

prove_host mirrors the reference's host path (zkrollup/groth16/prove.py:
_prove_host) on the native engine; it is the independent check the device
proof is held against.
"""

from __future__ import annotations

import secrets
import time
from typing import List, Optional

import numpy as np
import torch

from ..native import engine
from ..ref import bn254 as ref
from ..ref.bn254 import R as FR_MOD
from ..fields.mont import FR, FQ
from ..fields import limbs as L
from ..ntt.ntt import intt_mont, coset_ntt_mont, coset_intt_mont, COSET_SHIFT
from ..curve import g1 as g1_mod
from ..curve.g1 import G1
from ..curve.g2 import G2
from ..msm import msm
from ..msm.glv import (combine_multi_window_sums_host,
                       combine_window_sums_host_g2, msm_glv)
from .keys import ProvingKey, Proof
from .qap import to_coo


def _fold_lazy(sums: torch.Tensor) -> torch.Tensor:
    """(n, 16) lazy int64 limb sums V (< 2^288) -> V mod r, as int32 limbs.
    V = lo + hi*2^256, so V mod r = mont(lo, R) + mont(hi, R^2): the
    result is in the same (plain or Montgomery) form as the summands."""
    n, dev = sums.shape[0], sums.device
    ext = L.propagate_carries(torch.cat(
        [sums, torch.zeros((n, 2), dtype=torch.int64, device=dev)], 1))
    lo = ext[:, :L.N_LIMBS].to(L.DTYPE).contiguous()
    hi = torch.cat([ext[:, L.N_LIMBS:],
                    torch.zeros((n, L.N_LIMBS - 2), dtype=torch.int64,
                                device=dev)], 1).to(L.DTYPE)
    return FR.add(FR.mont_mul(lo, FR.one_mont(dev)),
                  FR.mont_mul(hi, FR.r2_limbs(dev)))


def _spmv(row, var, coeff_mont, w_mont, m: int) -> torch.Tensor:
    """eval[j] = sum_{k in row j} coeff_k * w[var_k] mod r (Montgomery)."""
    terms = FR.mont_mul(coeff_mont, w_mont.index_select(0, var))
    sums = torch.zeros((m, L.N_LIMBS), dtype=torch.int64,
                       device=terms.device)
    sums.index_add_(0, row, terms.to(torch.int64))
    return _fold_lazy(sums)


def _abc_evals(coo_dev, w_mont, m: int):
    return tuple(_spmv(row, var, coeff, w_mont, m)
                 for row, var, coeff in coo_dev)


def _quotient_plain(a_e, b_e, c_e, zinv_mont) -> torch.Tensor:
    """Domain evaluations (Montgomery) -> h coefficients in PLAIN form.
    Z(g*w^i) = g^m - 1 is constant on the coset."""
    pa, pb, pc = intt_mont(a_e), intt_mont(b_e), intt_mont(c_e)
    ca, cb, cc = coset_ntt_mont(pa), coset_ntt_mont(pb), coset_ntt_mont(pc)
    h_cos = FR.mont_mul(FR.sub(FR.mont_mul(ca, cb), cc), zinv_mont)
    return FR.from_mont(coset_intt_mont(h_cos))


def _filt_dedup(x, y, inf, scalar_idx):
    """Drop infinity rows and merge duplicate points (prove.py:_filt_dedup).
    Returns ((x, y, inf) of unique points, source scalar index, merge map
    source row -> unique point, number of unique points). The no-double
    scan kernels need pairwise-distinct points within a table."""
    keep = np.where(inf[:, 0] == 0)[0]
    xy = np.concatenate([x[keep], y[keep]], axis=1)
    uxy, first, inv = np.unique(xy, axis=0, return_index=True,
                                return_inverse=True)
    return ((x[keep][first], y[keep][first], inf[keep][first]),
            scalar_idx[keep], inv.reshape(-1), uxy.shape[0])


def _dev(a, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _device_pack_g1(pk: ProvingKey, device):
    """The four G1 key tables as ONE packed multi-table problem on `device`,
    with index and merge maps for the per-proof scalars. Cached on the key."""
    cache = pk.__dict__.setdefault("_torch_pack_g1", {})
    key = str(device)
    if key in cache:
        return cache[key]
    nv, npub, m = pk.n_vars, pk.n_public, pk.domain_size
    prep = lambda tbl, sidx: _filt_dedup(*(np.asarray(t) for t in tbl), sidx)
    tabs = (prep(pk.a_g1, np.arange(nv)), prep(pk.b1_g1, np.arange(nv)),
            prep(pk.c_g1, np.arange(npub, nv)), prep(pk.h_g1, np.arange(m - 1)))
    (x, y, inf), bounds = msm.pack_tables([t[0] for t in tabs])
    pack = {
        "points": (L.to_device(x, device), L.to_device(y, device),
                   _dev(inf, device)),
        "bounds": tuple(bounds),
        "idx": tuple(_dev(t[1].astype(np.int64), device) for t in tabs),
        "seg": tuple(_dev(t[2].astype(np.int64), device) for t in tabs),
        "n_seg": tuple(int(t[3]) for t in tabs),
        "N": int(x.shape[0]),
    }
    cache[key] = pack
    return pack


def _device_pack_g2(pk: ProvingKey, device):
    """Infinity-filtered, deduplicated b2 table on `device`. Cached."""
    cache = pk.__dict__.setdefault("_torch_pack_g2", {})
    key = str(device)
    if key in cache:
        return cache[key]
    (x0, x1), (y0, y1), inf = (pk.b2_g2[0], pk.b2_g2[1], pk.b2_g2[2])
    x0, x1, y0, y1, inf = (np.asarray(t) for t in (x0, x1, y0, y1, inf))
    keep = np.where(inf[:, 0] == 0)[0]
    xy = np.concatenate([c[keep] for c in (x0, x1, y0, y1)], axis=1)
    uxy, first, inv = np.unique(xy, axis=0, return_index=True,
                                return_inverse=True)
    sel = keep[first]
    d = lambda a: L.to_device(a[sel], device)
    pack = {"points": ((d(x0), d(x1)), (d(y0), d(y1)), _dev(inf[sel], device)),
            "idx": _dev(keep.astype(np.int64), device),
            "seg": _dev(inv.reshape(-1).astype(np.int64), device),
            "n_seg": int(uxy.shape[0])}
    cache[key] = pack
    return pack


def _device_tables_glv(pk: ProvingKey, device):
    """The a, b1, c and h tables as they are, infinity rows and duplicate
    points included, on `device`: the GLV MSMs take any table. Cached."""
    cache = pk.__dict__.setdefault("_torch_tables_glv", {})
    key = str(device)
    if key not in cache:
        cache[key] = {t: (L.to_device(np.asarray(x), device),
                          L.to_device(np.asarray(y), device),
                          _dev(np.asarray(inf), device))
                      for t, (x, y, inf) in (("a", pk.a_g1),
                                             ("b1", pk.b1_g1),
                                             ("c", pk.c_g1),
                                             ("h", pk.h_g1))}
    return cache[key]


def _g1_affine(jac):
    """A Jacobian point with (16,) Montgomery leaves -> affine | None."""
    return g1_mod.to_affine_host([c.reshape(1, L.N_LIMBS) for c in jac])[0]


def _segsum_scalars(scalars, seg, n_seg: int) -> torch.Tensor:
    """Sum the scalars of merged duplicate points, mod r (plain form)."""
    sums = torch.zeros((n_seg, L.N_LIMBS), dtype=torch.int64,
                       device=scalars.device)
    sums.index_add_(0, seg, scalars.to(torch.int64))
    return _fold_lazy(sums)


def _scalars_cat(w_plain, h_plain, pack) -> torch.Tensor:
    """Gather and merge the per-table scalars into the packed column layout
    (zero scalars in the padding columns)."""
    srcs = (w_plain, w_plain, w_plain, h_plain)
    parts = [_segsum_scalars(s.index_select(0, pack["idx"][t]),
                             pack["seg"][t], pack["n_seg"][t])
             for t, s in enumerate(srcs)]
    used = sum(l for _, l in pack["bounds"])
    if pack["N"] > used:
        parts.append(torch.zeros((pack["N"] - used, L.N_LIMBS),
                                 dtype=L.DTYPE, device=w_plain.device))
    return torch.cat(parts)


def _to_host_standard(curve, wsum) -> list:
    """Window sums -> standard form on the device (FQ.from_mont), then ONE
    device-to-host copy. Returns the point with numpy leaves."""
    leaves = [FQ.from_mont(a.contiguous()) for a in curve.leaves(wsum)]
    host = torch.stack(leaves).cpu().numpy()
    return curve.from_leaves(list(host))


def _blind_combine(pk: ProvingKey, pi_a_msm, pi_b_msm, pi_b1_msm, pi_c_msm,
                   pi_h_msm, r: int, s: int) -> Proof:
    """Blinding combine (host single-point ops, prove.py:_blind_combine)."""
    g1a, g1m = ref.g1_add, ref.g1_mul
    pi_a = g1a(g1a(pk.alpha1, pi_a_msm), g1m(pk.delta1, r))
    pi_b = ref.g2_add(ref.g2_add(pk.beta2, pi_b_msm),
                      ref.g2_mul(pk.delta2, s))
    pi_b1 = g1a(g1a(pk.beta1, pi_b1_msm), g1m(pk.delta1, s))
    pi_c = g1a(g1a(pi_c_msm, pi_h_msm),
               g1a(g1a(g1m(pi_a, s), g1m(pi_b1, r)),
                   g1m(pk.delta1, (-r * s) % FR_MOD)))
    return Proof(a=pi_a, b=pi_b, c=pi_c)


def _coo_on(coo, device):
    cache = coo.__dict__.setdefault("_torch_dev", {})
    key = str(device)
    if key not in cache:
        cache[key] = tuple(
            (_dev(row.astype(np.int64), device),
             _dev(var.astype(np.int64), device), L.to_device(coeff, device))
            for row, var, coeff in ((coo.a_row, coo.a_var, coo.a_coeff),
                                    (coo.b_row, coo.b_var, coo.b_coeff),
                                    (coo.c_row, coo.c_var, coo.c_coeff)))
    return cache[key]


def _check_rs(pk: ProvingKey, r1cs, r, s):
    if r1cs.n_vars != pk.n_vars or r1cs.n_public != pk.n_public:
        raise ValueError("proving key does not match this constraint system")
    return (secrets.randbelow(FR_MOD) if r is None else r,
            secrets.randbelow(FR_MOD) if s is None else s)


def prove(pk: ProvingKey, r1cs, witness: List[int], r: Optional[int] = None,
          s: Optional[int] = None, *, device, c: int = 12, glv: bool = False,
          tree: str = "scan", timings: Optional[dict] = None) -> Proof:
    """Groth16 proof of `witness` (full assignment, var 0 = 1) on `device`.
    r, s pin the blinding (same inputs, same key => same proof bytes). c is
    the Pippenger window; proofs do not depend on it, nor on glv (the GLV
    G1 MSMs) or tree (the bucket strategy, msm.TREES). If `timings` is a
    dict, each stage synchronises the device and records its seconds."""
    r, s = _check_rs(pk, r1cs, r, s)
    msm._check_tree(tree)
    device = torch.device(device)
    coo = to_coo(r1cs)
    m = coo.m
    if m != pk.domain_size:
        raise ValueError("key/domain mismatch")
    clock = [time.perf_counter()]

    def stage(name):
        if timings is not None:
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            now = time.perf_counter()
            timings[name] = now - clock[0]
            clock[0] = now

    w_plain = L.to_device(L.ints_to_limbs([w % FR_MOD for w in witness]),
                          device)
    w_mont = FR.to_mont(w_plain)
    a_e, b_e, c_e = _abc_evals(_coo_on(coo, device), w_mont, m)
    z_coset = (pow(COSET_SHIFT, m, FR_MOD) - 1) % FR_MOD
    zinv_mont = FR.const_mont(pow(z_coset, FR_MOD - 2, FR_MOD), device)
    h_plain = _quotient_plain(a_e, b_e, c_e, zinv_mont)
    stage("evals_quotient")

    if glv:
        # four GLV MSMs over the full tables, each combined on the host
        # (prove.py:448-458); the scalars go to the host for the
        # decomposition
        tbl = _device_tables_glv(pk, device)
        w_np = w_plain.cpu().numpy().astype(np.uint32)
        h_np = h_plain[:m - 1].cpu().numpy().astype(np.uint32)
        g1_pts = [_g1_affine(msm_glv(tbl[t], sc, c=c, tree=tree))
                  for t, sc in (("a", w_np), ("b1", w_np),
                                ("c", w_np[pk.n_public:]), ("h", h_np))]
    else:
        pack = _device_pack_g1(pk, device)
        sc_cat = _scalars_cat(w_plain, h_plain, pack)
        wsum1, c1 = msm.multi_window_sums(G1, pack["points"], sc_cat, c,
                                          pack["bounds"], distinct=True)
        wsum1 = _to_host_standard(G1, wsum1)
    stage("msm_g1")

    g2p = _device_pack_g2(pk, device)
    sc2 = _segsum_scalars(w_plain.index_select(0, g2p["idx"]), g2p["seg"],
                          g2p["n_seg"])
    wsum2, c2 = msm.window_sums(G2, g2p["points"], sc2, c=min(c, 12),
                                distinct=True, tree=tree)
    wsum2 = _to_host_standard(G2, wsum2)
    stage("msm_g2")

    if not glv:
        g1_pts = combine_multi_window_sums_host(wsum1, c1)
    pi_a, pi_b1, pi_c, pi_h = g1_pts
    pi_b = combine_window_sums_host_g2(wsum2, c2)
    proof = _blind_combine(pk, pi_a, pi_b, pi_b1, pi_c, pi_h, r, s)
    stage("combine")
    return proof


def prove_host(pk: ProvingKey, r1cs, witness: List[int],
               r: Optional[int] = None, s: Optional[int] = None) -> Proof:
    """The same proof on the native C++ engine (zkrollup's host backend):
    COO quotient and five Pippenger MSMs on the CPU."""
    r, s = _check_rs(pk, r1cs, r, s)
    if not engine.available():
        raise RuntimeError("prove_host needs the native engine")
    coo = to_coo(r1cs)
    m = coo.m
    w_bytes = engine.ints_to_fr_bytes([w % FR_MOD for w in witness])
    h_bytes = engine.groth16_quotient(coo, w_bytes, pk.n_vars, m)
    tbl = pk.__dict__.get("_torch_host_tables")
    if tbl is None:
        tbl = {"a": engine.pack_g1_table_mont(pk.a_g1),
               "b1": engine.pack_g1_table_mont(pk.b1_g1),
               "c": engine.pack_g1_table_mont(pk.c_g1),
               "h": engine.pack_g1_table_mont(pk.h_g1),
               "b2": engine.pack_g2_table_mont(pk.b2_g2)}
        pk.__dict__["_torch_host_tables"] = tbl
    nv, npub = pk.n_vars, pk.n_public
    pi_a = engine.g1_msm_pip(tbl["a"], w_bytes, nv)
    pi_b1 = engine.g1_msm_pip(tbl["b1"], w_bytes, nv)
    pi_c = engine.g1_msm_pip(tbl["c"], w_bytes[32 * npub:], nv - npub)
    pi_h = engine.g1_msm_pip(tbl["h"], h_bytes[:32 * (m - 1)], m - 1)
    pi_b = engine.g2_msm_pip(tbl["b2"], w_bytes, nv)
    return _blind_combine(pk, pi_a, pi_b, pi_b1, pi_c, pi_h, r, s)
