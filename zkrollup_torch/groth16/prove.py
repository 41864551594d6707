"""Groth16 prover on a torch device.

Counterpart of the device branch of zkrollup/groth16/prove.py:prove:

  1. witness mod r -> canonical limbs in one native pass on the host
     (fields/limbs.py encode_fr, native/limbs.c), staged through pinned
     memory to the device, then Montgomery limbs (mont_mul kernel)
  2. sparse A/B/C evaluation over the domain: one Montgomery product per
     term with the witness gathered by the kernel, per-limb int64
     index_add_ into the rows, the fold mod r (fold kernel)
  3. quotient h = (A*B - C)/Z on the coset g*H: one batched iNTT of A, B,
     C with the coset shift in its last pass, one batched NTT, one coset
     iNTT with the pointwise step in its first pass (ntt_pass kernel, two
     passes a transform)
  4. per-table scalars, duplicate key points merged (_filt_dedup), the
     merged sums folded mod r (fold kernel)
  5. one fused 4-table G1 MSM (chunked scan, g1_madd_nd / g1_add kernels);
     with glv=True instead four GLV MSMs over the full a, b1, c and h
     tables (msm/glv.py:msm_glv), each with the host Horner combine
  6. one G2 MSM over the deduplicated b2 table (g2_madd_nd / g2_add with
     the default tree="scan"), enqueued before the host waits for the G1
     window sums, so that the card runs it while the host combines G1
  7. window sums to standard form on the device (mont_mul over Fq), one
     copy to the host each, Horner combine and blinding there

`tree` picks the bucket strategy of every single-table window sum (msm.py:
TREES): the G2 MSM, and with glv=True the four G1 MSMs. The fused G1 MSM
of the default path stays on the chunked scan, as in the reference. The
reference selects both with ZKROLLUP_PROVE_GLV and ZKROLLUP_MSM_TREE at
import; the port takes them as arguments.

g2_backend="host" runs step 6 on the native engine instead
(engine.g2_msm_pip over the b2 table, ZKROLLUP_G2_BACKEND=host in the
reference), called after the G1 MSM is enqueued, so that the host's
Pippenger overlaps the card's G1 work; the proof bytes are the same.

mesh= runs the quotient and the five MSMs sharded over a dist/mesh.py
Mesh (the reference's _prove_distributed): the A/B/C evaluations split
cyclically, the four-step sharded quotient, every key table padded to one
size divisible by the mesh and split into blocks, each block's window sums
on its shard, the shards' window sums folded, then the host combine as
above; table_groups > 1 deals the tables to disjoint groups of the mesh,
each on its own CUDA streams. The same bytes again.

Every proof is the span groth16.prove (spans.py); the stages of the
single-device path are spans under it: groth16.encode (step 1, with
groth16.encode.fallback under it where some entry of the witness is no
int in [0, r)), groth16.spmv_abc (2), groth16.quotient (3),
groth16.msm_g1 (5), groth16.msm_g2 (6), groth16.copy_wait (7: the host
waiting for each copy), groth16.combine_g1 and groth16.combine_g2 (the
Horner combines) and groth16.blind. The four device stages keep the
reference's jax.named_scope names.

prove_host mirrors the reference's host path (zkrollup/groth16/prove.py:
_prove_host) on the native engine; it is the independent check the device
proof is held against.
"""

from __future__ import annotations

import secrets
import threading
import time
from typing import List, Optional

import numpy as np
import torch

from ..native import engine
from ..ref import bn254 as ref
from ..ref.bn254 import R as FR_MOD
from ..fields.mont import FR, FQ
from ..fields import cuda_mont, limbs as L
from ..ntt import ntt
from ..ntt.ntt import COSET_SHIFT
from ..curve import g1 as g1_mod
from ..curve.g1 import G1
from ..curve.g2 import G2
from ..dist import mesh as dmesh
from ..msm import msm
from ..msm.glv import (combine_multi_window_sums_host,
                       combine_window_sums_host_g2, msm_glv)
from ..spans import span
from .keys import ProvingKey, Proof
from .qap import to_coo


class _Staging:
    """A pinned host buffer for the witness rows of one length on one CUDA
    device, the event recorded behind its last copy to the device, and a
    lock held from its write to that event's record."""

    def __init__(self, n: int):
        self.host = torch.empty((n, L.N_LIMBS), dtype=L.DTYPE,
                                pin_memory=True)
        self.copied: Optional[torch.cuda.Event] = None
        self.lock = threading.Lock()


def _encode_witness(pk: ProvingKey, witness, device) -> torch.Tensor:
    """The witness mod r as canonical limb rows on `device` (L.encode_fr),
    encoded afresh on every call. On a CPU device into the result itself;
    on a CUDA device into a pinned staging buffer kept on the key for the
    device and the witness length, then copied without blocking. The next
    write to that buffer first waits for the copy's event."""
    xs = witness if isinstance(witness, list) else list(witness)
    shape = (len(xs), L.N_LIMBS)
    if device.type != "cuda":
        out = torch.empty(shape, dtype=L.DTYPE)
        L.encode_fr(xs, out)
        return out
    cache = pk.__dict__.setdefault("_torch_staging", {})
    key = (str(device), len(xs))
    st = cache.get(key)
    if st is None:
        st = cache.setdefault(key, _Staging(len(xs)))
    with st.lock:
        if st.copied is not None:
            st.copied.synchronize()
        L.encode_fr(xs, st.host)
        w_plain = torch.empty(shape, dtype=L.DTYPE, device=device)
        w_plain.copy_(st.host, non_blocking=True)
        st.copied = torch.cuda.Event()
        st.copied.record(torch.cuda.current_stream(device))
    return w_plain


def _spmv(row, var, coeff_mont, w_mont, m: int) -> torch.Tensor:
    """eval[j] = sum_{k in row j} coeff_k * w[var_k] mod r (Montgomery)."""
    terms = FR.mont_mul(coeff_mont, w_mont, var)
    sums = torch.zeros((m, L.N_LIMBS), dtype=torch.int64,
                       device=terms.device)
    sums.index_add_(0, row, terms.to(torch.int64))
    return cuda_mont.fold(FR, sums)


def _abc_evals(coo_dev, w_mont, m: int):
    with span("groth16.spmv_abc"):
        return tuple(_spmv(row, var, coeff, w_mont, m)
                     for row, var, coeff in coo_dev)


def _quotient_plain(a_e, b_e, c_e, zinv_mont) -> torch.Tensor:
    """Domain evaluations (Montgomery) -> h coefficients in PLAIN form.
    Z(g*w^i) = g^m - 1 is constant on the coset. Three transforms of
    (A, B, C) at once: the iNTT with n^-1 g^i on each coefficient (its
    scaling and the coset shift in one product), the forward NTT, then one
    coset iNTT whose first pass forms (A*B - C) * Z^-1 from the three as
    it loads them and whose last multiplies by n^-1 g^-i in plain form
    (that product also leaves the Montgomery domain). The same h as the
    reference's intt / coset_ntt / pointwise / coset_intt / from_mont."""
    log_n = ntt._log2(a_e.shape[0])
    tab = lambda kind: ntt._TABLES.get(kind, log_n, a_e.device)
    with span("groth16.quotient"):
        abc = torch.stack([a_e, b_e, c_e]).to(L.DTYPE)
        coeffs = ntt.transform(abc, True, post=tab("ninv_coset"))
        ev = ntt.transform(coeffs)
        return ntt.transform(ev[0], True,
                             pointwise=(ev[1], ev[2], zinv_mont),
                             post=tab("ninv_coset_inv_plain"))


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
    return cuda_mont.fold(FR, sums)


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


def _to_host_standard(curve, wsum):
    """Window sums -> standard form on the device (ONE FQ.from_mont over
    every leaf's rows, stacked), then ONE device-to-host copy, on the
    stream without waiting for it on a CUDA device: into pinned host
    memory, with an event recorded behind it. Returns a function that
    waits for that event alone (the span groth16.copy_wait) and gives the
    point with numpy leaves."""
    leaves = FQ.from_mont(torch.stack(curve.leaves(wsum)))
    host, done = leaves, None
    if leaves.device.type == "cuda":
        host = torch.empty(leaves.shape, dtype=leaves.dtype,
                           pin_memory=True)
        host.copy_(leaves, non_blocking=True)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(leaves.device))

    def wait():
        with span("groth16.copy_wait"):
            if done is not None:
                done.synchronize()
        return curve.from_leaves(list(host.numpy()))
    return wait


def _blind_combine(pk: ProvingKey, pi_a_msm, pi_b_msm, pi_b1_msm, pi_c_msm,
                   pi_h_msm, r: int, s: int) -> Proof:
    """Blinding combine (host single-point ops, prove.py:_blind_combine),
    under the span groth16.blind."""
    g1a, g1m = ref.g1_add, ref.g1_mul
    with span("groth16.blind"):
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


G2_BACKENDS = ("device", "host")


def _host_b2(pk: ProvingKey):
    """The b2 table packed for the native engine, cached on the key."""
    tbl = pk.__dict__.get("_torch_host_b2")
    if tbl is None:
        tbl = engine.pack_g2_table_mont(pk.b2_g2)
        pk.__dict__["_torch_host_b2"] = tbl
    return tbl


def _dist_tables(pk: ProvingKey, d: int, device="cpu"):
    """Every G1 key table and b2 padded to ONE size divisible by the mesh
    size d (infinity rows, whose zero scalars add nothing), on `device`:
    the sharded MSMs split each into d blocks (zkrollup/groth16/prove.py:
    _dist_tables). Cached on the key per (d, device)."""
    cache = pk.__dict__.setdefault("_torch_dist_tables", {})
    key = (d, str(torch.device(device)))
    if key in cache:
        return cache[key]
    # a multiple of d, also where d does not divide the domain
    pad_to = -(-max(pk.domain_size, pk.n_vars) // d) * d

    def limbs(a):
        return dmesh.pad_rows(L.to_device(np.asarray(a), device), pad_to)

    def inf(a):
        t = _dev(np.asarray(a, bool), device)
        return torch.cat([t, t.new_ones((pad_to - t.shape[0], 1))])

    def g1(tbl):
        x, y, i = tbl
        return (limbs(x), limbs(y), inf(i))

    (bx0, bx1), (by0, by1), binf = pk.b2_g2
    cache[key] = {
        "pad_to": pad_to, "a": g1(pk.a_g1), "b1": g1(pk.b1_g1),
        "c": g1(pk.c_g1), "h": g1(pk.h_g1),
        "b2": ((limbs(bx0), limbs(bx1)), (limbs(by0), limbs(by1)),
               inf(binf)),
    }
    return cache[key]


def _prove_distributed(pk: ProvingKey, coo, witness: List[int], r: int,
                       s: int, mesh, c: int, table_groups: int,
                       tree: str) -> Proof:
    """The quotient and the five MSMs sharded over `mesh`
    (dist/mesh.py:distributed_prove_core), the evaluations made on the
    mesh's first device and split cyclically, the blinding on the host
    (zkrollup/groth16/prove.py:_prove_distributed)."""
    d, device, m = mesh.size, mesh.devices[0], coo.m
    w_plain = L.to_device(L.ints_to_limbs(witness), device)
    a_e, b_e, c_e = _abc_evals(_coo_on(coo, device), FR.to_mont(w_plain), m)
    z_coset = (pow(COSET_SHIFT, m, FR_MOD) - 1) % FR_MOD
    zinv_mont = FR.const_mont(pow(z_coset, FR_MOD - 2, FR_MOD), device)
    tbl = _dist_tables(pk, d, device)
    w_sc = dmesh.pad_rows(w_plain, tbl["pad_to"])
    c_sc = dmesh.pad_rows(w_plain[pk.n_public:], tbl["pad_to"])
    _h, res = dmesh.distributed_prove_core(
        mesh, *(dmesh.cyclic_shard(e, d) for e in (a_e, b_e, c_e)),
        zinv_mont, m.bit_length() - 1,
        g1_tables={"a": (tbl["a"], w_sc), "b1": (tbl["b1"], w_sc),
                   "c": (tbl["c"], c_sc), "h": (tbl["h"], None)},
        g2_table=(tbl["b2"], w_sc), c=c, table_groups=table_groups,
        tree=tree)
    # the four G1 tables' window sums (one block size: one c) as one
    # (W, 4, 16) block, combined on the host as the single-device path does
    c1 = res["a"][1]
    wsum1 = G1.from_leaves([torch.stack(ls, 1) for ls in zip(
        *(G1.leaves(res[t][0]) for t in ("a", "b1", "c", "h")))])
    pi_a, pi_b1, pi_c, pi_h = combine_multi_window_sums_host(
        _to_host_standard(G1, wsum1)(), c1)
    wsum2, c2 = res["b2"]
    pi_b = combine_window_sums_host_g2(_to_host_standard(G2, wsum2)(), c2)
    return _blind_combine(pk, pi_a, pi_b, pi_b1, pi_c, pi_h, r, s)


def prove(pk: ProvingKey, r1cs, witness: List[int], r: Optional[int] = None,
          s: Optional[int] = None, *, device=None, c: int = 12,
          glv: bool = False, tree: str = "scan",
          timings: Optional[dict] = None, g2_backend: str = "device",
          mesh=None, table_groups: int = 1) -> Proof:
    """Groth16 proof of `witness` (full assignment, var 0 = 1) on `device`,
    or sharded over `mesh` (a dist.mesh.Mesh; then no device). r, s pin
    the blinding (same inputs, same key => same proof bytes). c is the
    Pippenger window; proofs do not depend on it, nor on glv (the GLV G1
    MSMs), tree (the bucket strategy, msm.TREES), g2_backend ("device", or
    "host": the G2 MSM on the native engine, which must be built) or
    table_groups (mesh only: the MSM tables on that many disjoint groups
    of the mesh). If `timings` is a dict, each stage synchronises the
    device and records its seconds (and the G2 MSM then no longer overlaps
    the host's G1 combine). The whole proof is the span groth16.prove."""
    with span("groth16.prove"):
        r, s = _check_rs(pk, r1cs, r, s)
        msm._check_tree(tree)
        if g2_backend not in G2_BACKENDS:
            raise ValueError(f"g2_backend={g2_backend!r}: must be one of "
                             f"{G2_BACKENDS}")
        if g2_backend == "host" and not engine.available():
            raise RuntimeError("g2_backend='host' needs the native engine")
        if (mesh is None) == (device is None):
            raise ValueError("prove: pass device= or mesh=, one of them")
        coo = to_coo(r1cs)
        if coo.m != pk.domain_size:
            raise ValueError("key/domain mismatch")
        if mesh is not None:
            if glv or timings is not None or g2_backend != "device":
                raise ValueError("prove(mesh=) takes no glv, timings or "
                                 "g2_backend")
            return _prove_distributed(pk, coo, [w % FR_MOD for w in witness],
                                      r, s, mesh, c, table_groups, tree)
        if table_groups != 1:
            raise ValueError("table_groups needs mesh=")
        return _prove_single(pk, coo, witness, r, s, torch.device(device), c,
                             glv, tree, timings, g2_backend)


def _prove_single(pk: ProvingKey, coo, witness: List[int], r: int, s: int,
                  device, c: int, glv: bool, tree: str,
                  timings: Optional[dict], g2_backend: str) -> Proof:
    """prove() on one device. Its host work is in the spans
    groth16.encode (the witness to Montgomery limbs on the device;
    groth16.encode.fallback under it for the entries reduced in Python),
    groth16.copy_wait (the host waiting for each window-sum copy),
    groth16.combine_g1 / combine_g2 (the Horner combines) and
    groth16.blind; its device stages under the labels groth16.spmv_abc,
    groth16.quotient, groth16.msm_g1 and groth16.msm_g2."""
    m = coo.m
    clock = [time.perf_counter()]

    def stage(name):
        if timings is not None:
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            now = time.perf_counter()
            timings[name] = now - clock[0]
            clock[0] = now

    with span("groth16.encode"):
        w_plain = _encode_witness(pk, witness, device)
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
        with span("groth16.msm_g1"):
            wsum1, c1 = msm.multi_window_sums(G1, pack["points"], sc_cat, c,
                                              pack["bounds"], distinct=True)
        wsum1_host = _to_host_standard(G1, wsum1)
    stage("msm_g1")

    if g2_backend == "host":
        # the native engine's Pippenger runs here, while the card works
        # through the G1 MSM enqueued above (zkrollup/groth16/prove.py:
        # 495-500)
        pi_b = engine.g2_msm_pip(
            _host_b2(pk), engine.ints_to_fr_bytes(
                [w % FR_MOD for w in witness]), pk.n_vars)
    else:
        # the G2 MSM is enqueued before the host waits for the G1 window
        # sums (zkrollup/groth16/prove.py:460-486): without timings the
        # card runs it while the host combines G1
        g2p = _device_pack_g2(pk, device)
        sc2 = _segsum_scalars(w_plain.index_select(0, g2p["idx"]),
                              g2p["seg"], g2p["n_seg"])
        with span("groth16.msm_g2"):
            wsum2, c2 = msm.window_sums(G2, g2p["points"], sc2,
                                        c=min(c, 12), distinct=True,
                                        tree=tree)
        wsum2_host = _to_host_standard(G2, wsum2)
    stage("msm_g2")

    if not glv:
        wsum1 = wsum1_host()
        with span("groth16.combine_g1"):
            g1_pts = combine_multi_window_sums_host(wsum1, c1)
    pi_a, pi_b1, pi_c, pi_h = g1_pts
    if g2_backend != "host":
        wsum2 = wsum2_host()
        with span("groth16.combine_g2"):
            pi_b = combine_window_sums_host_g2(wsum2, c2)
    proof = _blind_combine(pk, pi_a, pi_b, pi_b1, pi_c, pi_h, r, s)
    stage("combine")
    return proof


def prove_host(pk: ProvingKey, r1cs, witness: List[int],
               r: Optional[int] = None, s: Optional[int] = None) -> Proof:
    """The same proof on the native C++ engine (zkrollup's host backend):
    COO quotient and five Pippenger MSMs on the CPU. The whole proof is
    the span groth16.prove, as prove()'s."""
    with span("groth16.prove"):
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
                   "h": engine.pack_g1_table_mont(pk.h_g1)}
            pk.__dict__["_torch_host_tables"] = tbl
        nv, npub = pk.n_vars, pk.n_public
        pi_a = engine.g1_msm_pip(tbl["a"], w_bytes, nv)
        pi_b1 = engine.g1_msm_pip(tbl["b1"], w_bytes, nv)
        pi_c = engine.g1_msm_pip(tbl["c"], w_bytes[32 * npub:], nv - npub)
        pi_h = engine.g1_msm_pip(tbl["h"], h_bytes[:32 * (m - 1)], m - 1)
        pi_b = engine.g2_msm_pip(_host_b2(pk), w_bytes, nv)
        return _blind_combine(pk, pi_a, pi_b, pi_b1, pi_c, pi_h, r, s)
