"""Jacobian point kernels: CUDA kernel wrappers + plain versions, for G1
(over Fq) and G2 (over Fq2).

Counterpart of zkrollup/curve/pallas_curve.py (g1_add, g1_add_nd,
g1_add_z01, g1_madd_nd, g1_madd, g1_double) and
zkrollup/curve/pallas_curve_g2.py (g2_add, g2_add_nd, g2_madd_nd, g2_madd,
g2_double; g2_add_z01 replaces the Fq2 XLA glue of
weierstrass.py:_add_z01_generic), and of the device Horner of
zkrollup/msm/msm.py:msm (horner: g1_horner, g2_horner, one launch where
the reference loops over the double and add kernels). The kernels are the
jac_add / jac_add_nd / jac_add_z01 / jac_madd_nd / jac_madd / jac_double /
horner lanes of csrc/curve.cuh, built by csrc/points.cuh, g1.cu and g2.cu
over Fq and Fq2. The
plain versions follow the Pallas kernels formula for formula and select
for select, so the kernels and the plain versions agree bit for bit,
including the Jacobian representative and the Z-only zeroing on P + (-P).
A wrapper takes its plain version only when every operand lies on the CPU;
on a CUDA device it launches its kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from .. import kernels


# -- plain versions ------------------------------------------------------------

def _dbl_xy(F, X, Y):
    """X3, Y3 of dbl-2007-bl for a = 0 (pallas_curve.py:_k_double_point)."""
    A = F.sqr(X)
    B = F.sqr(Y)
    C = F.sqr(B)
    t = F.sqr(F.add(X, B))
    D = F.add(*[F.sub(F.sub(t, A), C)] * 2)
    E = F.add(F.add(A, A), A)
    FF = F.sqr(E)
    X3 = F.sub(FF, F.add(D, D))
    C8 = F.add(*[F.add(*[F.add(C, C)] * 2)] * 2)
    Y3 = F.sub(F.mul(E, F.sub(D, X3)), C8)
    return X3, Y3


def _add_xy(F, H, R, U1, S1):
    """The tail every add shares (csrc/curve.cuh:add_xy): X3 = R^2 - H^3 -
    2 U1 H^2, Y3 = R (U1 H^2 - X3) - S1 H^3."""
    HH = F.sqr(H)
    HHH = F.mul(H, HH)
    V = F.mul(U1, HH)
    X3 = F.sub(F.sub(F.sqr(R), HHH), F.add(V, V))
    Y3 = F.sub(F.mul(R, F.sub(V, X3)), F.mul(S1, HHH))
    return X3, Y3


def _add_path(F, p, q):
    """The add-2007-bl add path of p + q, both Jacobian: ((X3, Y3, Z3), H,
    R). Shared by the unified add and the add without the doubling path."""
    X1, Y1, Z1 = p
    X2, Y2, Z2 = q
    Z1Z1 = F.sqr(Z1)
    Z2Z2 = F.sqr(Z2)
    U1 = F.mul(X1, Z2Z2)
    U2 = F.mul(X2, Z1Z1)
    S1 = F.mul(F.mul(Y1, Z2), Z2Z2)
    S2 = F.mul(F.mul(Y2, Z1), Z1Z1)
    H = F.sub(U2, U1)
    R = F.sub(S2, S1)
    X3, Y3 = _add_xy(F, H, R, U1, S1)
    return (X3, Y3, F.mul(F.mul(Z1, Z2), H)), H, R


def _inf_selects(curve, out, to_inf, p, q):
    """The selects every add ends with (csrc/curve.cuh:inf_selects): Z
    zeroed where to_inf (P + (-P)), then q where p is infinity, then p
    where q is infinity."""
    F = curve.F
    out = (out[0], out[1], F.select(to_inf, F.zeros((), _device(out[2])),
                                    out[2]))
    out = curve.select(F.is_zero(p[2]), q, out)
    return curve.select(F.is_zero(q[2]), p, out)


def madd_add_path(F, p, q):
    """The madd-2007-bl add path of p (Jacobian) + (x2, y2) taken with
    Z2 = 1: ((X3, Y3, Z3), H, R). H = R = 0 when p == q; H = 0, R != 0
    when p == -q. Shared by both mixed adds."""
    X1, Y1, Z1 = p
    x2, y2 = q[0], q[1]
    Z1Z1 = F.sqr(Z1)
    U2 = F.mul(x2, Z1Z1)
    S2 = F.mul(F.mul(y2, Z1), Z1Z1)
    H = F.sub(U2, X1)
    R = F.sub(S2, Y1)
    X3, Y3 = _add_xy(F, H, R, X1, Y1)
    return (X3, Y3, F.mul(Z1, H)), H, R


def double_plain(curve, p):
    """dbl-2007-bl for a = 0 (pallas_curve.py:_double_kernel); Z3 = 2 Y Z,
    so infinity (Z = 0) stays infinity."""
    F = curve.F
    X, Y, Z = p
    X3, Y3 = _dbl_xy(F, X, Y)
    return (X3, Y3, F.mul(F.add(Y, Y), Z))


def add_plain(curve, p, q):
    """Unified Jacobian add (pallas_curve.py:_add_kernel): 12M+4S add path,
    dbl-2007-bl double path, infinity and P + (-P) masks."""
    F = curve.F
    out, H, R = _add_path(F, p, q)
    h_zero, r_zero = F.is_zero(H), F.is_zero(R)
    p_inf, q_inf = F.is_zero(p[2]), F.is_zero(q[2])
    out = curve.select(h_zero & r_zero, double_plain(curve, p), out)
    return _inf_selects(curve, out, h_zero & ~r_zero & ~p_inf & ~q_inf, p, q)


def add_nd_plain(curve, p, q):
    """Jacobian add without the doubling path (pallas_curve.py:
    _add_nd_kernel): where H = 0 with neither operand infinite the result
    is infinity (Z zeroed), so a P == Q lane gives that, not 2P."""
    F = curve.F
    out, H, _ = _add_path(F, p, q)
    to_inf = F.is_zero(H) & ~F.is_zero(p[2]) & ~F.is_zero(q[2])
    return _inf_selects(curve, out, to_inf, p, q)


def add_z01_plain(curve, p, q):
    """Unified add for p and q with Z in {0, 1} exactly (pallas_curve.py:
    _add_z01_kernel): 4M+2S add path with U1 = X1, S1 = Y1 and Z3 = H; the
    affine double of p with Z3 = 2 Y1 where H = R = 0; on P + (-P) only Z
    is zeroed."""
    F = curve.F
    X1, Y1 = p[0], p[1]
    H = F.sub(q[0], X1)
    R = F.sub(q[1], Y1)
    X3, Y3 = _add_xy(F, H, R, X1, Y1)
    h_zero, r_zero = F.is_zero(H), F.is_zero(R)
    p_inf, q_inf = F.is_zero(p[2]), F.is_zero(q[2])
    dX, dY = _dbl_xy(F, X1, Y1)
    out = curve.select(h_zero & r_zero, (dX, dY, F.add(Y1, Y1)), (X3, Y3, H))
    return _inf_selects(curve, out, h_zero & ~r_zero & ~p_inf & ~q_inf, p, q)


def madd_nd_plain(curve, p, q):
    """Mixed add without the doubling path
    (pallas_curve.py:_make_madd_kernel(True)); q has Z in {0, 1}."""
    F = curve.F
    out, H, _ = madd_add_path(F, p, q)
    to_inf = F.is_zero(H) & ~F.is_zero(p[2]) & ~F.is_zero(q[2])
    return _inf_selects(curve, out, to_inf, p, q)


def madd_plain(curve, p, q):
    """Mixed add WITH the doubling path (pallas_curve.py:
    _make_madd_kernel(False)); q has Z in {0, 1}. On P == Q the result is
    the affine double (mdbl) of q with Z = 2 y2, then the P + (-P) and
    infinity selects in the kernel's order."""
    F = curve.F
    out, H, R = madd_add_path(F, p, q)
    h_zero, r_zero = F.is_zero(H), F.is_zero(R)
    p_inf, q_inf = F.is_zero(p[2]), F.is_zero(q[2])
    dX, dY = _dbl_xy(F, q[0], q[1])
    out = curve.select(h_zero & r_zero, (dX, dY, F.add(q[1], q[1])), out)
    return _inf_selects(curve, out, h_zero & ~r_zero & ~p_inf & ~q_inf, p, q)


def horner_plain(curve, wsum, c: int):
    """The MSM's Horner combine (zkrollup/msm/msm.py:msm): over the window
    sums wsum (leaves (W, 16)), high to low, res = 2^c res + W_w as c
    double_plain and one add_plain a window on one point, from infinity.
    Returns one Jacobian point with (16,) leaves."""
    n_windows = curve.leaves(wsum)[0].shape[0]
    res = curve.infinity((1,), _device(wsum[2]))
    for w in range(n_windows - 1, -1, -1):
        for _ in range(c):
            res = double_plain(curve, res)
        res = add_plain(curve, res, curve.map(lambda a: a[w:w + 1], wsum))
    return curve.map(lambda a: a[0], res)


def _device(z):
    return (z[0] if isinstance(z, tuple) else z).device


# -- wrappers -------------------------------------------------------------------

def _launch_point(name: str, curve, *points):
    """Launch a point kernel over same-shape batches: the adds take (p, q),
    the double takes p; the result has p's shape."""
    ins = [t for pt in points for t in curve.leaves(pt)]
    shape = ins[0].shape
    for i, t in enumerate(ins):
        kernels.check_cuda(t, f"{name} input {i}")
        if t.shape != shape or t.device != ins[0].device:
            raise ValueError(f"{name}: every coordinate must share one shape "
                             f"and device, got {tuple(t.shape)} vs "
                             f"{tuple(shape)}")
    outs = [torch.empty_like(ins[0]) for _ in range(len(ins) // len(points))]
    n = ins[0].numel() // 16
    if n:
        in_arr = (ctypes.c_void_p * len(ins))(*[t.data_ptr() for t in ins])
        out_arr = (ctypes.c_void_p * len(outs))(*[t.data_ptr() for t in outs])
        kernels.launch(name, ins[0].device, ctypes.addressof(in_arr),
                       ctypes.addressof(out_arr), n, lanes=n)
    return curve.from_leaves(outs)


def _on_cpu(curve, *ps) -> bool:
    return all(t.device.type == "cpu" for p in ps for t in curve.leaves(p))


def add(curve, p, q):
    """Unified Jacobian add of same-shape point batches."""
    if _on_cpu(curve, p, q):
        return add_plain(curve, p, q)
    return _launch_point(f"{curve.name}_add", curve, p, q)


def add_nd(curve, p, q):
    """p + q for Jacobian batches that are never the same point."""
    if _on_cpu(curve, p, q):
        return add_nd_plain(curve, p, q)
    return _launch_point(f"{curve.name}_add_nd", curve, p, q)


def add_z01(curve, p, q):
    """p + q, every pair, for p and q with Z in {0, 1} exactly."""
    if _on_cpu(curve, p, q):
        return add_z01_plain(curve, p, q)
    return _launch_point(f"{curve.name}_add_z01", curve, p, q)


def madd_nd(curve, p, q):
    """p + q for q with Z in {0, 1}, p and q never the same point."""
    if _on_cpu(curve, p, q):
        return madd_nd_plain(curve, p, q)
    return _launch_point(f"{curve.name}_madd_nd", curve, p, q)


def madd(curve, p, q):
    """p + q for q with Z in {0, 1}: every pair, P == Q included."""
    if _on_cpu(curve, p, q):
        return madd_plain(curve, p, q)
    return _launch_point(f"{curve.name}_madd", curve, p, q)


def double(curve, p):
    """2p for a batch of Jacobian points; infinity stays infinity."""
    if _on_cpu(curve, p):
        return double_plain(curve, p)
    return _launch_point(f"{curve.name}_double", curve, p)


def horner(curve, wsum, c: int):
    """The MSM's Horner combine of window sums wsum (leaves (W, 16)),
    res = 2^c res + W_w from the top window down: on the card one launch
    of the g1_horner / g2_horner kernel, the Jacobian limbs of c double
    and one add launches a window. Returns one Jacobian point with (16,)
    leaves."""
    if c < 0:
        raise ValueError(f"horner: c={c} must be >= 0")
    if _on_cpu(curve, wsum):
        return horner_plain(curve, wsum, c)
    name = f"{curve.name}_horner"
    ins = curve.leaves(wsum)
    for i, t in enumerate(ins):
        kernels.check_cuda(t, f"{name} input {i}")
        if t.dim() != 2 or t.shape != ins[0].shape or \
                t.device != ins[0].device:
            raise ValueError(f"{name}: every coordinate must be one (W, 16) "
                             f"shape on one device, got {tuple(t.shape)} vs "
                             f"{tuple(ins[0].shape)}")
    outs = [torch.empty(16, dtype=t.dtype, device=t.device) for t in ins]
    in_arr = (ctypes.c_void_p * len(ins))(*[t.data_ptr() for t in ins])
    out_arr = (ctypes.c_void_p * len(outs))(*[t.data_ptr() for t in outs])
    kernels.launch(name, ins[0].device, ctypes.addressof(in_arr),
                   ctypes.addressof(out_arr), ins[0].shape[0], c, lanes=1)
    return curve.from_leaves(outs)
