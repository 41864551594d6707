"""Jacobian point add and no-double mixed add: CUDA kernel wrappers + plain
versions, for G1 (over Fq) and G2 (over Fq2).

Counterpart of zkrollup/curve/pallas_curve.py (g1_add, g1_madd_nd) and
zkrollup/curve/pallas_curve_g2.py (g2_add, g2_madd_nd). The kernels are the
jac_add / jac_madd_nd templates of csrc/curve.cuh, instantiated over Fq and
Fq2. The plain versions follow the Pallas kernels formula for formula, so
the kernels and the plain versions agree bit for bit, including the
Jacobian representative and the Z-only zeroing on P + (-P).
"""

from __future__ import annotations

import ctypes

import torch

from .. import kernels


# -- plain versions ------------------------------------------------------------

def add_plain(curve, p, q):
    """Unified Jacobian add (pallas_curve.py:_add_kernel): 12M+4S add path,
    dbl-2007-bl double path, infinity and P + (-P) masks."""
    F = curve.F
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
    HH = F.sqr(H)
    HHH = F.mul(H, HH)
    V = F.mul(U1, HH)
    X3 = F.sub(F.sub(F.sqr(R), HHH), F.add(V, V))
    Y3 = F.sub(F.mul(R, F.sub(V, X3)), F.mul(S1, HHH))
    Z3 = F.mul(F.mul(Z1, Z2), H)

    h_zero, r_zero = F.is_zero(H), F.is_zero(R)
    p_inf, q_inf = F.is_zero(Z1), F.is_zero(Z2)
    out = curve.select(h_zero & r_zero, curve.double(p), (X3, Y3, Z3))
    to_inf = h_zero & ~r_zero & ~p_inf & ~q_inf
    out = (out[0], out[1], F.select(to_inf, F.zeros((), _device(Z3)),
                                    out[2]))
    out = curve.select(p_inf, q, out)
    return curve.select(q_inf, p, out)


def madd_nd_plain(curve, p, q):
    """Mixed add without the doubling path
    (pallas_curve.py:_make_madd_kernel(True)); q has Z in {0, 1}."""
    F = curve.F
    X1, Y1, Z1 = p
    x2, y2, Z2 = q
    Z1Z1 = F.sqr(Z1)
    U2 = F.mul(x2, Z1Z1)
    S2 = F.mul(F.mul(y2, Z1), Z1Z1)
    H = F.sub(U2, X1)
    R = F.sub(S2, Y1)
    HH = F.sqr(H)
    HHH = F.mul(H, HH)
    V = F.mul(X1, HH)
    X3 = F.sub(F.sub(F.sqr(R), HHH), F.add(V, V))
    Y3 = F.sub(F.mul(R, F.sub(V, X3)), F.mul(Y1, HHH))
    Z3 = F.mul(Z1, H)

    p_inf, q_inf = F.is_zero(Z1), F.is_zero(Z2)
    to_inf = F.is_zero(H) & ~p_inf & ~q_inf
    out = (X3, Y3, F.select(to_inf, F.zeros((), _device(Z3)), Z3))
    out = curve.select(p_inf, q, out)
    return curve.select(q_inf, p, out)


def madd_plain(curve, p, q):
    """Mixed add WITH the doubling path (the generic weierstrass.mixed_add
    shape; the g1_madd / g2_madd kernels are not ported yet). CPU only."""
    F = curve.F
    X1, Y1, Z1 = p
    x2, y2, Z2 = q
    Z1Z1 = F.sqr(Z1)
    U2 = F.mul(x2, Z1Z1)
    S2 = F.mul(F.mul(y2, Z1), Z1Z1)
    H = F.sub(U2, X1)
    R = F.sub(S2, Y1)
    HH = F.sqr(H)
    HHH = F.mul(H, HH)
    V = F.mul(X1, HH)
    X3 = F.sub(F.sub(F.sqr(R), HHH), F.add(V, V))
    Y3 = F.sub(F.mul(R, F.sub(V, X3)), F.mul(Y1, HHH))
    Z3 = F.mul(Z1, H)
    h_zero, r_zero = F.is_zero(H), F.is_zero(R)
    p_inf, q_inf = F.is_zero(Z1), F.is_zero(Z2)
    out = curve.select(h_zero & r_zero, curve.double(p), (X3, Y3, Z3))
    dev = _device(Z3)
    inf = curve.infinity((), dev)
    out = curve.select(h_zero & ~r_zero & ~p_inf, inf, out)
    out = curve.select(p_inf, (x2, y2, F.one((), dev)), out)
    return curve.select(q_inf, p, out)


def _device(z):
    return (z[0] if isinstance(z, tuple) else z).device


# -- wrappers -------------------------------------------------------------------

def _launch_point(name: str, curve, p, q):
    ins = curve.leaves(p) + curve.leaves(q)
    shape = ins[0].shape
    for i, t in enumerate(ins):
        kernels.check_cuda(t, f"{name} input {i}")
        if t.shape != shape or t.device != ins[0].device:
            raise ValueError(f"{name}: every coordinate must share one shape "
                             f"and device, got {tuple(t.shape)} vs "
                             f"{tuple(shape)}")
    outs = [torch.empty_like(ins[0]) for _ in range(len(ins) // 2)]
    n = ins[0].numel() // 16
    if n:
        in_arr = (ctypes.c_void_p * len(ins))(*[t.data_ptr() for t in ins])
        out_arr = (ctypes.c_void_p * len(outs))(*[t.data_ptr() for t in outs])
        kernels.launch(name, ins[0].device, ctypes.addressof(in_arr),
                       ctypes.addressof(out_arr), n)
    return curve.from_leaves(outs)


def _on_cpu(curve, *ps) -> bool:
    return all(t.device.type == "cpu" for p in ps for t in curve.leaves(p))


def add(curve, p, q):
    """Unified Jacobian add of same-shape point batches."""
    if _on_cpu(curve, p, q):
        return add_plain(curve, p, q)
    return _launch_point(f"{curve.name}_add", curve, p, q)


def madd_nd(curve, p, q):
    """p + q for q with Z in {0, 1}, p and q never the same point."""
    if _on_cpu(curve, p, q):
        return madd_nd_plain(curve, p, q)
    return _launch_point(f"{curve.name}_madd_nd", curve, p, q)
