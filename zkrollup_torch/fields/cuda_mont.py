"""Montgomery multiply and NTT butterfly: CUDA kernel wrappers + plain versions.

Counterpart of zkrollup/fields/pallas_mont.py. The kernels are
csrc/fields.cu (mont_mul_kernel<Fr|Fq>, butterfly_kernel), built and
launched through zkrollup_torch.kernels. A wrapper runs its plain PyTorch
version when its tensors lie on the CPU, and launches its kernel (or raises)
when they lie on a CUDA device.
"""

from __future__ import annotations

import torch

from .. import kernels
from . import limbs as L
from .limbs import N_LIMBS, MASK, LIMB_BITS


# -- plain versions ------------------------------------------------------------

def mont_mul_plain(field, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """CIOS over 16-bit limbs in int64 (pallas_mont.py:_make_kernel): per
    round add a_i*b and m*p into a lazy accumulator and push limb i's carry;
    then canonical limbs and one conditional subtraction of p."""
    a, b = torch.broadcast_tensors(a.to(torch.int64), b.to(torch.int64))
    shape = a.shape
    a2 = a.reshape(-1, N_LIMBS)
    b2 = b.reshape(-1, N_LIMBS)
    mod = field.mod_limbs(a.device).to(torch.int64)
    # round i works on columns [i, i + 16]; the result is columns 16..32
    t = torch.zeros((a2.shape[0], 2 * N_LIMBS + 1), dtype=torch.int64,
                    device=a.device)
    for i in range(N_LIMBS):
        t[:, i:i + N_LIMBS] += a2[:, i:i + 1] * b2
        m = (t[:, i] * field.n0inv) & MASK
        t[:, i:i + N_LIMBS] += m[:, None] * mod
        t[:, i + 1] += t[:, i] >> LIMB_BITS
    u, _ = L.normalize(t[:, N_LIMBS:])                  # < 2p
    d, borrow = L.sub_with_borrow(u, torch.cat([mod, mod.new_zeros(1)]))
    out = L.select(borrow == 0, d, u)[:, :N_LIMBS]
    return out.to(L.DTYPE).reshape(shape)


def butterfly_plain(field, u, b, t):
    """(u + b*t, u - b*t) mod p over rows of (n, 16) limbs."""
    v = mont_mul_plain(field, b, t)
    return field.add(u, v), field.sub(u, v)


def ntt_stage_plain_(field, x: torch.Tensor, tw: torch.Tensor, m: int) -> None:
    """Plain version of ntt_stage_, in place on x (n, 16)."""
    n = x.shape[0]
    grp = x.view(n // (2 * m), 2, m, N_LIMBS)
    u = grp[:, 0].reshape(n // 2, N_LIMBS)
    b = grp[:, 1].reshape(n // 2, N_LIMBS)
    twf = tw[None].expand(n // (2 * m), m, N_LIMBS).reshape(n // 2, N_LIMBS)
    hi, lo = butterfly_plain(field, u, b, twf)
    grp[:, 0] = hi.view(n // (2 * m), m, N_LIMBS)
    grp[:, 1] = lo.view(n // (2 * m), m, N_LIMBS)


# -- wrappers -------------------------------------------------------------------

def mont_mul(field, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a*b*2^-256 mod p. On CUDA: a (..., 16) and b of a's shape or one
    (16,) element broadcast over a, both contiguous int32."""
    if a.device.type == "cpu" and b.device.type == "cpu":
        return mont_mul_plain(field, a, b)
    kernels.check_cuda(a, "mont_mul a")
    kernels.check_cuda(b, "mont_mul b")
    if b.shape == a.shape:
        bcast = 0
    elif b.numel() == N_LIMBS:
        bcast = 1
    else:
        raise ValueError(f"mont_mul: b {tuple(b.shape)} is neither a's shape "
                         f"{tuple(a.shape)} nor one element")
    if b.device != a.device:
        raise ValueError("mont_mul: operands on different devices")
    out = torch.empty_like(a)
    kernels.launch(f"mont_mul[{field.name}]", a.device, a.data_ptr(),
                   b.data_ptr(), bcast, out.data_ptr(), a.numel() // N_LIMBS)
    return out


def ntt_stage_(field, x: torch.Tensor, tw: torch.Tensor, m: int) -> None:
    """One radix-2 stage IN PLACE on x (n, 16) of canonical Fr limbs: for
    each group of 2m rows, (x[j], x[j+m]) <- (x[j] + tw[j]*x[j+m],
    x[j] - tw[j]*x[j+m]), tw (m, 16). A CUDA x takes the butterfly kernel;
    a CPU x the plain version."""
    if field.name != "fr":
        raise ValueError("butterfly is an Fr kernel")
    n = x.shape[0]
    if x.device.type == "cpu" and tw.device.type == "cpu":
        return ntt_stage_plain_(field, x, tw, m)
    kernels.check_cuda(x, "ntt x")
    kernels.check_cuda(tw, "ntt twiddles")
    if x.dim() != 2 or tw.shape != (m, N_LIMBS) or n % (2 * m):
        raise ValueError("ntt stage: bad twiddle table or group size")
    if tw.device != x.device:
        raise ValueError("ntt stage: x and twiddles on different devices")
    kernels.launch("butterfly", x.device, x.data_ptr(), tw.data_ptr(),
                   n // 2, m)
