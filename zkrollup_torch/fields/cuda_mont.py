"""Montgomery multiply, NTT passes, the lazy-sum fold, the Fq and Fq2
inversion and the field add and sub: CUDA kernel wrappers + plain versions.

Counterpart of zkrollup/fields/pallas_mont.py, and of the Fermat inversion
and the carry chains of add and sub of zkrollup/fields/mont.py and fq2.py
(no Pallas kernel). The kernels are csrc/fields.cu (mont_mul_kernel<Fr|Fq>,
ntt_pass_kernel, fold_fr_kernel, inv_kernel<Fq|Fq2>, add_kernel<Fr|Fq>,
sub_kernel<Fr|Fq>), built and launched through zkrollup_torch.kernels. A
wrapper runs its plain PyTorch version when its tensors lie on the CPU,
and launches its kernel (or raises) when they lie on a CUDA device.
"""

from __future__ import annotations

import functools

import torch

from .. import kernels
from . import limbs as L
from .limbs import N_LIMBS, MASK, LIMB_BITS


# -- plain versions ------------------------------------------------------------

def add_plain(field, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a + b) mod p: normalise a + b and a + b - p together and keep the
    difference unless it borrowed. Any int64 limbs whose value a + b lies
    in [0, 2p); on canonical operands the add kernel's result."""
    s = a.to(torch.int64) + b.to(torch.int64)
    both, carry = L.normalize(torch.stack([s, s - field.mod_limbs(s.device)]))
    return L.select((carry[1] < 0)[..., None], both[0], both[1]).to(L.DTYPE)


def sub_plain(field, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a - b) mod p: normalise a - b and a - b + p together and keep the
    sum where the difference borrowed. Any int64 limbs whose value a - b
    lies in [-p, p); on canonical operands the sub kernel's result."""
    d = a.to(torch.int64) - b.to(torch.int64)
    both, carry = L.normalize(torch.stack([d, d + field.mod_limbs(d.device)]))
    return L.select((carry[0] < 0)[..., None], both[1], both[0]).to(L.DTYPE)


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


def mont_mul_gather_plain(field, a: torch.Tensor, b: torch.Tensor,
                          idx: torch.Tensor) -> torch.Tensor:
    """mont_mul(a, b[idx])."""
    return mont_mul_plain(field, a, b.index_select(0, idx))


def fold_plain(field, sums: torch.Tensor) -> torch.Tensor:
    """(n, 16) lazy int64 limb sums V (< 2^288) -> V mod p, as int32 limbs.
    V = lo + hi*2^256, so V mod p = mont(lo, R) + mont(hi, R^2): the
    result is in the same (plain or Montgomery) form as the summands."""
    n, dev = sums.shape[0], sums.device
    ext = L.propagate_carries(torch.cat(
        [sums, torch.zeros((n, 2), dtype=torch.int64, device=dev)], 1))
    lo = ext[:, :N_LIMBS].to(L.DTYPE).contiguous()
    hi = torch.cat([ext[:, N_LIMBS:],
                    torch.zeros((n, N_LIMBS - 2), dtype=torch.int64,
                                device=dev)], 1).to(L.DTYPE)
    return add_plain(field, mont_mul_plain(field, lo, field.one_mont(dev)),
                     mont_mul_plain(field, hi, field.r2_limbs(dev)))


def butterfly_plain(field, u, b, t):
    """(u + b*t, u - b*t) mod p over rows of (n, 16) limbs."""
    v = mont_mul_plain(field, b, t)
    return add_plain(field, u, v), sub_plain(field, u, v)


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


def ntt_pass_plain(field, x: torch.Tensor, tw: torch.Tensor, s0: int,
                   k: int, *, out=None, bitrev: bool = False, pre=None,
                   post=None, pointwise=None,
                   tw_origin: int = 0) -> torch.Tensor:
    """Plain version of ntt_pass: the prologue (pointwise, then pre) on
    every input row, the bit-reversal gather, stages s0 .. s0 + k - 1 of
    ntt_stage_plain_ on each transform of the batch, then post."""
    n = x.shape[-2]
    y = x.reshape(-1, n, N_LIMBS)
    if pointwise is not None:
        b, c, z = pointwise
        y = mont_mul_plain(field, sub_plain(field, mont_mul_plain(
            field, y, b.reshape(y.shape)), c.reshape(y.shape)), z)
    if pre is not None:
        y = mont_mul_plain(field, y, pre)
    if bitrev:
        from ..ntt.ntt import bit_rev_perm     # ntt imports this module
        y = y[:, torch.from_numpy(bit_rev_perm(n.bit_length() - 1)).to(
            y.device)]
    y = y.to(L.DTYPE).clone()
    for s in range(s0, s0 + k):
        m = 1 << s
        for t in y:
            ntt_stage_plain_(field, t, tw[m - tw_origin:2 * m - tw_origin], m)
    if post is not None:
        y = mont_mul_plain(field, y, post)
    y = y.reshape(x.shape)
    if out is None:
        return y
    out.copy_(y)
    return out


def inv_plain(field, a: torch.Tensor) -> torch.Tensor:
    """a^-1 of every row (Montgomery domain, 0 -> 0): Fermat, a^(p - 2)
    through field.mont_pow_const over the plain product."""
    return field.mont_pow_const(a, field.p - 2,
                                functools.partial(mont_mul_plain, field))


def inv_fq2_plain(field, a):
    """1/(a0 + a1 u) = (a0 n^-1, -(a1 n^-1)) with n = a0^2 + a1^2 (fq2.py:
    inv): one Fermat inversion of the norm, every product plain."""
    mul = functools.partial(mont_mul_plain, field)
    a0, a1 = a
    ninv = inv_plain(field, add_plain(field, mul(a0, a0), mul(a1, a1)))
    return (mul(a0, ninv), sub_plain(field, torch.zeros_like(a1),
                                     mul(a1, ninv)))


# -- wrappers -------------------------------------------------------------------

def _on_cpu(*ts) -> bool:
    return all(t.device.type == "cpu" for t in ts if t is not None)


def mont_mul(field, a: torch.Tensor, b: torch.Tensor,
             idx=None) -> torch.Tensor:
    """a*b*2^-256 mod p, or with `idx` a*b[idx]*2^-256 (b gathered by the
    int64 row index idx, one per row of a, without forming b[idx]). On
    CUDA: a (..., 16) and b of a's shape or one (16,) element broadcast
    over a, or with idx b (m, 16) and idx (rows of a,); contiguous int32
    limbs and a contiguous int64 index."""
    if _on_cpu(a, b, idx):
        if idx is not None:
            return mont_mul_gather_plain(field, a, b, idx)
        return mont_mul_plain(field, a, b)
    kernels.check_cuda(a, "mont_mul a")
    kernels.check_cuda(b, "mont_mul b")
    n = a.numel() // N_LIMBS
    if idx is not None:
        if (idx.dtype != torch.int64 or idx.shape != (n,)
                or not idx.is_contiguous() or b.dim() != 2):
            raise ValueError("mont_mul: idx must be a contiguous int64 "
                             "vector, one row of (m, 16) b per row of a")
        bcast = 0
    elif b.shape == a.shape:
        bcast = 0
    elif b.numel() == N_LIMBS:
        bcast = 1
    else:
        raise ValueError(f"mont_mul: b {tuple(b.shape)} is neither a's shape "
                         f"{tuple(a.shape)} nor one element")
    if any(t.device != a.device for t in (b, idx) if t is not None):
        raise ValueError("mont_mul: operands on different devices")
    out = torch.empty_like(a)
    kernels.launch(f"mont_mul[{field.name}]", a.device, a.data_ptr(),
                   b.data_ptr(), 0 if idx is None else idx.data_ptr(), bcast,
                   out.data_ptr(), n, lanes=n)
    return out


def _add_sub(op: str, field, a: torch.Tensor, b: torch.Tensor):
    """Launch add[fr|fq] or sub[fr|fq] over a and b, broadcast against each
    other: an operand of one (16,) element is read as one row for every
    lane, any other is expanded to the result's shape. Operands are made
    int32 and contiguous (views such as x[0::2] are copied); their values
    must be canonical (< p)."""
    if a.device != b.device:
        raise ValueError(f"{op}: operands on different devices")
    shape = torch.broadcast_shapes(a.shape, b.shape)

    def operand(t, what):
        bcast = int(t.numel() == N_LIMBS)
        t = (t if bcast else t.expand(shape)).to(L.DTYPE).contiguous()
        kernels.check_cuda(t, f"{op} {what}")
        return t, bcast

    (a, a_bcast), (b, b_bcast) = operand(a, "a"), operand(b, "b")
    out = torch.empty(shape, dtype=L.DTYPE, device=a.device)
    n = out.numel() // N_LIMBS
    kernels.launch(f"{op}[{field.name}]", a.device, a.data_ptr(),
                   b.data_ptr(), a_bcast, b_bcast, out.data_ptr(), n,
                   lanes=n)
    return out


def add(field, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a + b) mod p of canonical limbs (..., 16), int32 out. On CUDA one
    add[fr|fq] launch, no read-back; on the CPU add_plain."""
    if _on_cpu(a, b):
        return add_plain(field, a, b)
    return _add_sub("add", field, a, b)


def sub(field, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a - b) mod p of canonical limbs (..., 16), int32 out. On CUDA one
    sub[fr|fq] launch, no read-back; on the CPU sub_plain."""
    if _on_cpu(a, b):
        return sub_plain(field, a, b)
    return _add_sub("sub", field, a, b)


def inv(field, a: torch.Tensor) -> torch.Tensor:
    """a^-1 of every row of a, (..., 16) canonical Fq limbs in Montgomery
    form; 0 maps to 0. On CUDA one inv[fq] launch (contiguous int32
    limbs)."""
    if _on_cpu(a):
        return inv_plain(field, a)
    if field.name != "fq":
        raise ValueError("inv is an Fq kernel")
    kernels.check_cuda(a, "inv a")
    out = torch.empty_like(a)
    n = a.numel() // N_LIMBS
    kernels.launch("inv[fq]", a.device, a.data_ptr(), out.data_ptr(), n,
                   lanes=n)
    return out


def inv_fq2(field, a):
    """1/(a0 + a1 u) of every row of a = (a0, a1), canonical Fq limbs in
    Montgomery form; 0 maps to 0. On CUDA one inv[fq2] launch (a0 and a1
    contiguous int32 limbs of one shape)."""
    a0, a1 = a
    if _on_cpu(a0, a1):
        return inv_fq2_plain(field, a)
    if field.name != "fq":
        raise ValueError("inv_fq2 is an Fq2 kernel over Fq")
    kernels.check_cuda(a0, "inv_fq2 a0")
    kernels.check_cuda(a1, "inv_fq2 a1")
    if a1.shape != a0.shape or a1.device != a0.device:
        raise ValueError("inv_fq2: a0 and a1 must share one shape and device")
    out0, out1 = torch.empty_like(a0), torch.empty_like(a1)
    n = a0.numel() // N_LIMBS
    kernels.launch("inv[fq2]", a0.device, a0.data_ptr(), a1.data_ptr(),
                   out0.data_ptr(), out1.data_ptr(), n, lanes=n)
    return (out0, out1)


def fold(field, sums: torch.Tensor) -> torch.Tensor:
    """(n, 16) lazy int64 limb sums V < 2^288 (index_add_ of canonical
    limbs) -> V mod r as canonical int32 limbs, in one launch on CUDA."""
    if field.name != "fr":
        raise ValueError("fold is an Fr kernel")
    if sums.device.type == "cpu":
        return fold_plain(field, sums)
    if (sums.device.type != "cuda" or sums.dtype != torch.int64
            or sums.dim() != 2 or sums.shape[1] != N_LIMBS
            or not sums.is_contiguous()):
        raise ValueError("fold: expected contiguous (n, 16) int64 CUDA "
                         f"sums, got {sums.dtype} {tuple(sums.shape)} on "
                         f"{sums.device}")
    n = sums.shape[0]
    out = torch.empty((n, N_LIMBS), dtype=L.DTYPE, device=sums.device)
    kernels.launch("fold[fr]", sums.device, sums.data_ptr(),
                   field.one_mont(sums.device).data_ptr(),
                   field.r2_limbs(sums.device).data_ptr(), out.data_ptr(), n,
                   lanes=n)
    return out


def ntt_pass(field, x: torch.Tensor, tw: torch.Tensor, s0: int, k: int, *,
             out=None, bitrev: bool = False, pre=None, post=None,
             pointwise=None, tw_origin: int = 0) -> torch.Tensor:
    """Radix-2 DIT stages s0 .. s0 + k - 1 (k <= 10) over x, (n, 16) or a
    batch (B, n, 16) of canonical Fr limbs, in one launch on CUDA. Stage s
    pairs rows j and j + 2^s (j mod 2^(s+1) < 2^s) with twiddle
    tw[2^s + j mod 2^s - tw_origin]: tw holds every stage's table, stage s
    at rows 2^s - tw_origin ... Optional, in this order: pointwise = (b, c,
    z) makes each input row (x * b - c) * z (b, c of x's shape, z one
    element); pre multiplies input row i by pre[i]; bitrev reads row
    rev(i) into row i (n a power of two; out of place); post multiplies
    output row i by post[i] (or by one broadcast element). Products are
    Montgomery: a plain-form table gives a plain result. Writes `out`
    (x itself is allowed without bitrev) or a new tensor, and returns it."""
    if field.name != "fr":
        raise ValueError("ntt_pass is an Fr kernel")
    pw = tuple(pointwise) if pointwise is not None else (None, None, None)
    if _on_cpu(x, tw, pre, post, out, *pw):
        return ntt_pass_plain(field, x, tw, s0, k, out=out, bitrev=bitrev,
                              pre=pre, post=post, pointwise=pointwise,
                              tw_origin=tw_origin)
    kernels.check_cuda(x, "ntt x")
    kernels.check_cuda(tw, "ntt twiddles")
    if x.dim() not in (2, 3):
        raise ValueError(f"ntt: x must be (n, 16) or (B, n, 16), got "
                         f"{tuple(x.shape)}")
    n = x.shape[-2]
    batch = x.numel() // (n * N_LIMBS) if n else 0
    log_n = n.bit_length() - 1
    if not 0 <= k <= 10 or s0 < 0 or n <= 0 or n % (1 << (s0 + k)):
        raise ValueError(f"ntt pass: stages {s0}..{s0 + k - 1} do not fit "
                         f"{n} rows")
    if bitrev and n != 1 << log_n:
        raise ValueError("ntt pass: the bit-reversal gather needs n a power "
                         "of two")
    if k and ((1 << s0) < tw_origin
              or (1 << (s0 + k)) - tw_origin > tw.shape[0]):
        raise ValueError("ntt pass: the twiddle table does not cover the "
                         "stages")
    for t, what in ((pre, "pre"), (post, "post"), *zip(pw, ("b", "c", "z"))):
        if t is not None:
            kernels.check_cuda(t, f"ntt {what}")
            if t.device != x.device:
                raise ValueError(f"ntt: {what} on another device than x")
    if pre is not None and pre.shape != (n, N_LIMBS):
        raise ValueError("ntt pass: pre must be (n, 16)")
    post_bcast = int(post is not None and post.numel() == N_LIMBS)
    if post is not None and not post_bcast and post.shape != (n, N_LIMBS):
        raise ValueError("ntt pass: post must be (n, 16) or one element")
    if pointwise is not None and (pw[0].shape != x.shape
                                  or pw[1].shape != x.shape
                                  or pw[2].numel() != N_LIMBS):
        raise ValueError("ntt pass: pointwise b, c must have x's shape and "
                         "z one element")
    if out is None:
        out = torch.empty_like(x)
    elif out.shape != x.shape:
        raise ValueError("ntt pass: out must have x's shape")
    else:
        kernels.check_cuda(out, "ntt out")
    if bitrev and out.data_ptr() == x.data_ptr():
        raise ValueError("ntt pass: the bit-reversal gather runs out of "
                         "place")
    ptr = lambda t: 0 if t is None else t.data_ptr()
    kernels.launch("ntt_pass", x.device, x.data_ptr(), out.data_ptr(),
                   tw.data_ptr(), tw_origin, ptr(pre), ptr(post), post_bcast,
                   ptr(pw[0]), ptr(pw[1]), ptr(pw[2]), batch, n, log_n, s0, k,
                   int(bitrev), lanes=batch * (n // 2) * k)
    return out


def ntt_stage_(field, x: torch.Tensor, tw: torch.Tensor, m: int) -> None:
    """One radix-2 stage IN PLACE on x (n, 16) of canonical Fr limbs: for
    each group of 2m rows, (x[j], x[j+m]) <- (x[j] + tw[j]*x[j+m],
    x[j] - tw[j]*x[j+m]), tw (m, 16), m a power of two: a pass of one
    stage (ntt_pass; its plain version on a CPU x)."""
    if field.name != "fr":
        raise ValueError("the NTT stage is an Fr kernel")
    n = x.shape[0]
    if (x.dim() != 2 or tw.shape != (m, N_LIMBS) or m <= 0 or m & (m - 1)
            or n % (2 * m)):
        raise ValueError("ntt stage: bad twiddle table or group size")
    ntt_pass(field, x, tw, m.bit_length() - 1, 1, out=x, tw_origin=m)
