"""Batched MiMCSponge over Fr: the rollup's universal hash on a batch of
lanes at once.

Counterpart of zkrollup/hash/mimc_jax.py. The reference runs the
220-round Feistel as a lax.scan whose body is three Montgomery products
and three adds on the whole batch. Here, on CUDA tensors, the whole sponge
(multi_hash_mont) is one launch of the mimc_sponge[fr] kernel
(csrc/mimc.cu): a thread a lane, every round of every input in
registers. On CPU tensors it runs its plain version,
multi_hash_mont_plain: the reference's scan as a Python loop over the
plain product and add. A lone permutation (permute_mont) is that loop over
FR.mont_mul and FR.add, the mont_mul[fr] and add[fr] kernels on CUDA
tensors, with no read-back. Hashing a Merkle level of n pairs is one
launch of n lanes, 440 rounds each.

Values are (..., 16) int32 limb tensors in Montgomery form (R = 2^256),
canonical (< r); the round constants are encoded once on the host and
cached on each device they are used on.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import kernels
from ..fields import cuda_mont, limbs as L
from ..fields.mont import FR
from ..ref.mimc import N_ROUNDS_SPONGE, mimcsponge_constants

_CTS_HOST = None
_CTS = {}


def constants_mont(device) -> torch.Tensor:
    """(220, 16) round constants in Montgomery form on `device`: encoded on
    the host once, copied to each device once."""
    global _CTS_HOST
    if _CTS_HOST is None:
        _CTS_HOST = FR.to_mont_host(list(mimcsponge_constants(
            N_ROUNDS_SPONGE)))
    key = str(torch.device(device))
    if key not in _CTS:
        _CTS[key] = L.to_device(_CTS_HOST, device)
    return _CTS[key]


def _permute(x_l, x_r, k, add, mul):
    """The reference's scan over the 220 rounds, on `add` and `mul`."""
    xl, xr = x_l, x_r
    for c in constants_mont(x_l.device):
        t = add(add(xl, k), c)
        t2 = mul(t, t)
        t4 = mul(t2, t2)
        t5 = mul(t4, t)
        # every round swaps, the last one too; the swap back below undoes
        # it: the last round leaves xL as it is and sets xR = xR + t5
        xl, xr = add(xr, t5), xl
    return xr, xl


def permute_mont(x_l: torch.Tensor, x_r: torch.Tensor, k: torch.Tensor):
    """MiMC-Feistel permutation of (x_l, x_r) under key k, Montgomery form
    in and out. x_l, x_r: (..., 16); k broadcastable to them. Every product
    on FR.mont_mul and every add on FR.add (kernels on CUDA tensors)."""
    return _permute(x_l, x_r, k, FR.add, FR.mont_mul)


def multi_hash_mont_plain(inputs: torch.Tensor,
                          k: torch.Tensor | None = None) -> torch.Tensor:
    """The plain version of mimc_sponge[fr]: the reference's sponge
    (mimc_jax.py:multi_hash_mont) over the plain product and add, on any
    device."""
    add = functools.partial(cuda_mont.add_plain, FR)
    mul = functools.partial(cuda_mont.mont_mul_plain, FR)
    n_in = inputs.shape[-2]
    batch = inputs.shape[:-2]
    zeros = lambda: torch.zeros(batch + (L.N_LIMBS,), dtype=L.DTYPE,
                                device=inputs.device)
    if k is None:
        k = zeros()
    r, c = zeros(), zeros()
    for i in range(n_in):
        r = add(r, inputs[..., i, :])
        r, c = _permute(r, c, k, add, mul)
    return r


def multi_hash_mont(inputs: torch.Tensor,
                    k: torch.Tensor | None = None) -> torch.Tensor:
    """Sponge multi-hash. inputs: (..., n_in, 16) Montgomery form, n_in >=
    1; k: None (zero), one (16,) element or broadcastable to (..., 16).
    Returns (..., 16) Montgomery form. On CUDA one mimc_sponge[fr] launch;
    on the CPU multi_hash_mont_plain."""
    if inputs.device.type == "cpu" and (k is None or k.device.type == "cpu"):
        return multi_hash_mont_plain(inputs, k)
    return mimc_sponge(inputs, k)


def mimc_sponge(inputs: torch.Tensor,
                k: torch.Tensor | None = None) -> torch.Tensor:
    """One mimc_sponge[fr] launch over the lanes of inputs (CUDA): the
    inputs made int32 and contiguous, (n, n_in, 16) rows; the key as no
    pointer (zero), one broadcast row, or (n, 16) rows."""
    if inputs.dim() < 2 or inputs.shape[-1] != L.N_LIMBS \
            or inputs.shape[-2] < 1:
        raise ValueError(f"mimc: inputs must be (..., n_in >= 1, 16), got "
                         f"{tuple(inputs.shape)}")
    n_in = inputs.shape[-2]
    batch = tuple(inputs.shape[:-2])
    x = inputs.to(L.DTYPE).contiguous()
    kernels.check_cuda(x, "mimc inputs")
    key, key_bcast = None, 0
    if k is not None:
        if k.device != x.device:
            raise ValueError("mimc: key on another device than the inputs")
        key_bcast = int(k.numel() == L.N_LIMBS)
        key = (k if key_bcast else k.expand(batch + (L.N_LIMBS,))).to(
            L.DTYPE).contiguous()
        kernels.check_cuda(key, "mimc key")
    cts = constants_mont(x.device)
    out = torch.empty(batch + (L.N_LIMBS,), dtype=L.DTYPE, device=x.device)
    n = out.numel() // L.N_LIMBS
    kernels.launch("mimc_sponge[fr]", x.device, x.data_ptr(), n_in,
                   0 if key is None else key.data_ptr(), key_bcast,
                   cts.data_ptr(), out.data_ptr(), n, lanes=n)
    return out


def hash_pairs_mont(pairs: torch.Tensor) -> torch.Tensor:
    """(..., 2, 16) -> (..., 16): hashLeftRight over a batch (Montgomery
    form)."""
    return multi_hash_mont(pairs)


def multi_hash_ints(values_2d, device="cuda") -> np.ndarray:
    """Host convenience: rows of ints (one width) -> an array of their hash
    ints, hashed on `device`."""
    rows = list(values_2d)
    n = len(rows)
    width = len(rows[0])
    flat = [v for row in rows for v in row]
    enc = L.to_device(FR.to_mont_host(flat), device).reshape(
        n, width, L.N_LIMBS)
    return np.asarray(FR.from_mont_host(multi_hash_mont(enc)), dtype=object)


def hash_balance_tree_leaves(leaves: torch.Tensor) -> torch.Tensor:
    """(..., 4, 16) [pubX, pubY, balance, nonce] -> leaf hashes (Montgomery
    form). Parity: helpers.ts:80-82."""
    return multi_hash_mont(leaves)


def merkle_level_up(nodes: torch.Tensor) -> torch.Tensor:
    """One tree level: (n, 16) Montgomery-form nodes (n even) ->
    (n // 2, 16)."""
    return hash_pairs_mont(nodes.reshape(-1, 2, L.N_LIMBS))


def build_tree_root_mont(leaves: torch.Tensor, depth: int) -> torch.Tensor:
    """Root of a full 2^depth-leaf tree from Montgomery-form leaves
    (n = 2^depth): the dense batched builder of bulk rebuilds and
    benchmarks. The rollup's incremental tree hashes `depth` levels above
    the leaf row, padded with the zeros-tree values."""
    nodes = leaves
    for _ in range(depth):
        nodes = merkle_level_up(nodes)
    return nodes[0]
