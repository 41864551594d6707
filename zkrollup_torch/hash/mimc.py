"""Batched MiMCSponge over Fr: the rollup's universal hash on a batch of
lanes at once.

Counterpart of zkrollup/hash/mimc_jax.py. The reference runs the
220-round Feistel as a lax.scan whose body is three Montgomery products on
the whole batch; here the scan is a Python loop over the same body. Each
product is FR.mont_mul, the mont_mul[fr] kernel on CUDA tensors (its plain
version on CPU tensors), as the reference's FR.mont_mul dispatches its
large same-shape batches to the Pallas mont_mul; the adds are FR.add, as
in the reference. Hashing a Merkle level of n pairs is two permutations,
440 rounds, of n lanes.

Values are (..., 16) int32 limb tensors in Montgomery form (R = 2^256)
between rounds; the round constants are encoded once on the host and
cached on each device they are used on.
"""

from __future__ import annotations

import numpy as np
import torch

from ..fields import limbs as L
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


def permute_mont(x_l: torch.Tensor, x_r: torch.Tensor, k: torch.Tensor):
    """MiMC-Feistel permutation of (x_l, x_r) under key k, Montgomery form
    in and out. x_l, x_r: (..., 16); k broadcastable to them."""
    cts = constants_mont(x_l.device)
    xl, xr = x_l, x_r
    for c in cts:
        t = FR.add(FR.add(xl, k), c)
        t2 = FR.mont_mul(t, t)
        t4 = FR.mont_mul(t2, t2)
        t5 = FR.mont_mul(t4, t)
        # every round swaps, the last one too; the swap back below undoes
        # it: the last round leaves xL as it is and sets xR = xR + t5
        xl, xr = FR.add(xr, t5), xl
    return xr, xl


def multi_hash_mont(inputs: torch.Tensor,
                    k: torch.Tensor | None = None) -> torch.Tensor:
    """Sponge multi-hash. inputs: (..., n_in, 16) Montgomery form; returns
    (..., 16) Montgomery form."""
    n_in = inputs.shape[-2]
    batch = inputs.shape[:-2]
    zeros = lambda: torch.zeros(batch + (L.N_LIMBS,), dtype=L.DTYPE,
                                device=inputs.device)
    if k is None:
        k = zeros()
    r, c = zeros(), zeros()
    for i in range(n_in):
        r = FR.add(r, inputs[..., i, :])
        r, c = permute_mont(r, c, k)
    return r


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
