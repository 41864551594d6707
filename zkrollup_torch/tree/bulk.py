"""Bulk Merkle-tree construction through the batched MiMC.

Counterpart of zkrollup/tree/bulk.py. The incremental tree (merkle.py)
hashes one leaf path at a time through host MiMC, which suits single
deposits and updates (the reference's only mode, merkletree.ts:125-227).
Bulk flows (rebuilding an operator mirror from stored leaves, checking a
TreeStore snapshot, post-batch rebuilds) hash whole levels at once
instead: one hash/mimc.py level of 2^k pairs on `device` (one
mimc_sponge[fr] launch on CUDA) in place of 2^k scalar sponge loops.

`from_leaves` reproduces the exact object state `insert_` would have built
(the zeros, filledSubtrees and filledPaths caches included), as
`MerkleTree.equals` compares it.
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence

from ..fields import limbs as L
from ..fields.mont import FR
from ..hash import mimc
from ..ref.mimc import multi_hash
from .merkle import MerkleTree

# below this many leaves the device's launches and copies lose to the host
# loop (the reference's threshold)
MIN_BATCH_LEAVES = 16


def _level_up_host(nodes: List[int]) -> List[int]:
    return [multi_hash([nodes[i], nodes[i + 1]])
            for i in range(0, len(nodes), 2)]


def _level_up_device(nodes: List[int], device="cuda") -> List[int]:
    enc = L.to_device(FR.to_mont_host(nodes), device)
    return FR.from_mont_host(mimc.merkle_level_up(enc))


def _level_up(nodes: List[int], use_device: bool,
              device="cuda") -> List[int]:
    if use_device and len(nodes) >= 2 * MIN_BATCH_LEAVES:
        return _level_up_device(nodes, device)
    return _level_up_host(nodes)


def from_leaves(leaves: Sequence[int], depth: int, zero_value: int = 0,
                leaves_raw: Optional[Sequence[Any]] = None,
                use_device: bool = True, device="cuda") -> MerkleTree:
    """The tree that `insert_`-ing each leaf would build, with each level
    of at least 2 MIN_BATCH_LEAVES nodes hashed as one batch on `device`:
    its root, caches and capacity quirk are those of the incremental
    path."""
    n = len(leaves)
    tree = MerkleTree(depth, zero_value)
    if n + 1 > tree.max_leaf_index:
        raise ValueError("Tree at max capacity")
    if n == 0:
        return tree

    tree.leaves = list(leaves)
    tree.leaves_raw = (list(leaves_raw) if leaves_raw is not None
                       else [None] * n)
    tree.next_leaf_index = n

    # level 0 .. depth-1: nodes holds the non-zero prefix of level i
    nodes = list(leaves)
    for i in range(depth):
        # pad to even with the level's zero value
        padded = nodes + ([tree.zeros[i]] if len(nodes) % 2 else [])
        # the caches of sequential insert_ (merkle.py:insert_):
        #   filled_paths[i] holds every touched node, 0 .. len(padded)-1
        #   filled_subtrees[i] is the last EVEN-indexed node's value
        tree.filled_paths[i] = {j: padded[j] for j in range(len(padded))}
        last = (n - 1) >> i
        tree.filled_subtrees[i] = padded[last & ~1]
        nodes = _level_up(padded, use_device, device)

    tree.root = nodes[0]
    return tree


def multi_hash_rows(rows: Sequence[Sequence[int]], use_device: bool = True,
                    device="cuda") -> List[int]:
    """Hash many rows of one width (balance-tree leaf data, say): as one
    batch on `device` when there are at least MIN_BATCH_LEAVES, on the
    host otherwise. Parity: helpers.ts:80."""
    rows = [list(r) for r in rows]
    if not rows:
        return []
    if use_device and len(rows) >= MIN_BATCH_LEAVES:
        return [int(v) for v in mimc.multi_hash_ints(rows, device)]
    return [multi_hash(r) for r in rows]
