"""Incremental append-only Merkle tree over MiMCSponge.

Behavioral parity with the operator's tree
(simple-zk-rollups/operator/src/utils/merkletree.ts:14-266), including:
  - zeros / filledSubtrees / filledPaths caches and their update rules
  - the capacity quirk maxLeafIndex = 2^(depth-1)  (merkletree.ts:57)
  - immutable `insert`/`update` wrapping stateful `insert_`/`update_`
  - root-consistency recheck before update  (merkletree.ts:159-161)
  - O(depth) `getUpdatePath`  (merkletree.ts:233-257)

The hash function is pluggable so bulk rebuilds can run through the batched
TPU MiMC kernel while single-leaf ops use the host path.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from ..ref.mimc import multi_hash


@dataclass
class MerkleTreePath:
    path_elements: List[int]
    path_indexes: List[int]


class MerkleTree:
    def __init__(self, depth: int, zero_value: int = 0,
                 hash_func: Callable[[List[int]], int] = multi_hash):
        self.depth = depth
        self.zero_value = zero_value
        self.hash_func = hash_func

        self.leaves: List[int] = []
        self.leaves_raw: List[Any] = []
        self.max_leaf_index = 2 ** (depth - 1)  # parity quirk (merkletree.ts:57)

        self.zeros: Dict[int, int] = {0: zero_value}
        self.filled_subtrees: Dict[int, int] = {0: zero_value}
        self.filled_paths: Dict[int, Dict[int, int]] = {0: {}}

        for i in range(1, depth):
            self.zeros[i] = hash_func([self.zeros[i - 1], self.zeros[i - 1]])
            self.filled_subtrees[i] = self.zeros[i]
            self.filled_paths[i] = {}

        self.root = hash_func([self.zeros[depth - 1], self.zeros[depth - 1]])
        self.next_leaf_index = 0

    # -- value semantics ---------------------------------------------------

    def copy(self) -> "MerkleTree":
        c = MerkleTree.__new__(MerkleTree)
        c.depth = self.depth
        c.zero_value = self.zero_value
        c.hash_func = self.hash_func
        c.leaves = list(self.leaves)
        c.leaves_raw = copy.deepcopy(self.leaves_raw)
        c.max_leaf_index = self.max_leaf_index
        c.zeros = dict(self.zeros)
        c.filled_subtrees = dict(self.filled_subtrees)
        c.filled_paths = {k: dict(v) for k, v in self.filled_paths.items()}
        c.root = self.root
        c.next_leaf_index = self.next_leaf_index
        return c

    def equals(self, o: "MerkleTree") -> bool:
        return (self.depth == o.depth and self.zero_value == o.zero_value
                and self.leaves == o.leaves and self.leaves_raw == o.leaves_raw
                and self.zeros == o.zeros
                and self.filled_subtrees == o.filled_subtrees
                and self.filled_paths == o.filled_paths
                and self.root == o.root
                and self.next_leaf_index == o.next_leaf_index)

    def hash_left_right(self, left: int, right: int) -> int:
        return self.hash_func([left, right])

    # -- immutable API (merkletree.ts:101-123) -----------------------------

    def insert(self, leaf: int, raw_value: Any = None) -> "MerkleTree":
        if self.next_leaf_index + 1 >= self.max_leaf_index:
            raise ValueError("Tree at max capacity")
        c = self.copy()
        c.insert_(leaf, raw_value)
        return c

    def update(self, leaf_index: int, leaf: int, raw_value: Any = None) -> "MerkleTree":
        if leaf_index >= self.next_leaf_index:
            raise ValueError("Can't update leafIndex which hasn't been inserted yet!")
        c = self.copy()
        c.update_(leaf_index, leaf, raw_value)
        return c

    # -- stateful API (merkletree.ts:125-227) ------------------------------

    def insert_(self, leaf: int, raw_value: Any = None) -> None:
        if self.next_leaf_index + 1 >= self.max_leaf_index:
            raise ValueError("Merkle Tree at max capacity")

        cur_idx = self.next_leaf_index
        self.next_leaf_index += 1

        level_hash = leaf
        for i in range(self.depth):
            if cur_idx % 2 == 0:
                left, right = level_hash, self.zeros[i]
                self.filled_subtrees[i] = level_hash
                self.filled_paths[i][cur_idx] = left
                self.filled_paths[i][cur_idx + 1] = right
            else:
                left, right = self.filled_subtrees[i], level_hash
                self.filled_paths[i][cur_idx - 1] = left
                self.filled_paths[i][cur_idx] = right
            level_hash = self.hash_left_right(left, right)
            cur_idx //= 2

        self.root = level_hash
        self.leaves.append(leaf)
        self.leaves_raw.append(raw_value)

    def update_(self, leaf_index: int, leaf: int, raw_value: Any = None) -> None:
        path = self.get_update_path(leaf_index)
        self.update_with_manual_path_(leaf_index, leaf, raw_value, path.path_elements)

    def update_with_manual_path_(self, leaf_index: int, leaf: int,
                                 raw_value: Any, path_elements: List[int]) -> None:
        if leaf_index >= self.next_leaf_index:
            raise ValueError("Can't update leafIndex which hasn't been inserted yet!")

        # recompute + assert old root first (merkletree.ts:146-161)
        cur_idx = leaf_index
        level_hash = self.leaves[leaf_index]
        for i in range(self.depth):
            if cur_idx % 2 == 0:
                left, right = level_hash, path_elements[i]
            else:
                left, right = path_elements[i], level_hash
            level_hash = self.hash_left_right(left, right)
            cur_idx //= 2
        if self.root != level_hash:
            raise ValueError("MerkleTree: tree root / current level has mismatch")

        cur_idx = leaf_index
        level_hash = leaf
        for i in range(self.depth):
            if cur_idx % 2 == 0:
                left, right = level_hash, path_elements[i]
                self.filled_paths[i][cur_idx] = left
                self.filled_paths[i][cur_idx + 1] = right
            else:
                left, right = path_elements[i], level_hash
                self.filled_paths[i][cur_idx - 1] = left
                self.filled_paths[i][cur_idx] = right
            level_hash = self.hash_left_right(left, right)
            cur_idx //= 2

        self.root = level_hash
        self.leaves[leaf_index] = leaf
        self.leaves_raw[leaf_index] = raw_value

    def get_update_path(self, leaf_index: int) -> MerkleTreePath:
        if leaf_index >= self.next_leaf_index:
            raise ValueError("Path not constructed yet, leafIndex >= nextIndex")
        cur_idx = leaf_index
        path_elements: List[int] = []
        path_indexes: List[int] = []
        for i in range(self.depth):
            if cur_idx % 2 == 0:
                path_elements.append(self.filled_paths[i][cur_idx + 1])
                path_indexes.append(0)
            else:
                path_elements.append(self.filled_paths[i][cur_idx - 1])
                path_indexes.append(1)
            cur_idx //= 2
        return MerkleTreePath(path_elements, path_indexes)

    def get_leaf_raw(self, leaf_index: int) -> Optional[Any]:
        if 0 <= leaf_index < len(self.leaves_raw):
            return self.leaves_raw[leaf_index]
        return None


def create_merkle_tree(depth: int, zero_value: int = 0,
                       hash_func: Callable[[List[int]], int] = multi_hash) -> MerkleTree:
    return MerkleTree(depth, zero_value, hash_func)
