"""Operator-side balance-tree state: persistence + contract event sync.

Parity with the reference's pubsub handler
(simple-zk-rollups/operator/src/routes/pubsub.ts:19-67): on Deposit/Withdraw,
load the tree, hash the event's leaf data, insert (new index) or update
(existing), hard-fail "Merkletree out of sync!" on gaps, save back. Storage
is the sqlite TreeStore (checkpoint/resume system — SURVEY §5).
"""

from __future__ import annotations

from typing import Dict, Optional

from ..config import RollupConfig
from ..tree.merkle import MerkleTree, create_merkle_tree
from ..tree.store import TreeStore
from ..witness.assembler import hash_balance_tree_leaf
from ..chain.simulator import Event


class OperatorState:
    def __init__(self, cfg: RollupConfig, store: Optional[TreeStore] = None):
        self.cfg = cfg
        self.store = store or TreeStore(":memory:")
        self.tree_name = cfg.balance_tree_name
        if not self.store.exists(self.tree_name):
            tree = create_merkle_tree(cfg.tree_depth, cfg.tree_zero_value)
            self.store.save(self.tree_name, tree)

    def load_tree(self) -> MerkleTree:
        return self.store.load(self.tree_name)

    def on_chain_event(self, event: Event) -> None:
        """Deposit/Withdraw handler (pubsub.ts:20-67)."""
        if event.name not in ("Deposit", "Withdraw"):
            return
        args = event.args
        index = args["balanceTreeIndex"]
        leaf_data = {
            "publicKey": [args["publicKeyX"], args["publicKeyY"]],
            "balance": args["balance"],
            "nonce": args["nonce"],
        }
        leaf = hash_balance_tree_leaf(leaf_data)

        m = self.load_tree()
        if index > m.next_leaf_index:
            raise RuntimeError("Merkletree out of sync!")
        if index == m.next_leaf_index:
            m.insert_(leaf, leaf_data)
        else:
            m.update_(index, leaf, leaf_data)
        self.store.save(self.tree_name, m, leaf_index=index)

    def apply_rollup_batch(self, final_tree: MerkleTree) -> None:
        """After an accepted rollUp(), persist the post-batch tree (the
        operator already holds it from input assembly)."""
        self.store.save_all_leaves(self.tree_name, final_tree)
