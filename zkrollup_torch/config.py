"""Single source of truth for rollup parameters.

The reference duplicates these across three places that must agree
(simple-zk-rollups/zk-rollups.config.js:1-35, the circuit instantiation
`BatchProcessTx(2, 6)` at simple-zk-rollups/prover/circuits/tx.circom:4, and
hardcoded offsets in simple-zk-rollups/contracts/contracts/RollUp.sol:114-116).
Here one dataclass derives all of them: circuit params, the public-signal
layout, and kernel shapes.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field


TX_DATA_WITHOUT_SIG_LENGTH = 5  # [from, to, amount, fee, nonce]
TX_DATA_WITH_SIG_LENGTH = 8     # + [R8x, R8y, S]
BALANCE_TREE_LEAF_DATA_LENGTH = 4  # [pubX, pubY, balance, nonce]


@dataclass(frozen=True)
class RollupConfig:
    tree_depth: int = 6
    tree_zero_value: int = 0
    batch_size: int = 2
    balance_tree_name: str = "balanceTree"
    # minimum fee: amount/1000*3  (send.ts:101)
    min_fee_num: int = 3
    min_fee_den: int = 1000

    @property
    def max_leaf_index(self) -> int:
        # Deliberate parity with the reference's capacity quirk:
        # maxLeafIndex = 2^(depth-1) (merkletree.ts:57, MerkleTree.sol:68)
        return 2 ** (self.tree_depth - 1)

    # ---- public-signal layout of the tx circuit --------------------------
    # [0]                     newBalanceTreeRoot (output)
    # [1 .. b]                balanceTreeRoot[b]
    # [b+1 .. b+8b]           txData[b][8]
    # ... remaining BatchProcessTx inputs, in declaration order
    # Matches uint[73] for b=2, depth=6 (TxVerifier.sol:281, RollUp.sol:114-125).

    @property
    def tx_data_offset(self) -> int:
        return 1 + self.batch_size

    @property
    def n_tx_public_signals(self) -> int:
        b, d = self.batch_size, self.tree_depth
        # output root + roots + txData + sender(pub2+bal+nonce+path d)
        # + recipient(same) + intermediate root + intermediate path
        return 1 + b + 8 * b + b * (2 + 1 + 1 + d) * 2 + b + b * d

    @property
    def n_withdraw_public_signals(self) -> int:
        return 3  # publicKey[2] + nullifier (WithdrawVerifier.sol:211)

    def min_fee(self, amount: int) -> int:
        # bigInt division truncates: amount.div(1000).mul(3) (send.ts:101)
        return amount // self.min_fee_den * self.min_fee_num


def load_config() -> RollupConfig:
    """Env-overridable, mirroring zk-rollups.config.js env vars."""
    return RollupConfig(
        tree_depth=int(os.environ.get("BALANCE_TREE_DEPTH", "6")),
        tree_zero_value=int(os.environ.get("BALANCE_TREE_ZERO_VALUE", "0")),
        batch_size=int(os.environ.get("PROCESS_TX_CIRCUIT_BATCH_SIZE", "2")),
    )


DEFAULT_CONFIG = RollupConfig()
