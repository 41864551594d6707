"""In-process settlement-layer simulator: the RollUp/MerkleTree/Verifier
contracts as a Python state machine.

Faithful port of the ON-CHAIN SEMANTICS (not the Solidity) of
simple-zk-rollups/contracts/contracts/{RollUp,MerkleTree,Hasher}.sol so the
full deposit -> send -> prove -> rollUp -> withdraw loop runs E2E without an
EVM (no ganache in this environment). Groth16 verification uses the host
pairing (groth16/verify.py) with the VK from our setup — the same acceptance
oracle role the embedded snarkjs VKs play in TxVerifier.sol /
WithdrawVerifier.sol. Calldata formatting (incl. the pi_b coordinate
reversal for the real EVM ABI) lives in chain/calldata.py.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ..ref.mimc import multi_hash
from ..config import RollupConfig
from ..groth16.keys import VerifyingKey
from ..groth16.verify import verify as groth16_verify
from ..groth16.keys import Proof


class ChainMerkleTree:
    """MerkleTree.sol semantics: zeros/filledSubtrees/filledPaths caches,
    whitelist-gated insert/update, maxLeafIndex = 2^(depth-1)
    (MerkleTree.sol:68, 87-195)."""

    def __init__(self, depth: int, zero_value: int):
        self.depth = depth
        self.zero_value = zero_value
        self.max_leaf_index = 2 ** (depth - 1)
        self.zeros = {0: zero_value}
        self.filled_subtrees = {0: zero_value}
        self.filled_paths: Dict[int, Dict[int, int]] = {0: {}}
        for i in range(1, depth):
            self.zeros[i] = multi_hash([self.zeros[i - 1], self.zeros[i - 1]])
            self.filled_subtrees[i] = self.zeros[i]
            self.filled_paths[i] = {}
        self.root = multi_hash([self.zeros[depth - 1], self.zeros[depth - 1]])
        self.leaves: List[int] = []
        self.next_index = 0
        self.whitelist: set = set()

    def insert(self, leaf: int, caller: str) -> int:
        if caller not in self.whitelist:
            raise PermissionError("Caller not whitelisted")
        if self.next_index + 1 >= self.max_leaf_index:
            raise ValueError("Merkle Tree at max capacity")
        cur = self.next_index
        self.next_index += 1
        level_hash = leaf
        for i in range(self.depth):
            if cur % 2 == 0:
                left, right = level_hash, self.zeros[i]
                self.filled_subtrees[i] = level_hash
                self.filled_paths[i][cur] = left
                self.filled_paths[i][cur + 1] = right
            else:
                left, right = self.filled_subtrees[i], level_hash
                self.filled_paths[i][cur - 1] = left
                self.filled_paths[i][cur] = right
            level_hash = multi_hash([left, right])
            cur //= 2
        self.root = level_hash
        self.leaves.append(leaf)
        return self.next_index - 1

    def update(self, leaf_index: int, leaf: int, caller: str) -> None:
        if caller not in self.whitelist:
            raise PermissionError("Caller not whitelisted")
        if leaf_index >= self.next_index:
            raise ValueError("Can't update leaf which hasn't been inserted")
        # recompute-and-require old root (MerkleTree.sol:136-168)
        cur = leaf_index
        level_hash = self.leaves[leaf_index]
        path = []
        for i in range(self.depth):
            if cur % 2 == 0:
                sib = self.filled_paths[i][cur + 1]
                path.append(sib)
                level_hash = multi_hash([level_hash, sib])
            else:
                sib = self.filled_paths[i][cur - 1]
                path.append(sib)
                level_hash = multi_hash([sib, level_hash])
            cur //= 2
        if level_hash != self.root:
            raise ValueError("MerkleTree: tree root mismatch")
        cur = leaf_index
        level_hash = leaf
        for i in range(self.depth):
            if cur % 2 == 0:
                left, right = level_hash, path[i]
                self.filled_paths[i][cur] = left
                self.filled_paths[i][cur + 1] = right
            else:
                left, right = path[i], level_hash
                self.filled_paths[i][cur - 1] = left
                self.filled_paths[i][cur] = right
            level_hash = multi_hash([left, right])
            cur //= 2
        self.root = level_hash
        self.leaves[leaf_index] = leaf

    def get_root(self) -> int:
        return self.root

    def get_inserted_leaves_no(self) -> int:
        return self.next_index


@dataclass
class User:
    """RollUp.sol User struct (RollUp.sol:49-55)."""
    balance_tree_leaf_index: int = 0
    public_key_x: int = 0
    public_key_y: int = 0
    balance: int = 0
    nonce: int = 0


@dataclass
class Event:
    name: str
    args: Dict


class RollUpContract:
    """RollUp.sol state machine (deposit/rollUp/withdraw/withdrawAll/fees)."""

    ADDRESS = "rollup-contract"

    def __init__(self, cfg: RollupConfig, tx_vk: Optional[VerifyingKey],
                 withdraw_vk: Optional[VerifyingKey]):
        self.cfg = cfg
        self.balance_tree = ChainMerkleTree(cfg.tree_depth, cfg.tree_zero_value)
        self.balance_tree.whitelist.add(self.ADDRESS)
        self.tx_vk = tx_vk
        self.withdraw_vk = withdraw_vk
        self.users: Dict[int, User] = {}            # pubkeyHash -> User
        self.registered: Dict[int, bool] = {}
        self.used_nullifiers: Dict[int, bool] = {}
        self.balance_tree_keys: Dict[int, int] = {}  # index -> pubkeyHash
        self.accrued_fees = 0
        self.eth_balance = 0                         # contract's ETH pool
        self.events: List[Event] = []

    # -- views -------------------------------------------------------------

    def get_user_key(self, index: int) -> int:
        return self.balance_tree_keys.get(index, 0)

    def get_user_data(self, public_key_hash: int) -> Tuple[int, int, int, int, int]:
        u = self.users.get(public_key_hash, User())
        return (u.balance_tree_leaf_index, u.public_key_x, u.public_key_y,
                u.balance, u.nonce)

    def is_public_key_registered(self, x: int, y: int) -> bool:
        return self.registered.get(multi_hash([x, y]), False)

    def get_accrued_fees(self) -> int:
        return self.accrued_fees

    # -- mutations ---------------------------------------------------------

    def deposit(self, public_key_x: int, public_key_y: int, value: int) -> None:
        """RollUp.sol:255-297."""
        key_hash = multi_hash([public_key_x, public_key_y])
        user = self.users.setdefault(key_hash, User())
        user.balance += value
        self.eth_balance += value

        leaf = multi_hash([public_key_x, public_key_y, user.balance,
                           user.nonce])
        if not self.registered.get(key_hash):
            self.registered[key_hash] = True
            user.public_key_x = public_key_x
            user.public_key_y = public_key_y
            user.balance_tree_leaf_index = \
                self.balance_tree.get_inserted_leaves_no()
            self.balance_tree.insert(leaf, self.ADDRESS)
            self.balance_tree_keys[user.balance_tree_leaf_index] = key_hash
        else:
            self.balance_tree.update(user.balance_tree_leaf_index, leaf,
                                     self.ADDRESS)
        self.events.append(Event("Deposit", {
            "balanceTreeIndex": user.balance_tree_leaf_index,
            "publicKeyX": public_key_x, "publicKeyY": public_key_y,
            "balance": user.balance, "nonce": user.nonce}))

    def roll_up(self, proof: Proof, inputs: List[int]) -> None:
        """RollUp.sol:81-161: root check, proof check, then REPLAY public
        txData to update on-chain balances/nonces/fees and tree leaves."""
        cfg = self.cfg
        if len(inputs) != cfg.n_tx_public_signals:
            raise ValueError("bad input length")
        balance_tree_root = inputs[1]
        if self.balance_tree.get_root() != balance_tree_root:
            raise ValueError("Proof not valid for current tree")
        if self.tx_vk is None or not groth16_verify(self.tx_vk, proof, inputs):
            raise ValueError("Invalid roll up proofs")

        tx_data_offset = cfg.tx_data_offset
        for i in range(cfg.batch_size):
            off = tx_data_offset + 8 * i
            frm, to, amount, fee, nonce = inputs[off:off + 5]
            sender = self.users[self.balance_tree_keys[frm]]
            sender.balance -= amount + fee
            sender.nonce = nonce
            recipient = self.users[self.balance_tree_keys[to]]
            recipient.balance += amount
            self.accrued_fees += fee

            sender_leaf = multi_hash([sender.public_key_x, sender.public_key_y,
                                      sender.balance, sender.nonce])
            recipient_leaf = multi_hash(
                [recipient.public_key_x, recipient.public_key_y,
                 recipient.balance, recipient.nonce])
            self.balance_tree.update(sender.balance_tree_leaf_index,
                                     sender_leaf, self.ADDRESS)
            self.balance_tree.update(recipient.balance_tree_leaf_index,
                                     recipient_leaf, self.ADDRESS)
        self.events.append(
            Event("RollUpProcessed", {"newRoot": self.balance_tree.get_root()}))

    def withdraw(self, amount: int, proof: Proof, inputs: List[int]) -> int:
        """RollUp.sol:212-253. Returns the ETH amount transferred."""
        public_key_x, public_key_y, nullifier = inputs
        if self.used_nullifiers.get(nullifier):
            raise ValueError("Nullifier has been used")
        if self.withdraw_vk is None or not groth16_verify(
                self.withdraw_vk, proof, inputs):
            raise ValueError("Unauthorized to withdraw funds")
        key_hash = multi_hash([public_key_x, public_key_y])
        user = self.users.get(key_hash)
        if user is None or amount > user.balance:
            raise ValueError("Withdraw amount is more than remaining balance")
        self.used_nullifiers[nullifier] = True
        user.balance -= amount
        self.eth_balance -= amount
        self.events.append(Event("Withdraw", {
            "balanceTreeIndex": user.balance_tree_leaf_index,
            "publicKeyX": public_key_x, "publicKeyY": public_key_y,
            "balance": user.balance, "nonce": user.nonce}))
        return amount

    def withdraw_all(self, proof: Proof, inputs: List[int]) -> int:
        """RollUp.sol:193-210."""
        key_hash = multi_hash([inputs[0], inputs[1]])
        user = self.users.get(key_hash)
        if user is None or user.balance <= 0:
            raise ValueError("Cannot withdraw with 0 balance")
        return self.withdraw(user.balance, proof, inputs)

    def withdraw_accrued_fees(self, caller_is_owner: bool = True) -> int:
        """RollUp.sol:303-309."""
        if not caller_is_owner:
            raise PermissionError("Only owner can call this function")
        fees, self.accrued_fees = self.accrued_fees, 0
        self.eth_balance -= fees
        return fees
