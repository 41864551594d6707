"""Transaction admission rules — parity with the /send route checks
(simple-zk-rollups/operator/src/routes/send.ts:16-150): sender/recipient
existence, balance sufficiency, fee >= 0.3% of amount, nonce continuity,
EdDSA signature over formatTx."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

from ..config import RollupConfig
from ..ref import eddsa
from ..tree.merkle import MerkleTree
from ..witness.assembler import Transaction, format_tx


@dataclass
class ValidationError(Exception):
    message: str

    def __str__(self):
        return self.message


def project_pending(tree: MerkleTree, pending: Sequence[Transaction]
                    ) -> Dict[int, dict]:
    """Overlay of {leaf_index: {balance, nonce}} after applying the effects
    of queued-but-unsettled transactions, exactly as the batch circuit will
    (sender debited amount+fee, nonce advanced; recipient credited amount).

    The reference validates /send against the LAST SETTLED tree only
    (send.ts:73) — and never drains its queue, so two consecutive txs from
    one account can never both be admitted. Since our batch daemon actually
    settles batches (batchd.py), admission must see the projected state or
    the second tx of every sender-chained batch would bounce."""
    overlay: Dict[int, dict] = {}

    def state(idx: int) -> dict:
        if idx not in overlay:
            raw = tree.get_leaf_raw(idx)
            overlay[idx] = {"balance": raw["balance"], "nonce": raw["nonce"]}
        return overlay[idx]

    for tx in pending:
        snd = state(tx.from_index)
        snd["balance"] -= tx.amount + tx.fee
        snd["nonce"] = tx.nonce
        state(tx.to_index)["balance"] += tx.amount
    return overlay


def validate_tx(cfg: RollupConfig, tree: MerkleTree, tx: Transaction,
                pending: Sequence[Transaction] = ()) -> None:
    """Raises ValidationError on the first failed check (send.ts order).
    `pending` = queued txs ahead of this one (projected onto the state)."""
    if tx.from_index >= tree.next_leaf_index:
        raise ValidationError("Sender (from) not found")
    if tx.to_index >= tree.next_leaf_index:
        raise ValidationError("Sender (to) not found")

    sender = tree.get_leaf_raw(tx.from_index)
    if sender is None:
        raise ValidationError("Sender (from) not found")
    if pending:
        proj = project_pending(tree, pending)
        if tx.from_index in proj:
            sender = dict(sender, **proj[tx.from_index])

    if sender["balance"] < tx.amount:
        raise ValidationError(
            f"Sender only has {sender['balance']}, unable to send {tx.amount}")

    # fee >= amount/1000*3, bigInt-truncating division (send.ts:101)
    if cfg.min_fee(tx.amount) > tx.fee:
        raise ValidationError(
            "Fee needs to be at least 0.3% of the amount to be sent")

    if tx.nonce != sender["nonce"] + 1:
        raise ValidationError(
            f"Expected nonce of {sender['nonce'] + 1}, received {tx.nonce}")

    if tx.signature is None or not eddsa.verify(
            format_tx(Transaction(tx.from_index, tx.to_index, tx.amount,
                                  tx.fee, tx.nonce)),
            tx.signature, tuple(sender["publicKey"])):
        raise ValidationError("Invalid signature")
