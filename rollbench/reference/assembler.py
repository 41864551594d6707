# Frozen copy of zkrollup_torch/witness/assembler.py (commit f14ca18), imports made
# local; the benchmark's reference uses it and later changes to the program
# do not reach it.
"""Batch input assembly: tree snapshot + signed txs -> circuit inputs.

This is the per-batch preparation the reference performs inline in its E2E
test (simple-zk-rollups/operator/__tests__/operatorLogic.test.ts:105-221):
for each tx, capture sender/recipient paths, apply the sender debit to get
the intermediate tree, capture the recipient path on it, apply the credit,
and chain into the next tx. Promoted here to a first-class component (the
reference's missing batch-prover loop — SURVEY §2.2 vestigial note).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from .eddsa import Signature
from .mimc import multi_hash
from .merkle import MerkleTree
from .config import RollupConfig


@dataclass
class Transaction:
    """Parity with types/models.ts:14-21."""
    from_index: int
    to_index: int
    amount: int
    fee: int
    nonce: int
    signature: Optional[Signature] = None


def format_tx(tx: Transaction) -> List[int]:
    """5- or 8-element field array (helpers.ts:60-73)."""
    base = [tx.from_index, tx.to_index, tx.amount, tx.fee, tx.nonce]
    if tx.signature is not None:
        return base + [tx.signature.R8[0], tx.signature.R8[1], tx.signature.S]
    return base


def serialize_tx(tx: Transaction) -> int:
    """multiHash(formatTx(tx)) (helpers.ts:75-78)."""
    return multi_hash(format_tx(tx))


def hash_balance_tree_leaf(leaf_data: Dict) -> int:
    """multiHash([pubX, pubY, balance, nonce]) (helpers.ts:80-82)."""
    return multi_hash([leaf_data["publicKey"][0], leaf_data["publicKey"][1],
                       leaf_data["balance"], leaf_data["nonce"]])


def assemble_batch_inputs(tree: MerkleTree, txs: List[Transaction]
                          ) -> Tuple[Dict, MerkleTree]:
    """Returns (circuitInputs dict for BatchProcessTx, final tree).

    The input tree must hold leavesRaw dicts {publicKey, balance, nonce};
    it is not mutated (copy-on-write like the reference's immutable
    update())."""
    m = tree
    inputs = {k: [] for k in (
        "balanceTreeRoot", "txData", "txSenderPublicKey", "txSenderBalance",
        "txSenderNonce", "txSenderPathElements", "txRecipientPublicKey",
        "txRecipientBalance", "txRecipientNonce", "txRecipientPathElements",
        "intermediateBalanceTreeRoot", "intermediateBalanceTreePathElements")}

    for tx in txs:
        if tx.signature is None:
            raise ValueError("transaction must be signed")
        sender_paths = m.get_update_path(tx.from_index)
        recipient_paths = m.get_update_path(tx.to_index)
        sender = dict(m.leaves_raw[tx.from_index])
        recipient = dict(m.leaves_raw[tx.to_index])

        # sender debit -> intermediate tree (operatorLogic.test.ts:128-138)
        ibtld = {"publicKey": sender["publicKey"],
                 "balance": sender["balance"] - tx.amount - tx.fee,
                 "nonce": sender["nonce"] + 1}
        m_inter = m.update(tx.from_index, hash_balance_tree_leaf(ibtld), ibtld)
        inter_paths = m_inter.get_update_path(tx.to_index)

        # recipient credit -> final tree (operatorLogic.test.ts:141-153);
        # self-send uses the debited sender state
        recv_state = dict(m_inter.leaves_raw[tx.to_index])
        fbtld = {"publicKey": recv_state["publicKey"],
                 "balance": recv_state["balance"] + tx.amount,
                 "nonce": recv_state["nonce"]}
        m_final = m_inter.update(tx.to_index, hash_balance_tree_leaf(fbtld),
                                 fbtld)

        inputs["balanceTreeRoot"].append(m.root)
        inputs["txData"].append(format_tx(tx))
        inputs["txSenderPublicKey"].append(list(sender["publicKey"]))
        inputs["txSenderBalance"].append(sender["balance"])
        inputs["txSenderNonce"].append(sender["nonce"])
        inputs["txSenderPathElements"].append(sender_paths.path_elements)
        inputs["txRecipientPublicKey"].append(list(recipient["publicKey"]))
        inputs["txRecipientBalance"].append(recipient["balance"])
        inputs["txRecipientNonce"].append(recipient["nonce"])
        inputs["txRecipientPathElements"].append(recipient_paths.path_elements)
        inputs["intermediateBalanceTreeRoot"].append(m_inter.root)
        inputs["intermediateBalanceTreePathElements"].append(
            inter_paths.path_elements)

        m = m_final

    return inputs, m
