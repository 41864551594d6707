"""The rollup circuits: ProcessTx / BatchProcessTx / Withdraw / helpers.

Re-designed equivalents of simple-zk-rollups/prover/circuits/*.circom with the
SAME public-signal ABI (73 signals for BatchProcessTx(2,6), 3 for Withdraw —
TxVerifier.sol:281, WithdrawVerifier.sol:211; allocation order = circom
convention: outputs, then inputs in declaration order) and the same
accept/reject behavior on honest inputs. Deviations (documented):

  - comparator gadgets range-check operands at 252 bits instead of using
    circomlib's GreaterThan(256) shift (soundness fix, see gadgets.py)
  - linear signals don't materialize R1CS variables, so constraint/variable
    counts differ from circom 0.0.35's output (we run our own Groth16 setup,
    so only the public ABI must match the reference contracts)
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence

from ..ref import babyjubjub as bjj
from ..config import (RollupConfig, TX_DATA_WITH_SIG_LENGTH,
                      TX_DATA_WITHOUT_SIG_LENGTH,
                      BALANCE_TREE_LEAF_DATA_LENGTH)
from .builder import Builder, LC
from . import gadgets as g

# txData indices (processtx.circom:33-40)
FROM, TO, AMOUNT, FEE, NONCE, R8X, R8Y, SIG_S = range(8)


def process_tx(bld: Builder, depth: int, balance_tree_root, tx_data,
               sender_pub, sender_balance, sender_nonce, sender_path,
               recipient_pub, recipient_balance, recipient_nonce,
               recipient_path, intermediate_root, intermediate_path) -> LC:
    """One L2 transfer (processtx.circom:10-193). Returns newBalanceTreeRoot."""
    sender_path_idx = g.num2bits(bld, tx_data[FROM], depth)
    recipient_path_idx = g.num2bits(bld, tx_data[TO], depth)

    # Step 1.1: signature over txData[0..4] (processtx.circom:73-82)
    valid_sig = g.verify_eddsa_signature(
        bld, sender_pub[0], sender_pub[1], tx_data[R8X], tx_data[R8Y],
        tx_data[SIG_S], [tx_data[i] for i in range(TX_DATA_WITHOUT_SIG_LENGTH)])
    bld.enforce_equal(valid_sig, 1)

    # Step 1.2: nonce, amount, fee (processtx.circom:85-95)
    bld.enforce_equal(tx_data[NONCE], sender_nonce + LC.const(1))
    g.num2bits(bld, tx_data[AMOUNT], 252)   # range checks (soundness)
    g.num2bits(bld, tx_data[FEE], 252)
    g.num2bits(bld, sender_balance, 252)
    bld.enforce_equal(g.is_zero(bld, tx_data[AMOUNT]), 0)
    bld.enforce_equal(g.is_zero(bld, tx_data[FEE]), 0)

    # Step 2: balance > amount + fee (processtx.circom:98-101)
    sufficient = g.greater_than(
        bld, sender_balance, tx_data[AMOUNT] + tx_data[FEE], n=253)
    bld.enforce_equal(sufficient, 1)

    # Step 3: both leaves exist in the current tree (processtx.circom:106-135)
    sender_leaf = g.mimc_multihash(
        bld, [sender_pub[0], sender_pub[1], sender_balance, sender_nonce])
    recipient_leaf = g.mimc_multihash(
        bld, [recipient_pub[0], recipient_pub[1], recipient_balance,
              recipient_nonce])
    g.merkle_leaf_exists(bld, sender_leaf, sender_path, sender_path_idx,
                         balance_tree_root)
    g.merkle_leaf_exists(bld, recipient_leaf, recipient_path,
                         recipient_path_idx, balance_tree_root)

    # Step 4: new leaves, self-send mux (processtx.circom:137-171)
    new_sender_balance = sender_balance - tx_data[AMOUNT] - tx_data[FEE]
    new_sender_leaf = g.mimc_multihash(
        bld, [sender_pub[0], sender_pub[1], new_sender_balance,
              tx_data[NONCE]])

    same = g.is_equal(bld, tx_data[FROM], tx_data[TO])
    sel_recipient_balance = g.mux1(bld, recipient_balance,
                                   new_sender_balance, same)
    sel_recipient_nonce = g.mux1(bld, recipient_nonce, tx_data[NONCE], same)
    new_recipient_leaf = g.mimc_multihash(
        bld, [recipient_pub[0], recipient_pub[1],
              sel_recipient_balance + tx_data[AMOUNT], sel_recipient_nonce])

    # Step 5: intermediate root check + final root (processtx.circom:173-192)
    computed_intermediate = g.merkle_root_from_path(
        bld, new_sender_leaf, sender_path, sender_path_idx)
    bld.enforce_equal(computed_intermediate, intermediate_root)

    final_root = g.merkle_root_from_path(
        bld, new_recipient_leaf, intermediate_path, recipient_path_idx)
    return final_root


@dataclass
class SynthesisResult:
    builder: Builder

    @property
    def r1cs(self):
        return self.builder.r1cs()

    @property
    def witness(self):
        return self.builder.witness()

    @property
    def public_signals(self):
        return self.builder.public_signals()


def synthesize_batch_process_tx(inputs: Dict, batch_size: int, depth: int,
                                check: bool = True,
                                record: bool = True) -> SynthesisResult:
    """BatchProcessTx(batchSize, depth) (batchprocesstx.circom:3-75).

    `inputs` uses the exact key set the reference assembles in
    operator/__tests__/operatorLogic.test.ts:199-221 (ints, already hashed/
    signed). Public-signal layout = [newBalanceTreeRoot] + inputs in
    declaration order = 73 signals at (2, 6)."""
    bld = Builder(check=check, record=record)
    b, d = batch_size, depth

    out_root = bld.alloc_output_deferred()

    pub = bld.alloc_public_input
    roots = [pub(inputs["balanceTreeRoot"][i]) for i in range(b)]
    tx_data = [[pub(inputs["txData"][i][j])
                for j in range(TX_DATA_WITH_SIG_LENGTH)] for i in range(b)]
    sender_pub = [[pub(inputs["txSenderPublicKey"][i][j]) for j in range(2)]
                  for i in range(b)]
    sender_balance = [pub(inputs["txSenderBalance"][i]) for i in range(b)]
    sender_nonce = [pub(inputs["txSenderNonce"][i]) for i in range(b)]
    sender_path = [[pub(inputs["txSenderPathElements"][i][j])
                    for j in range(d)] for i in range(b)]
    recipient_pub = [[pub(inputs["txRecipientPublicKey"][i][j])
                      for j in range(2)] for i in range(b)]
    recipient_balance = [pub(inputs["txRecipientBalance"][i]) for i in range(b)]
    recipient_nonce = [pub(inputs["txRecipientNonce"][i]) for i in range(b)]
    recipient_path = [[pub(inputs["txRecipientPathElements"][i][j])
                       for j in range(d)] for i in range(b)]
    inter_root = [pub(inputs["intermediateBalanceTreeRoot"][i])
                  for i in range(b)]
    inter_path = [[pub(inputs["intermediateBalanceTreePathElements"][i][j])
                   for j in range(d)] for i in range(b)]

    new_roots = []
    for i in range(b):
        new_roots.append(process_tx(
            bld, d, roots[i], tx_data[i], sender_pub[i], sender_balance[i],
            sender_nonce[i], sender_path[i], recipient_pub[i],
            recipient_balance[i], recipient_nonce[i], recipient_path[i],
            inter_root[i], inter_path[i]))

    # root continuity (batchprocesstx.circom:70-72)
    for i in range(1, b):
        bld.enforce_equal(roots[i], new_roots[i - 1])

    bld.bind_output(out_root, new_roots[b - 1])
    return SynthesisResult(bld)


def synthesize_withdraw(private_key: int, nullifier: int,
                        check: bool = True) -> SynthesisResult:
    """Withdraw (withdraw.circom:4-25): prove knowledge of the private key
    behind publicKey; nullifier is bound as a public input only. Public
    signals: [pubX, pubY, nullifier]."""
    bld = Builder(check=check)
    out_x = bld.alloc_output_deferred()
    out_y = bld.alloc_output_deferred()
    nul = bld.alloc_public_input(nullifier)
    priv = bld.alloc(private_key)

    px, py = public_key_derivation(bld, priv)

    # vestigial Hasher(3) kept for circuit parity (withdraw.circom:15-19:
    # its output is unused — nullifier binding is via the public input)
    g.mimc_multihash(bld, [px, py, nul])

    bld.bind_output(out_x, px)
    bld.bind_output(out_y, py)
    return SynthesisResult(bld)


def public_key_derivation(bld: Builder, priv) -> tuple:
    """pub = priv * Base8 (publickeyderivation.circom:5-27). `priv` must be
    the FORMATTED key (hashed/pruned/shifted — crypto.ts:58-76)."""
    priv_bits = g.num2bits(bld, priv, 253)
    return g.edwards_scalar_mul_fixed(bld, priv_bits, bjj.BASE8)


def synthesize_ecdh(private_key: int, public_key, check: bool = True
                    ) -> SynthesisResult:
    """Ecdh (ecdh.circom:6-27): sharedKey = (priv * pub).x. Unused by the
    mains; kept for component parity (SURVEY 2.1)."""
    bld = Builder(check=check)
    out = bld.alloc_output_deferred()
    pub_x = bld.alloc_public_input(public_key[0])
    pub_y = bld.alloc_public_input(public_key[1])
    priv = bld.alloc(private_key)

    priv_bits = g.num2bits(bld, priv, 253)
    shared = g.edwards_scalar_mul_any(bld, priv_bits, (pub_x, pub_y))
    bld.bind_output(out, shared[0])
    return SynthesisResult(bld)


def tx_circuit(inputs: Dict, cfg: RollupConfig, check: bool = True):
    """Production main: BatchProcessTx(cfg.batch_size, cfg.tree_depth)
    (tx.circom:4)."""
    return synthesize_batch_process_tx(
        inputs, cfg.batch_size, cfg.tree_depth, check=check)
