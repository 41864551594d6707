"""The host witness stage of one BatchProcessTx batch: input assembly from
the tree snapshot, then the witness-only synthesis of the circuit.

A function of (cfg, tree, txs) alone, so that BatchDaemon.run_pipeline can
run it in a worker process of its own, out of the interpreter lock that the
proof's host work holds; TxProver.prepare_batch runs it in its caller's
process. This module imports only the port's host modules (config, r1cs,
witness, tree, ref), never torch: a worker that imports it never touches
the card.
"""

from __future__ import annotations

import time
from typing import List

from ..config import RollupConfig
from ..r1cs.circuits import synthesize_batch_process_tx
from ..tree.merkle import MerkleTree
from .assembler import Transaction, assemble_batch_inputs


def prepare_fields(cfg: RollupConfig, tree: MerkleTree,
                   txs: List[Transaction]) -> dict:
    """The fields of operator.prover.PreparedBatch but txs: the witness,
    the public signals, the post-batch tree and the stage's seconds
    (assemble_s, synth_s and their sum witness_s)."""
    t0 = time.perf_counter()
    inputs, final_tree = assemble_batch_inputs(tree, txs)
    t1 = time.perf_counter()
    res = synthesize_batch_process_tx(inputs, cfg.batch_size,
                                      cfg.tree_depth, record=False)
    t2 = time.perf_counter()
    return {"witness": res.witness, "public_signals": res.public_signals,
            "final_tree": final_tree, "witness_s": t2 - t0,
            "assemble_s": t1 - t0, "synth_s": t2 - t1}
