"""The host witness stage of one BatchProcessTx batch: input assembly from
the tree snapshot, then the witness-only synthesis of the circuit.

A function of (cfg, tree, txs) alone, so that BatchDaemon.run_pipeline can
run it in a worker process of its own, out of the interpreter lock that the
proof's host work holds; TxProver.prepare_batch runs it in its caller's
process. This module imports only the port's host modules (config, r1cs,
witness, tree, ref, spans), never torch: a worker that imports it never
touches the card.
"""

from __future__ import annotations

from typing import List

from ..config import RollupConfig
from ..r1cs.circuits import synthesize_batch_process_tx
from ..spans import span, trace
from ..tree.merkle import MerkleTree
from .assembler import Transaction, assemble_batch_inputs


def prepare_fields(cfg: RollupConfig, tree: MerkleTree,
                   txs: List[Transaction]) -> dict:
    """The fields of operator.prover.PreparedBatch but txs and trace: the
    witness, the public signals, the post-batch tree, the stage's seconds
    (assemble_s, synth_s and their sum witness_s) and its spans:
    witness.prepare (witness_s) over witness.assemble (assemble_s) and
    witness.synth (synth_s), with the circuit's synth.signature and
    synth.tree under it, in the trace open on this thread or a new one."""
    with trace() as batch:
        with span("witness.prepare") as whole:
            with span("witness.assemble") as assemble:
                inputs, final_tree = assemble_batch_inputs(tree, txs)
            with span("witness.synth") as synth:
                res = synthesize_batch_process_tx(
                    inputs, cfg.batch_size, cfg.tree_depth, record=False)
    return {"witness": res.witness, "public_signals": res.public_signals,
            "final_tree": final_tree, "witness_s": whole.seconds,
            "assemble_s": assemble.seconds, "synth_s": synth.seconds,
            "spans": batch.spans()}
