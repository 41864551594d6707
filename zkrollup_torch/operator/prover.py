"""BatchProcessTx proof service for the operator: key management, the host
witness stage and the device prove stage with its mandatory self-verify.

Counterpart of TxProver and PreparedBatch in zkrollup/operator/prover.py;
circuit synthesis and input assembly are the port's copies of zkrollup's
(r1cs.circuits, witness.assembler).
"""

from __future__ import annotations

import os
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ..config import RollupConfig
from ..r1cs.circuits import synthesize_batch_process_tx
from ..tree.merkle import MerkleTree
from ..witness.assembler import Transaction, assemble_batch_inputs
from ..groth16.keys import ProvingKey, Proof, r1cs_digest
from ..groth16.prove import prove
from ..groth16.setup import setup
from ..groth16.verify import verify


def _dummy_tx_inputs(batch_size: int, depth: int) -> Dict:
    """All-zero inputs for structure-only synthesis (check=False): the
    constraint structure is input-independent, so this yields the exact
    R1CS the setup binds."""
    z, d, b = 0, depth, batch_size
    return {
        "balanceTreeRoot": [z] * b,
        "txData": [[z] * 8 for _ in range(b)],
        "txSenderPublicKey": [[z, z] for _ in range(b)],
        "txSenderBalance": [z] * b,
        "txSenderNonce": [z] * b,
        "txSenderPathElements": [[z] * d for _ in range(b)],
        "txRecipientPublicKey": [[z, z] for _ in range(b)],
        "txRecipientBalance": [z] * b,
        "txRecipientNonce": [z] * b,
        "txRecipientPathElements": [[z] * d for _ in range(b)],
        "intermediateBalanceTreeRoot": [z] * b,
        "intermediateBalanceTreePathElements": [[z] * d for _ in range(b)],
    }


@dataclass
class ProveStats:
    """Seconds per stage of the last proof (stages: see groth16.prove)."""
    witness_s: float = 0.0
    prove_s: float = 0.0
    verify_s: float = 0.0
    stages: Dict[str, float] = field(default_factory=dict)


@dataclass
class PreparedBatch:
    """Output of the host witness stage, input of the device prove stage."""
    txs: List[Transaction]
    witness: List[int]
    public_signals: List[int]
    final_tree: MerkleTree
    witness_s: float = 0.0


class TxProver:
    """BatchProcessTx(batch, depth) prover with cached keys, proving on
    `device` with Pippenger window `c`; glv and tree go to groth16.prove
    (the GLV G1 MSMs, the bucket strategy)."""

    def __init__(self, cfg: RollupConfig, key_path: Optional[str] = None,
                 setup_seed: Optional[bytes] = None, *, device="cuda",
                 c: int = 12, glv: bool = False, tree: str = "scan"):
        self.cfg = cfg
        self.key_path = key_path
        self.setup_seed = setup_seed
        self.device = device
        self.c = c
        self.glv = glv
        self.tree = tree
        self.pk: Optional[ProvingKey] = None
        self.stats = ProveStats()
        self._r1cs = None

    def structure(self):
        return synthesize_batch_process_tx(
            _dummy_tx_inputs(self.cfg.batch_size, self.cfg.tree_depth),
            self.cfg.batch_size, self.cfg.tree_depth, check=False)

    def structure_r1cs(self):
        if self._r1cs is None:
            self._r1cs = self.structure().r1cs
        return self._r1cs

    def ensure_keys(self) -> ProvingKey:
        """The cached key when its R1CS digest matches, else a new key from
        the setup on this prover's device (saved to key_path if given)."""
        if self.pk is not None:
            return self.pk
        r1cs = self.structure_r1cs()
        if self.key_path and os.path.exists(self.key_path):
            pk = ProvingKey.load(self.key_path)
            if pk.r1cs_digest and pk.r1cs_digest == r1cs_digest(r1cs):
                self.pk = pk
                return pk
            print(f"WARNING: cached proving key {self.key_path} has a stale "
                  "R1CS digest; regenerating. Verifiers deployed from the old "
                  "key are now invalid.", file=sys.stderr)
        self.pk = setup(r1cs, seed=self.setup_seed, device=self.device)
        if self.key_path:
            os.makedirs(os.path.dirname(os.path.abspath(self.key_path)),
                        exist_ok=True)
            self.pk.save(self.key_path)
        return self.pk

    def prepare_batch(self, tree: MerkleTree,
                      txs: List[Transaction]) -> PreparedBatch:
        """Host stage: assemble inputs from the tree snapshot and replay the
        witness-only synthesis."""
        t0 = time.time()
        inputs, final_tree = assemble_batch_inputs(tree, txs)
        res = synthesize_batch_process_tx(
            inputs, self.cfg.batch_size, self.cfg.tree_depth, record=False)
        self.stats.witness_s = time.time() - t0
        return PreparedBatch(txs=txs, witness=res.witness,
                             public_signals=res.public_signals,
                             final_tree=final_tree,
                             witness_s=self.stats.witness_s)

    def prove_prepared(self, prep: PreparedBatch, r: Optional[int] = None,
                       s: Optional[int] = None) -> Proof:
        """Device stage: prove, then the mandatory self-verify."""
        pk = self.ensure_keys()
        stages: Dict[str, float] = {}
        t0 = time.time()
        proof = prove(pk, self.structure_r1cs(), prep.witness, r=r, s=s,
                      device=self.device, c=self.c, glv=self.glv,
                      tree=self.tree, timings=stages)
        self.stats.prove_s = time.time() - t0
        self.stats.stages = stages
        t0 = time.time()
        if not verify(pk.vk, proof, prep.public_signals):
            raise RuntimeError("Invalid proof generated")
        self.stats.verify_s = time.time() - t0
        return proof
