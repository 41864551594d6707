"""Proof services for the operator: key management, the host witness stage
and the prove stage with its mandatory self-verify, for the BatchProcessTx
circuit (TxProver) and the withdraw circuit (WithdrawProver).

Counterpart of zkrollup/operator/prover.py; circuit synthesis and input
assembly are the port's copies of zkrollup's (r1cs.circuits,
witness.assembler). Each prover takes `backend`: "device" proves with
groth16.prove and makes keys with groth16.setup on `device`; "host" proves
with prove_host and makes keys with setup_host on the native engine (the
reference's host backend). Nothing chooses the host on its own: a prover
asked for the device and given no card raises.
"""

from __future__ import annotations

import os
import sys
from dataclasses import dataclass, field
from typing import Dict, Hashable, List, Optional, Tuple

from .. import spans
from ..config import RollupConfig
from ..r1cs.circuits import synthesize_batch_process_tx, synthesize_withdraw
from ..tree.merkle import MerkleTree
from ..witness.assembler import Transaction
from ..witness.batch import prepare_fields
from ..groth16.keys import ProvingKey, Proof, r1cs_digest
from ..groth16.prove import prove, prove_host
from ..groth16.setup import setup, setup_host
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


BACKENDS = ("device", "host")


def _check_backend(backend: str) -> str:
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, not "
                         f"{backend!r}")
    return backend


def _load_or_setup(key_path: Optional[str], r1cs, seed: Optional[bytes],
                   backend: str, device) -> ProvingKey:
    """The cached key at key_path when its R1CS digest matches r1cs, else a
    new key (setup on `device`, or setup_host), saved to key_path if given
    (its directory created). A discarded cache is not silent: the new key
    comes from fresh toxic waste unless seeded, so verifiers deployed from
    the old key reject every proof of the new one."""
    if key_path and os.path.exists(key_path):
        pk = ProvingKey.load(key_path)
        if pk.r1cs_digest and pk.r1cs_digest == r1cs_digest(r1cs):
            return pk
        print(f"WARNING: cached proving key {key_path} has a stale R1CS "
              "digest; regenerating. Verifiers deployed from the old key "
              "are now invalid: redeploy them from the new VK.",
              file=sys.stderr)
    if backend == "host":
        pk = setup_host(r1cs, seed=seed)
    else:
        pk = setup(r1cs, seed=seed, device=device)
    if key_path:
        os.makedirs(os.path.dirname(os.path.abspath(key_path)),
                    exist_ok=True)
        pk.save(key_path)
    return pk


@dataclass
class ProveStats:
    """The last proof's seconds from its spans: `stages` by span name
    (summed over the spans of one name), prove_s its groth16.prove,
    verify_s its groth16.verify; witness_s the witness of the batch last
    prepared (PreparedBatch.witness_s) or of the last withdraw proof (its
    witness.synth)."""
    witness_s: float = 0.0
    prove_s: float = 0.0
    verify_s: float = 0.0
    stages: Dict[str, float] = field(default_factory=dict)

    def take(self, found: List[spans.Span]) -> None:
        """prove_s, verify_s and stages from the spans of one proof."""
        self.stages = {}
        for s in found:
            self.stages[s.name] = self.stages.get(s.name, 0.0) + s.seconds
        self.prove_s = self.stages.get("groth16.prove", 0.0)
        self.verify_s = self.stages.get("groth16.verify", 0.0)


@dataclass
class PreparedBatch:
    """Output of the host witness stage, input of the device prove stage;
    witness_s is assemble_s (the inputs from the tree) plus synth_s (the
    witness-only synthesis), the seconds of its spans witness.prepare,
    witness.assemble and witness.synth; `spans` those spans and the
    circuit's under them, `trace` the batch's trace id."""
    txs: List[Transaction]
    witness: List[int]
    public_signals: List[int]
    final_tree: MerkleTree
    witness_s: float = 0.0
    assemble_s: float = 0.0
    synth_s: float = 0.0
    spans: List[spans.Span] = field(default_factory=list)
    trace: Optional[Hashable] = None


def _self_verify(vk, proof: Proof, public_signals: List[int]) -> None:
    """The mandatory self-verify, under the span groth16.verify."""
    with spans.span("groth16.verify"):
        ok = verify(vk, proof, public_signals)
    if not ok:
        raise RuntimeError("Invalid proof generated")


class TxProver:
    """BatchProcessTx(batch, depth) prover with cached keys, proving on
    `device` with Pippenger window `c` (backend "device"), or on the native
    engine (backend "host")."""

    def __init__(self, cfg: RollupConfig, key_path: Optional[str] = None,
                 setup_seed: Optional[bytes] = None, *, device="cuda",
                 backend: str = "device", c: int = 12):
        self.cfg = cfg
        self.key_path = key_path
        self.setup_seed = setup_seed
        self.device = device
        self.backend = _check_backend(backend)
        self.c = c
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

    # the reference's name (zkrollup/operator/prover.py:100)
    _structure_r1cs = structure_r1cs

    def ensure_keys(self) -> ProvingKey:
        """The cached key when its R1CS digest matches, else a new key from
        this prover's backend (saved to key_path if given)."""
        if self.pk is None:
            self.pk = _load_or_setup(self.key_path, self.structure_r1cs(),
                                     self.setup_seed, self.backend,
                                     self.device)
        return self.pk

    # The host stage as a function of (cfg, tree, txs) alone:
    # BatchDaemon.run_pipeline runs it in its worker process.
    host_stage = staticmethod(prepare_fields)

    def prepare_batch(self, tree: MerkleTree,
                      txs: List[Transaction]) -> PreparedBatch:
        """Host stage, in this process: assemble inputs from the tree
        snapshot and replay the witness-only synthesis, in the caller's
        trace or a new one (its spans are in this process's ring)."""
        with spans.trace() as batch:
            prep = PreparedBatch(txs=txs, trace=batch.trace,
                                 **self.host_stage(self.cfg, tree, txs))
        self.stats.witness_s = prep.witness_s
        return prep

    def prove_prepared(self, prep: PreparedBatch, r: Optional[int] = None,
                       s: Optional[int] = None) -> Proof:
        """Device stage: prove, then the mandatory self-verify, in the
        caller's trace or a new one; stats from the proof's spans."""
        pk = self.ensure_keys()
        with spans.trace() as proof_trace:
            if self.backend == "host":
                proof = prove_host(pk, self.structure_r1cs(), prep.witness,
                                   r=r, s=s)
            else:
                proof = prove(pk, self.structure_r1cs(), prep.witness, r=r,
                              s=s, device=self.device, c=self.c)
            _self_verify(pk.vk, proof, prep.public_signals)
        self.stats.take(proof_trace.spans())
        return proof

    def prove_batch(self, tree: MerkleTree, txs: List[Transaction],
                    r: Optional[int] = None, s: Optional[int] = None
                    ) -> Tuple[Proof, List[int], MerkleTree]:
        """Assemble inputs from the tree snapshot, synthesize the witness,
        prove, self-verify, in one trace (the caller's or a new one).
        Returns (proof, public inputs, final tree)."""
        self.ensure_keys()
        with spans.trace():
            prep = self.prepare_batch(tree, txs)
            proof = self.prove_prepared(prep, r=r, s=s)
        return proof, prep.public_signals, prep.final_tree


class WithdrawProver:
    """Withdraw-circuit prover with cached keys: knowledge of the private
    key behind a public key, with a nullifier (4 public signals). `device`,
    `backend` and `c` as for TxProver."""

    def __init__(self, key_path: Optional[str] = None,
                 setup_seed: Optional[bytes] = None, *, device="cuda",
                 backend: str = "device", c: int = 12):
        self.key_path = key_path
        self.setup_seed = setup_seed
        self.device = device
        self.backend = _check_backend(backend)
        self.c = c
        self.pk: Optional[ProvingKey] = None
        self.stats = ProveStats()
        self._r1cs = None

    def structure_r1cs(self):
        if self._r1cs is None:
            self._r1cs = synthesize_withdraw(0, 0, check=False).r1cs
        return self._r1cs

    def ensure_keys(self) -> ProvingKey:
        """The cached key when its R1CS digest matches, else a new key from
        this prover's backend (saved to key_path if given)."""
        if self.pk is None:
            self.pk = _load_or_setup(self.key_path, self.structure_r1cs(),
                                     self.setup_seed, self.backend,
                                     self.device)
        return self.pk

    def prove_withdraw(self, formatted_priv_key: int, nullifier: int,
                       r: Optional[int] = None, s: Optional[int] = None
                       ) -> Tuple[Proof, List[int]]:
        """Synthesize the witness, prove, self-verify. Returns (proof,
        public signals). The proof is made against the cached structure
        (the circuit is static), so its COO matrices are built, and copied
        to the device, once per prover and not once per proof. The
        witness is the span witness.synth; the proof's spans are in the
        caller's trace or a new one, and give the stats."""
        pk = self.ensure_keys()
        r1cs = self.structure_r1cs()
        with spans.trace() as proof_trace:
            with spans.span("witness.synth"):
                res = synthesize_withdraw(formatted_priv_key, nullifier)
            if self.backend == "host":
                proof = prove_host(pk, r1cs, res.witness, r=r, s=s)
            else:
                proof = prove(pk, r1cs, res.witness, r=r, s=s,
                              device=self.device, c=self.c)
            _self_verify(pk.vk, proof, res.public_signals)
        self.stats.take(proof_trace.spans())
        self.stats.witness_s = self.stats.stages.get("witness.synth", 0.0)
        return proof, res.public_signals
