"""The "prove" entry loop: a closed loop with one proof in flight through the
operator's prover entry, as BatchDaemon makes its calls.

- circuit "batch_process_tx": TxProver.prove_prepared over a pool of
  `pool` prepared batches (made at set-up, each batch_size transfers valid
  on the freshly deposited state), cycled, with fresh (r, s) a proof;
- circuit "withdraw": WithdrawProver.prove_withdraw over `pool` private
  keys, cycled, with a fresh nullifier and fresh (r, s) a proof.

A call is timed from the entry's call to its return: the proof and its
self-verify (and for the withdraw circuit, its witness synthesis).

The check, after the window: the reference synthesizes each witness again
from the same inputs, compares the public signals, and works out every
proof of the window (or `check_max` of them drawn from the seed, the
slowest among them) from the setup seed's toxic scalars; a proof counts as
wrong unless A, B and C all equal the reference's.
"""

from __future__ import annotations

import random
import time
from typing import Dict, List

from .. import inputs
from ..reference import circuits as ref_circuits
from ..reference.groth16 import ProofReference
from . import common

WITHDRAW = "withdraw"
BATCH = "batch_process_tx"


class Entry:
    unit = "proof"

    def __init__(self, ctx):
        self.ctx = ctx
        self.config, self.mix, self.seed = ctx.config, ctx.mix, ctx.seed
        self.circuit = self.config["circuit"]
        if self.circuit not in (WITHDRAW, BATCH):
            raise ValueError(f"the prove loop has no circuit "
                             f"{self.circuit!r}")
        self.records: List[Dict] = []
        self.failures: List[str] = []

    # -- set-up ----------------------------------------------------------

    def setup(self) -> None:
        from zkrollup_torch.operator.prover import TxProver, WithdrawProver
        ctx, mix = self.ctx, self.mix
        kp, seed = common.key_path(ctx), common.setup_seed(self.config)
        if self.circuit == WITHDRAW:
            self.prover = WithdrawProver(key_path=kp, setup_seed=seed,
                                         device=ctx.device)
            self.keys = inputs.withdraw_keys(self.seed, mix["pool"])
            self.nullifiers = inputs.nullifiers(self.seed)
        else:
            from zkrollup_torch.chain.simulator import RollUpContract
            from zkrollup_torch.operator.state import OperatorState
            cfg = common.rollup_config(self.config)
            self.prover = TxProver(cfg, key_path=kp, setup_seed=seed,
                                   device=ctx.device)
            self.accts = inputs.accounts(self.seed, mix["accounts"],
                                         mix["deposit_wei"])
            contract = RollUpContract(cfg, tx_vk=None, withdraw_vk=None)
            state = OperatorState(cfg)
            common.deposit_all(contract, state, self.accts)
            self.batches = inputs.batch_pool(
                self.seed, self.accts, mix["pool"], cfg.batch_size, mix,
                cfg.min_fee)
            tree = state.load_tree()
            self.preps = [self.prover.prepare_batch(
                tree, [common.program_tx(t) for t in b])
                for b in self.batches]
            self.prep_signals = [p.public_signals for p in self.preps]
        self.prover.ensure_keys()
        self.blinding = inputs.blinding(self.seed)
        # every shape of the window once: the first call builds the
        # kernels (first run only) and caches the key's device tables
        for i in range(mix["warmup_calls"]):
            self._call(-1 - i, *next(self.blinding))
        self.ctx.sync()

    # -- the window ------------------------------------------------------

    def _call(self, i: int, r: int, s: int) -> Dict:
        rec = {"i": i, "r": r, "s": s}
        if self.circuit == WITHDRAW:
            rec["key"] = i % len(self.keys)
            rec["nullifier"] = next(self.nullifiers)
            proof, signals = self.prover.prove_withdraw(
                self.keys[rec["key"]], rec["nullifier"], r, s)
            rec["signals"] = signals
        else:
            rec["batch"] = i % len(self.preps)
            proof = self.prover.prove_prepared(self.preps[rec["batch"]],
                                               r, s)
        rec["proof"] = (proof.a, proof.b, proof.c)
        st = self.prover.stats
        rec.update(prove_s=st.prove_s, verify_s=st.verify_s,
                   witness_s=st.witness_s)
        return rec

    def run(self, seconds: float, tracer=None) -> float:
        """Proofs, one at a time, until `seconds` have passed (and the
        traced window is whole); returns the window's seconds: from its
        start to the end of its last proof."""
        from torch.profiler import record_function
        if tracer:
            tracer.open()
        t0 = time.perf_counter()
        deadline, end, i = t0 + seconds, t0, 0
        try:
            while time.perf_counter() < deadline or (tracer and tracer.busy):
                r, s = next(self.blinding)
                traced = bool(tracer) and tracer.started(i)
                a = time.perf_counter()
                try:
                    with record_function("rollbench.call"):
                        rec = self._call(i, r, s)
                except Exception as e:  # a proof that never comes: counted
                    self.failures.append(f"call {i}: {e!r}")
                    rec = {"i": i, "proof": None}
                end = time.perf_counter()
                rec.update(latency_s=end - a, traced=traced)
                self.records.append(rec)
                if tracer:
                    tracer.finished(i)
                i += 1
        finally:
            if tracer:
                tracer.close()
        return end - t0

    def release(self) -> None:
        self.prover = self.preps = None

    # -- the check -------------------------------------------------------

    def _sample(self) -> List[Dict]:
        done = [r for r in self.records if r["proof"] is not None]
        cap = self.mix["check_max"]
        if len(done) <= cap:
            return done
        slowest = max(done, key=lambda r: r["latency_s"])
        rest = [r for r in done if r is not slowest]
        pick = random.Random(f"{self.seed}/check").sample(rest, cap - 1)
        return sorted([slowest] + pick, key=lambda r: r["i"])

    def check(self, control: bool = False) -> List[tuple]:
        """[(name, value, limit)]: public signals and proofs unlike the
        reference's, and calls whose proof never came. control=True puts
        the reference's own proof with the quotient left out in the
        program's place."""
        sample = self._sample()
        signals_wrong = proofs_wrong = 0
        if self.circuit == WITHDRAW:
            ref = ProofReference(
                ref_circuits.synthesize_withdraw(self.keys[0], 1).r1cs,
                common.setup_seed(self.config))
            for rec in sample:
                res = ref_circuits.synthesize_withdraw(
                    self.keys[rec["key"]], rec["nullifier"])
                signals_wrong += rec["signals"] != res.public_signals
                want = ref.proof(ref.scalars(res.witness), rec["r"], rec["s"])
                got = (ref.proof(ref.scalars(res.witness, quotient=False),
                                 rec["r"], rec["s"]) if control
                       else rec["proof"])
                proofs_wrong += got != want
        else:
            tree = common.reference_tree(self.config, self.accts)
            ref, wits = None, []
            for b, txs in enumerate(self.batches):
                res, final = common.reference_batch(self.config, tree, txs,
                                                    record=b == 0)
                if ref is None:
                    ref = ProofReference(res.r1cs,
                                         common.setup_seed(self.config))
                sig = res.public_signals
                if sig[0] != final.root:
                    raise RuntimeError("the reference's circuit and tree "
                                       "disagree on the new root")
                signals_wrong += sig != self.prep_signals[b]
                wits.append(res.witness)
            scal = [ref.scalars(w, quotient=not control) for w in wits]
            for rec in sample:
                got = (ref.proof(scal[rec["batch"]], rec["r"], rec["s"])
                       if control else rec["proof"])
                want = ref.proof(ref.scalars(wits[rec["batch"]]) if control
                                 else scal[rec["batch"]], rec["r"], rec["s"])
                proofs_wrong += got != want
        self.checked = len(sample)
        return [("signals_wrong", signals_wrong, 0),
                ("proofs_wrong", proofs_wrong, 0),
                ("proofs_missing", len(self.failures), 0)]
