"""The "operator" entry loop: BatchDaemon.run_pipeline draining a backlog.

At set-up the accounts deposit on the contract (the daemon's state follows
its events), `txs` signed transfers fill an in-memory TxQueue, and a first
run_pipeline(max_batches=warmup_batches) on the head of that queue spawns
and warms the witness worker, builds the kernels and caches the key's
device tables. The window is one run_pipeline call with the daemon's
default queue_depth: the witness in its worker process, proofs with their
self-verify, roll_up (its pairing check) on the contract and the state's
update, in order. At the window's close the queue stops handing out
batches (the traffic ends), the daemon settles what it had prepared and
returns. A batch counts when the state has applied it; the window runs
from the call to the last batch applied.

The check, after the window: the reference replays every settled transfer
(the warm-up's too) on its own state and tree, and compares each
account's balance and nonce in the operator's tree and on the contract,
both roots, the accrued fees and the contract's RollUpProcessed roots,
one by one.
"""

from __future__ import annotations

import time
from typing import Dict, List

from .. import inputs
from ..reference import assembler as ref_asm
from . import common


class Entry:
    unit = "batch"

    def __init__(self, ctx):
        self.ctx = ctx
        self.config, self.mix, self.seed = ctx.config, ctx.mix, ctx.seed
        self.records: List[Dict] = []
        self.failures: List[str] = []
        self.tracer = None

    def setup(self) -> None:
        from zkrollup_torch.chain.simulator import RollUpContract
        from zkrollup_torch.operator.batchd import BatchDaemon
        from zkrollup_torch.operator.prover import TxProver
        from zkrollup_torch.operator.queue import TxQueue
        from zkrollup_torch.operator.state import OperatorState
        from torch.profiler import record_function

        loop = self

        class Queue(TxQueue):
            """Hands out no batch once the window has closed."""
            deadline = None

            def peek_batch(self, *a, **k):
                if self.deadline is not None and \
                        time.perf_counter() >= self.deadline:
                    return None
                return super().peek_batch(*a, **k)

        class Prover(TxProver):
            def prove_prepared(self, prep, r=None, s=None):
                i = len(loop.records)
                rec = {"i": i, "witness_s": prep.witness_s,
                       "traced": bool(loop.tracer)
                       and loop.tracer.started(i)}
                loop.records.append(rec)
                a = time.perf_counter()
                with record_function("rollbench.call"):
                    proof = super().prove_prepared(prep, r, s)
                rec.update(prove_s=self.stats.prove_s,
                           verify_s=self.stats.verify_s,
                           latency_s=time.perf_counter() - a,
                           txs=len(prep.txs))
                return proof

        class Contract(RollUpContract):
            def roll_up(self, proof, inputs):
                with record_function("rollbench.roll_up"):
                    return super().roll_up(proof, inputs)

        class State(OperatorState):
            def apply_rollup_batch(self, final_tree):
                with record_function("rollbench.apply"):
                    super().apply_rollup_batch(final_tree)
                if loop.records:
                    rec = loop.records[-1]
                    rec["settled_at"] = time.perf_counter()
                    if loop.tracer:
                        loop.tracer.finished(rec["i"])

        ctx, mix = self.ctx, self.mix
        cfg = common.rollup_config(self.config)
        prover = Prover(cfg, key_path=common.key_path(ctx),
                        setup_seed=common.setup_seed(self.config),
                        device=ctx.device)
        pk = prover.ensure_keys()
        self.contract = Contract(cfg, tx_vk=pk.vk, withdraw_vk=None)
        self.state = State(cfg)
        self.queue = Queue()
        self.accts = inputs.accounts(self.seed, mix["accounts"],
                                     mix["deposit_wei"])
        common.deposit_all(self.contract, self.state, self.accts)
        self.txs = inputs.transfers(self.seed, self.accts, mix["txs"], mix,
                                    cfg.min_fee)
        for t in self.txs:
            self.queue.push(common.program_tx(t))
        self.daemon = BatchDaemon(cfg, self.state, self.queue, prover,
                                  self.contract)
        self.kw = ({"queue_depth": mix["queue_depth"]}
                   if mix.get("queue_depth") else {})
        warm = self.daemon.run_pipeline(max_batches=mix["warmup_batches"],
                                        **self.kw)
        if warm != mix["warmup_batches"]:
            raise RuntimeError(f"the warm-up settled {warm} batches")
        self.records.clear()
        ctx.sync()

    def run(self, seconds: float, tracer=None) -> float:
        self.tracer = tracer
        batches = self.queue.pending_count() // self.config["batch_size"]
        if tracer:
            tracer.open()
        t0 = time.perf_counter()
        self.queue.deadline = t0 + seconds
        try:
            self.daemon.run_pipeline(max_batches=batches, **self.kw)
        except Exception as e:  # the batches it settled still count
            self.failures.append(repr(e))
        finally:
            self.daemon.close()
            if tracer:
                tracer.close()
        if tracer and tracer.busy:
            self.failures.append("the traced window never closed whole")
        settled = [r for r in self.records if "settled_at" in r]
        return (settled[-1]["settled_at"] if settled
                else time.perf_counter()) - t0

    def release(self) -> None:
        self.daemon = None

    def check(self, control: bool = False) -> List[tuple]:
        """[("state_wrong", items unlike the reference's, 0),
        ("batches_missing", batches begun and never settled, 0)].
        control=True leaves the last settled batch's recipient credits out
        of the reference replayed in the program's place."""
        b = self.config["batch_size"]
        n = self.queue.last_processed
        tree = common.reference_tree(self.config, self.accts)
        bal = [a["deposit"] for a in self.accts]
        nonce = [0] * len(self.accts)
        roots, fees = [], 0
        for k in range(0, n, b):
            txs = [common.reference_tx(t) for t in self.txs[k:k + b]]
            _inputs, tree = ref_asm.assemble_batch_inputs(tree, txs)
            for t in txs:
                bal[t.from_index] -= t.amount + t.fee
                nonce[t.from_index] = t.nonce
                if not (control and k == n - b):
                    bal[t.to_index] += t.amount
                fees += t.fee
            roots.append(tree.root)
        got = self.state.load_tree()
        users = self.contract.users
        keys = self.contract.balance_tree_keys
        wrong = 0
        for i in range(len(self.accts)):
            leaf = got.get_leaf_raw(i)
            u = users[keys[i]]
            wrong += (leaf["balance"], leaf["nonce"]) != (bal[i], nonce[i])
            wrong += (u.balance, u.nonce) != (bal[i], nonce[i])
            wrong += ref_asm.hash_balance_tree_leaf(
                {"publicKey": list(self.accts[i]["pub"]), "balance": bal[i],
                 "nonce": nonce[i]}) != got.leaves[i]
        final = roots[-1] if roots else tree.root
        wrong += got.root != final
        wrong += self.contract.balance_tree.get_root() != final
        wrong += self.contract.accrued_fees != fees
        events = [e.args["newRoot"] for e in self.contract.events
                  if e.name == "RollUpProcessed"]
        wrong += events != roots
        begun = len(self.records)
        missing = begun - sum("settled_at" in r for r in self.records)
        self.checked = n // b
        return [("state_wrong", int(wrong), 0),
                ("batches_missing", missing + len(self.failures), 0)]
