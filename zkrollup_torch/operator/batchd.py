"""The batch-prover daemon: queue -> batch -> proof -> rollUp() -> state sync.

This is the component the reference implies but never ships: its redis queue
is written by /send and never drained — the prove+submit loop exists only
inside operator/__tests__/operatorLogic.test.ts (SURVEY §2.2 vestigial
note). Here it is first-class: deterministic single-writer loop, fail-fast
re-prove semantics (proving is stateless given tree snapshot + key —
SURVEY §5 failure-handling obligation), metrics counters.
"""

from __future__ import annotations

import multiprocessing
import threading
import time
from concurrent.futures import ProcessPoolExecutor
from concurrent.futures.process import BrokenProcessPool
from dataclasses import dataclass, field
from typing import Optional

from .. import spans
from ..config import RollupConfig
from ..chain.simulator import RollUpContract
from .state import OperatorState
from .queue import TxQueue
from .prover import PreparedBatch, TxProver


@dataclass
class BatchMetrics:
    """proofs/s and friends — the BASELINE.json headline counters
    (SURVEY §5 metrics obligation). last_prove_seconds: the last batch's
    groth16.prove and groth16.verify spans."""
    batches_proven: int = 0
    txs_processed: int = 0
    proofs_failed: int = 0
    last_prove_seconds: float = 0.0
    first_prove_at: Optional[float] = None     # time.perf_counter()
    last_settled_at: Optional[float] = None

    def proving(self) -> None:
        """A batch's prove starts (the first one starts the clock)."""
        if self.first_prove_at is None:
            self.first_prove_at = time.perf_counter()

    def proved(self, found) -> None:
        """last_prove_seconds from the spans of the batch's trace."""
        self.last_prove_seconds = sum(
            s.seconds for s in found
            if s.name in ("groth16.prove", "groth16.verify"))

    def settled(self, txs: int) -> None:
        self.batches_proven += 1
        self.txs_processed += txs
        self.last_settled_at = time.perf_counter()

    @property
    def proofs_per_second(self) -> float:
        """Batches settled over the seconds from the first batch's prove
        start to the last batch's settle."""
        if self.first_prove_at is None or self.last_settled_at is None:
            return 0.0
        wall = self.last_settled_at - self.first_prove_at
        return self.batches_proven / wall if wall > 0 else 0.0

    def snapshot(self) -> dict:
        return {
            "batches_proven": self.batches_proven,
            "txs_processed": self.txs_processed,
            "proofs_failed": self.proofs_failed,
            "last_prove_seconds": self.last_prove_seconds,
            "proofs_per_second": self.proofs_per_second,
        }


class BatchDaemon:
    def __init__(self, cfg: RollupConfig, state: OperatorState,
                 queue: TxQueue, prover: TxProver,
                 contract: RollUpContract):
        self.cfg = cfg
        self.state = state
        self.queue = queue
        self.prover = prover
        self.contract = contract
        self.metrics = BatchMetrics()
        # single-writer guard: step() is reachable both from the serve
        # loop (--auto-batch) and from per-request /admin/prove-batch
        # threads (ThreadingHTTPServer); without it two concurrent steps
        # peek the same batch and double-submit/double-mark.
        self._step_lock = threading.Lock()
        # run_pipeline's witness worker: one process, spawned on first use
        # and kept until close()
        self._witness_pool: Optional[ProcessPoolExecutor] = None

    def close(self) -> None:
        """Shut down run_pipeline's witness worker process, after the batch
        it may be preparing (a later run_pipeline starts a new one)."""
        pool, self._witness_pool = self._witness_pool, None
        if pool is not None:
            pool.shutdown(wait=True, cancel_futures=True)

    def _witness_worker(self) -> ProcessPoolExecutor:
        # spawn, never fork: this process has threads and may have started
        # CUDA
        if self._witness_pool is None:
            self._witness_pool = ProcessPoolExecutor(
                max_workers=1,
                mp_context=multiprocessing.get_context("spawn"))
        return self._witness_pool

    def step(self) -> bool:
        """Process one batch if enough txs are queued. Returns True if a
        batch was submitted. Non-blocking single-writer: if another step
        is already in flight this call is a no-op returning False."""
        if not self._step_lock.acquire(blocking=False):
            return False
        try:
            return self._step_locked()
        finally:
            self._step_lock.release()

    def _step_locked(self) -> bool:
        txs = self.queue.peek_batch(self.cfg.batch_size)
        if txs is None:
            return False

        tree = self.state.load_tree()
        self.metrics.proving()
        with spans.trace() as batch:
            try:
                proof, public_inputs, final_tree = self.prover.prove_batch(
                    tree, txs)
            except Exception:
                # fail-fast: proving is stateless, the batch stays queued
                # for re-prove; surface the failure in metrics
                self.metrics.proofs_failed += 1
                raise
        self.metrics.proved(batch.spans())

        # submit on-chain; the contract replays txData and updates its tree
        self.contract.roll_up(proof, public_inputs)

        # mark processed + persist the operator mirror
        self.queue.mark_processed(len(txs))
        self.state.apply_rollup_batch(final_tree)
        self.metrics.settled(len(txs))
        return True

    def run(self, poll_interval: float = 1.0, max_batches: Optional[int] = None):
        """Continuous loop (config 5's per-host loop)."""
        done = 0
        while max_batches is None or done < max_batches:
            if self.step():
                done += 1
            else:
                time.sleep(poll_interval)

    def run_pipeline(self, max_batches: Optional[int] = None,
                     queue_depth: int = 2,
                     poll_interval: float = 0.2) -> int:
        """DP pipeline (BASELINE config 5, VERDICT r4 #7): witness
        synthesis for batch i+1 overlaps proving of batch i.

        Correctness: the balance tree chains batch-to-batch through input
        ASSEMBLY (the host stage returns the post-batch tree), not through
        the proof. A feeder thread reads the queue ahead along the
        projected tree and hands each batch to the witness worker, a
        spawned process that runs the prover's host_stage (assembly and
        witness-only synthesis) out of this interpreter's lock, while this
        thread proves in order. Submission, mark_processed and state
        persistence stay strictly ordered in this (single-writer) thread;
        a failure of the witness stage or of a proof discards the
        speculative preparations and leaves every unproven tx queued.
        The worker outlives the call: close() shuts it down. Each batch
        is one trace (spans.py) under its first queue index: the worker's
        spans, filed here when the batch arrives, this thread's wait for
        it (operator.wait_witness) and its proof's spans.
        Returns the number of batches settled."""
        import queue as _q
        if not self._step_lock.acquire(blocking=False):
            return 0
        prepared: "_q.Queue" = _q.Queue(maxsize=queue_depth)
        stop = threading.Event()
        worker = self._witness_worker()

        def witness_stage():
            # read ahead by queue index: the settling loop below moves the
            # processed cursor, so an offset from it would skip batches
            start = self.queue.last_processed
            tree = self.state.load_tree()
            prepared_n = 0
            while not stop.is_set():
                if max_batches is not None and prepared_n >= max_batches:
                    break
                txs = self.queue.peek_batch(self.cfg.batch_size,
                                            start=start)
                if txs is None:
                    if max_batches is None:
                        time.sleep(poll_interval)
                        continue
                    break
                try:
                    fields = worker.submit(self.prover.host_stage, self.cfg,
                                           tree, txs).result()
                except Exception as e:       # surface in the prove thread
                    if isinstance(e, BrokenProcessPool):
                        # the worker died: the next call starts another
                        self._witness_pool = None
                    prepared.put(e)
                    return
                # the batch's trace id: its first queue index
                prep = PreparedBatch(txs=txs, trace=start, **fields)
                spans.add(prep.spans, trace=start)
                tree = prep.final_tree       # chain the projected tree
                start += len(txs)
                prepared_n += 1
                prepared.put(prep)
            prepared.put(None)               # end-of-stream

        t = threading.Thread(target=witness_stage, daemon=True)
        t.start()
        done = 0
        try:
            while True:
                with spans.span("operator.wait_witness") as waited:
                    prep = prepared.get()
                    if isinstance(prep, PreparedBatch):
                        waited.trace = prep.trace
                if prep is None:
                    break
                if isinstance(prep, Exception):
                    self.metrics.proofs_failed += 1
                    raise prep
                self.metrics.proving()
                with spans.trace(prep.trace) as batch:
                    try:
                        proof = self.prover.prove_prepared(prep)
                    except Exception:
                        self.metrics.proofs_failed += 1
                        raise
                self.metrics.proved(batch.spans())
                self.contract.roll_up(proof, prep.public_signals)
                self.queue.mark_processed(len(prep.txs))
                self.state.apply_rollup_batch(prep.final_tree)
                self.metrics.settled(len(prep.txs))
                done += 1
                if max_batches is not None and done >= max_batches:
                    break
        finally:
            stop.set()
            self._step_lock.release()
        return done
