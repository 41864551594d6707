"""Durable transaction queue with insert/process cursors.

Parity with the reference's redis queue (keys `last-inserted` /
`last-processed`, zk-rollups.config.js:31-34; writes at send.ts:142-147) —
but actually DRAINED: the reference never consumes its queue (SURVEY §2.2
vestigial note); batchd.py turns it into a real pipeline. Backed by sqlite
so the cursor checkpoints survive restarts.
"""

from __future__ import annotations

import json
import sqlite3
import threading
from typing import List, Optional

from ..ref.eddsa import Signature
from ..witness.assembler import Transaction

_DDL = """
CREATE TABLE IF NOT EXISTS tx_queue (
    idx INTEGER PRIMARY KEY,
    body TEXT NOT NULL
);
CREATE TABLE IF NOT EXISTS cursors (
    name TEXT PRIMARY KEY,
    value INTEGER NOT NULL
);
"""

LAST_INSERTED = "last-inserted"
LAST_PROCESSED = "last-processed"


def _tx_to_json(tx: Transaction) -> str:
    d = {"from": tx.from_index, "to": tx.to_index, "amount": str(tx.amount),
         "fee": str(tx.fee), "nonce": tx.nonce}
    if tx.signature is not None:
        d["signature"] = {"R8": [str(tx.signature.R8[0]),
                                 str(tx.signature.R8[1])],
                          "S": str(tx.signature.S)}
    return json.dumps(d)


def _tx_from_json(s: str) -> Transaction:
    d = json.loads(s)
    sig = None
    if "signature" in d:
        sig = Signature(R8=(int(d["signature"]["R8"][0]),
                            int(d["signature"]["R8"][1])),
                        S=int(d["signature"]["S"]))
    return Transaction(from_index=int(d["from"]), to_index=int(d["to"]),
                       amount=int(d["amount"]), fee=int(d["fee"]),
                       nonce=int(d["nonce"]), signature=sig)


class TxQueue:
    def __init__(self, path: str = ":memory:"):
        self.conn = sqlite3.connect(path, check_same_thread=False)
        self.conn.executescript(_DDL)
        self.conn.commit()
        # one connection, several threads (run_pipeline's feeder reads
        # ahead while its caller settles; the HTTP server's threads): every
        # use of it holds this lock
        self._lock = threading.RLock()

    def _cursor(self, name: str) -> int:
        with self._lock:
            row = self.conn.execute(
                "SELECT value FROM cursors WHERE name=?", (name,)).fetchone()
        return row[0] if row else 0

    def _set_cursor(self, name: str, value: int) -> None:
        with self._lock:
            self.conn.execute(
                "INSERT INTO cursors(name, value) VALUES(?,?) "
                "ON CONFLICT(name) DO UPDATE SET value=excluded.value",
                (name, value))
            self.conn.commit()

    @property
    def last_inserted(self) -> int:
        return self._cursor(LAST_INSERTED)

    @property
    def last_processed(self) -> int:
        return self._cursor(LAST_PROCESSED)

    def push(self, tx: Transaction) -> int:
        """send.ts:142-147: store at the current counter, bump it."""
        with self._lock:
            idx = self.last_inserted
            self.conn.execute(
                "INSERT INTO tx_queue(idx, body) VALUES(?,?)",
                (idx, _tx_to_json(tx)))
            self._set_cursor(LAST_INSERTED, idx + 1)
        return idx

    def pending_count(self) -> int:
        with self._lock:
            return self.last_inserted - self.last_processed

    def pending_txs(self) -> List[Transaction]:
        """All queued-but-unprocessed txs in order (admission projection)."""
        with self._lock:
            rows = self.conn.execute(
                "SELECT body FROM tx_queue WHERE idx >= ? AND idx < ? "
                "ORDER BY idx", (self.last_processed, self.last_inserted)
            ).fetchall()
        return [_tx_from_json(r[0]) for r in rows]

    def peek_batch(self, batch_size: int, offset: int = 0,
                   start: Optional[int] = None
                   ) -> Optional[List[Transaction]]:
        """Next batch_size txs in order (skipping `offset` txs past the
        processed cursor), or None if not enough queued. `start`, where
        given, is the queue index of the first tx instead: the DP pipeline
        reads batch i+1 by index while batch i proves, since settling
        batch i moves the processed cursor under it."""
        with self._lock:
            if start is None:
                start = self.last_processed + offset
            if self.last_inserted < start + batch_size:
                return None
            rows = self.conn.execute(
                "SELECT body FROM tx_queue WHERE idx >= ? AND idx < ? "
                "ORDER BY idx", (start, start + batch_size)).fetchall()
        return [_tx_from_json(r[0]) for r in rows]

    def mark_processed(self, n: int) -> None:
        with self._lock:
            self._set_cursor(LAST_PROCESSED, self.last_processed + n)
