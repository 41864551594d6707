"""Durable Merkle-tree storage (the rollup's checkpoint/resume system).

Schema parity with the reference's Postgres DDL
(simple-zk-rollups/operator/src/db/postgres.ts:13-49) and the save/load
round-trip semantics of saveMerkleTreeToDb / loadMerkleTreeFromDb
(simple-zk-rollups/operator/src/utils/merkletree.ts:274-403): full tree state
upserted by name as JSON, leaves upserted one-at-a-time keyed by
(tree, index).

Backend is sqlite (stdlib) — the operator is single-writer by design (see
SURVEY §5 race notes); a Postgres backend can be slotted in where available
since all statements are ANSI upserts.
"""

from __future__ import annotations

import json
import sqlite3
from typing import Optional

from .merkle import MerkleTree, create_merkle_tree

_DDL = """
CREATE TABLE IF NOT EXISTS merkletrees (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    name TEXT NOT NULL UNIQUE,
    depth INTEGER NOT NULL,
    next_index INTEGER NOT NULL,
    root TEXT NOT NULL,
    zero_value TEXT NOT NULL,
    zeros TEXT NOT NULL,
    filled_sub_trees TEXT NOT NULL,
    filled_paths TEXT NOT NULL
);
CREATE TABLE IF NOT EXISTS leaves (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    merkletree_id INTEGER NOT NULL,
    idx INTEGER NOT NULL,
    raw TEXT NOT NULL,
    hash TEXT NOT NULL,
    UNIQUE (merkletree_id, idx)
);
"""


def _stringify(x):
    """BigInt-safe JSON: ints -> decimal strings, recursively (parity with
    snarkjs stringifyBigInts used at merkletree.ts:307-311)."""
    if isinstance(x, bool) or x is None:
        return x
    if isinstance(x, int):
        return str(x)
    if isinstance(x, (list, tuple)):
        return [_stringify(v) for v in x]
    if isinstance(x, dict):
        return {str(k): _stringify(v) for k, v in x.items()}
    return x


def _unstringify(x):
    if isinstance(x, str):
        try:
            return int(x)
        except ValueError:
            return x
    if isinstance(x, list):
        return [_unstringify(v) for v in x]
    if isinstance(x, dict):
        return {k: _unstringify(v) for k, v in x.items()}
    return x


class TreeStore:
    def __init__(self, path: str = ":memory:"):
        # served from the HTTP thread pool too; single-writer discipline is
        # the operator's (SURVEY §5 race notes), not sqlite's
        self.conn = sqlite3.connect(path, check_same_thread=False)
        self.conn.executescript(_DDL)
        self.conn.commit()

    def close(self):
        self.conn.close()

    def _upsert_tree(self, cur, name: str, mt: MerkleTree) -> int:
        """Write the tree's row (its state and caches as JSON); returns its
        id."""
        cur.execute(
            """INSERT INTO merkletrees
               (name, depth, next_index, root, zero_value, zeros,
                filled_sub_trees, filled_paths)
               VALUES (?,?,?,?,?,?,?,?)
               ON CONFLICT(name) DO UPDATE SET
                 depth=excluded.depth, next_index=excluded.next_index,
                 root=excluded.root, zero_value=excluded.zero_value,
                 zeros=excluded.zeros,
                 filled_sub_trees=excluded.filled_sub_trees,
                 filled_paths=excluded.filled_paths""",
            (name, mt.depth, mt.next_leaf_index, str(mt.root), str(mt.zero_value),
             json.dumps(_stringify(mt.zeros)),
             json.dumps(_stringify(mt.filled_subtrees)),
             json.dumps(_stringify(mt.filled_paths))),
        )
        cur.execute("SELECT id FROM merkletrees WHERE name=?", (name,))
        return cur.fetchone()[0]

    def _upsert_leaves(self, cur, tree_id: int, mt: MerkleTree,
                       indices) -> None:
        cur.executemany(
            """INSERT INTO leaves (merkletree_id, idx, raw, hash)
               VALUES (?,?,?,?)
               ON CONFLICT(merkletree_id, idx) DO UPDATE SET
                 raw=excluded.raw, hash=excluded.hash""",
            [(tree_id, i, json.dumps(_stringify(mt.leaves_raw[i])),
              str(mt.leaves[i])) for i in indices],
        )

    def save(self, name: str, mt: MerkleTree, leaf_index: Optional[int] = None) -> None:
        cur = self.conn.cursor()
        tree_id = self._upsert_tree(cur, name, mt)
        # parity: save only the latest (or requested) leaf (merkletree.ts:326-355)
        if leaf_index is not None or mt.next_leaf_index:
            sel = mt.next_leaf_index - 1 if leaf_index is None else leaf_index
            self._upsert_leaves(cur, tree_id, mt, [sel])
        self.conn.commit()

    def save_all_leaves(self, name: str, mt: MerkleTree) -> None:
        """Convenience beyond the reference: persist every leaf (used when
        bootstrapping from a full tree rather than event-by-event). The
        rows, their ids too, are those of the reference's save() of leaf 0
        and then of every leaf; the tree's own row is written once."""
        cur = self.conn.cursor()
        tree_id = self._upsert_tree(cur, name, mt)
        n = mt.next_leaf_index
        self._upsert_leaves(cur, tree_id, mt, [0, *range(n)] if n else [])
        self.conn.commit()

    def load(self, name: str) -> MerkleTree:
        cur = self.conn.cursor()
        cur.execute("SELECT * FROM merkletrees WHERE name=?", (name,))
        row = cur.fetchone()
        if row is None:
            raise KeyError(f"MerkleTree named {name} not found in database")
        (tree_id, _name, depth, next_index, root, zero_value,
         zeros, filled_sub_trees, filled_paths) = row

        mt = create_merkle_tree(depth, int(zero_value))
        mt.next_leaf_index = next_index
        mt.root = int(root)
        mt.zeros = {int(k): v for k, v in _unstringify(json.loads(zeros)).items()}
        mt.filled_subtrees = {int(k): v for k, v in
                              _unstringify(json.loads(filled_sub_trees)).items()}
        mt.filled_paths = {int(k): {int(k2): v2 for k2, v2 in v.items()}
                           for k, v in _unstringify(json.loads(filled_paths)).items()}

        cur.execute("SELECT idx, raw, hash FROM leaves WHERE merkletree_id=? "
                    "ORDER BY idx ASC", (tree_id,))
        leaves, leaves_raw = [], []
        for idx, raw, h in cur.fetchall():
            leaves.append(int(h))
            leaves_raw.append(_unstringify(json.loads(raw)))
        mt.leaves = leaves
        mt.leaves_raw = leaves_raw
        return mt

    def exists(self, name: str) -> bool:
        cur = self.conn.execute("SELECT 1 FROM merkletrees WHERE name=?", (name,))
        return cur.fetchone() is not None

    def verify_integrity(self, name: str, use_device: bool = True,
                         device="cuda") -> bool:
        """Recompute the FULL tree from the stored leaves and compare it with
        the persisted state: a corruption check on restore, beyond the
        reference's trust-the-row semantics. The rebuild is bulk.from_leaves
        (its large levels as batched MiMC on `device` with use_device).
        Returns True when root and caches match."""
        from .bulk import from_leaves
        stored = self.load(name)
        rebuilt = from_leaves(stored.leaves, stored.depth,
                              stored.zero_value,
                              leaves_raw=stored.leaves_raw,
                              use_device=use_device, device=device)
        return stored.equals(rebuilt)
