"""Operator HTTP service — REST parity with the reference's express app
(simple-zk-rollups/operator/src/app.ts:25-31):

    GET  /contracts           deployed contract info
    GET  /users/index/<i>     user by balance-tree index
    GET  /users/address/<a>   user by address (= hex multiHash(pubkey))
    POST /send                submit a signed L2 transfer

plus GET /metrics (batch-prover counters; the observability endpoint the
reference lacks — SURVEY §5) and the chain-gateway routes the CLI drives
(the reference client talks ethers JSON-RPC to ganache for these —
scripts/index.js:129,141-152; here the in-process simulator is behind the
operator, so they are HTTP):

    POST /chain/deposit       {publicKey: [x, y], value}
    POST /chain/withdraw      {amount, proof, signals}
    POST /admin/prove-batch   drain one batch through the daemon

Stdlib http.server: the service tier is not performance-critical
(SURVEY §2.5) and must run without extra deps.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from ..config import RollupConfig
from ..ref.mimc import multi_hash
from ..ref.eddsa import Signature
from ..chain.simulator import RollUpContract
from ..witness.assembler import Transaction
from .state import OperatorState
from .queue import TxQueue
from .validation import validate_tx, ValidationError
from .batchd import BatchDaemon


class OperatorApp:
    def __init__(self, cfg: RollupConfig, state: OperatorState,
                 queue: TxQueue, contract: RollUpContract,
                 daemon: Optional[BatchDaemon] = None):
        self.cfg = cfg
        self.state = state
        self.queue = queue
        self.contract = contract
        self.daemon = daemon
        self._event_cursor = 0

    def sync_chain(self) -> int:
        """Deliver new contract events to the operator state (the pubsub
        subscription of app.ts:52-56, polled instead of pushed). Returns
        the number of events applied."""
        evs = self.contract.events[self._event_cursor:]
        for ev in evs:
            self.state.on_chain_event(ev)
        self._event_cursor += len(evs)
        return len(evs)

    # route handlers (transport-independent; used by tests directly) -------

    def get_contracts(self) -> dict:
        return {"rollUpAddress": RollUpContract.ADDRESS,
                "balanceTreeDepth": self.cfg.tree_depth,
                "batchSize": self.cfg.batch_size}

    def get_user_by_index(self, index: int) -> dict:
        key = self.contract.get_user_key(index)
        if key == 0:
            return {"error": "User not found"}
        return self._user_payload(key)

    def get_user_by_address(self, address: str) -> dict:
        """address = hex of multiHash(pubkey) (users.ts:9-74)."""
        try:
            key = int(address, 16)
        except ValueError:
            return {"error": "Invalid address"}
        return self._user_payload(key)

    def _user_payload(self, key_hash: int) -> dict:
        idx, px, py, bal, nonce = self.contract.get_user_data(key_hash)
        if px == 0 and py == 0:
            return {"error": "User not found"}
        return {"balanceTreeLeafIndex": idx,
                "publicKey": [str(px), str(py)],
                "balance": str(bal), "nonce": nonce,
                "address": hex(multi_hash([px, py]))}

    def post_send(self, body: dict) -> dict:
        required = ("from", "to", "amount", "fee", "nonce", "signature")
        if (any(k not in body for k in required)
                or not isinstance(body.get("signature"), dict)
                or "R8" not in body["signature"]
                or "S" not in body["signature"]):
            return {"error": "Missing parameters",
                    "from": "(required) int", "to": "(required) int",
                    "amount": "(required) int, in Wei",
                    "fee": "(required) int, in Wei (min 0.3% of amount)",
                    "nonce": "(required) int",
                    "signature": {"R8": "(required) [int, int]",
                                  "S": "(required) int"}}
        try:
            sig = Signature(R8=(int(body["signature"]["R8"][0]),
                                int(body["signature"]["R8"][1])),
                            S=int(body["signature"]["S"]))
            tx = Transaction(from_index=int(body["from"]),
                             to_index=int(body["to"]),
                             amount=int(body["amount"]), fee=int(body["fee"]),
                             nonce=int(body["nonce"]), signature=sig)
        except (ValueError, TypeError, IndexError):
            return {"error": "Invalid paramters, unable to convert to Integers!"}

        tree = self.state.load_tree()
        try:
            # admission sees the projected state of queued txs so a sender
            # can chain transfers within one batch (validation.py docstring)
            validate_tx(self.cfg, tree, tx,
                        pending=self.queue.pending_txs())
        except ValidationError as e:
            return {"error": str(e)}
        self.queue.push(tx)
        return {"status": "Transaction accepted"}

    def post_chain_deposit(self, body: dict) -> dict:
        """Chain gateway for `deposit` (scripts/index.js:129 drives the
        contract directly; here the operator fronts the simulator)."""
        try:
            px, py = (int(body["publicKey"][0]), int(body["publicKey"][1]))
            value = int(body["value"])
        except (KeyError, ValueError, TypeError, IndexError):
            return {"error": "Expected {publicKey: [x, y], value}"}
        try:
            self.contract.deposit(px, py, value)
        except ValueError as e:
            return {"error": str(e)}
        self.sync_chain()
        return self._user_payload(multi_hash([px, py]))

    def post_chain_withdraw(self, body: dict) -> dict:
        """Chain gateway for `withdraw(amount, a, b, c, input[3])`
        (scripts/index.js:141-152 -> RollUp.sol:212)."""
        from ..groth16.keys import Proof
        try:
            pj = body["proof"]
            proof = Proof(
                a=(int(pj["a"][0]), int(pj["a"][1])),
                b=((int(pj["b"][0][0]), int(pj["b"][0][1])),
                   (int(pj["b"][1][0]), int(pj["b"][1][1]))),
                c=(int(pj["c"][0]), int(pj["c"][1])))
            signals = [int(s) for s in body["signals"]]
            amount = int(body["amount"])
        except (KeyError, ValueError, TypeError, IndexError):
            return {"error": "Expected {amount, proof: {a,b,c}, signals}"}
        try:
            got = self.contract.withdraw(amount, proof, signals)
        except ValueError as e:
            return {"error": str(e)}
        self.sync_chain()
        return {"withdrawn": str(got)}

    def post_prove_batch(self) -> dict:
        """Drive the batch daemon one step (reference: the loop lives only
        in operatorLogic.test.ts; here it is an operator route)."""
        if self.daemon is None:
            return {"error": "No batch daemon configured"}
        processed = self.daemon.step()
        self.sync_chain()
        return {"processed": processed, **self.get_metrics()}

    def get_metrics(self) -> dict:
        m = {"queue_pending": self.queue.pending_count()}
        if self.daemon is not None:
            m.update(self.daemon.metrics.snapshot())
        return m


def make_http_server(app: OperatorApp, host: str = "127.0.0.1",
                     port: int = 3000) -> ThreadingHTTPServer:
    class Handler(BaseHTTPRequestHandler):
        def _reply(self, payload, code=200):
            data = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):
            parts = self.path.strip("/").split("/")
            if self.path == "/contracts":
                self._reply(app.get_contracts())
            elif len(parts) == 3 and parts[0] == "users" and parts[1] == "index":
                self._reply(app.get_user_by_index(int(parts[2])))
            elif len(parts) == 3 and parts[0] == "users" and parts[1] == "address":
                self._reply(app.get_user_by_address(parts[2]))
            elif self.path == "/metrics":
                self._reply(app.get_metrics())
            else:
                self._reply({"error": "Not found"}, 404)

        def do_POST(self):
            routes = {"/send": app.post_send,
                      "/chain/deposit": app.post_chain_deposit,
                      "/chain/withdraw": app.post_chain_withdraw,
                      "/admin/prove-batch": lambda _b: app.post_prove_batch()}
            handler = routes.get(self.path)
            if handler is None:
                self._reply({"error": "Not found"}, 404)
                return
            length = int(self.headers.get("Content-Length", 0))
            try:
                body = json.loads(self.rfile.read(length) or b"{}")
            except json.JSONDecodeError:
                self._reply({"error": "Invalid JSON"}, 400)
                return
            try:
                resp = handler(body)
            except (RuntimeError, ValueError) as e:
                resp = {"error": str(e)}
            self._reply(resp, 400 if "error" in resp else 201)

        def log_message(self, *args):  # quiet
            pass

    return ThreadingHTTPServer((host, port), Handler)


def start_app(app: OperatorApp, port: int = 3000) -> ThreadingHTTPServer:
    """app.ts:34-64 analog: serve REST; returns the running server (caller
    owns shutdown)."""
    server = make_http_server(app, port=port)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return server
