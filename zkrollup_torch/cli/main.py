"""Client and operator CLI (simple-zk-rollups/scripts/index.js:71-188).

    python -m zkrollup_torch.cli [--device cuda|cpu] [--backend device|host]
                                 [--keys-dir DIR] [--deterministic] COMMAND

Two modes:

  Service mode (the reference's client/operator split, over HTTP):
    serve                              start operator + chain simulator
    deposit  --user A --eth 1
    send     --from A --to B --eth 0.1 [--fee f] [--nonce n]
    withdraw --user A --eth 0.4        (proves client-side)
    user     --user A | --index 0
    prove-batch                        drain one batch

  Self-contained demos (deposit -> send x2 -> prove -> rollUp -> assert,
  the operatorLogic.test.ts scenario):
    demo-rollup
    demo-withdraw

The commands that prove (serve, withdraw and the demos) prove on --device
(default cuda) with the port's kernels, or on the native engine with
--backend host; these take the place of the reference's JAX_PLATFORMS and
ZKROLLUP_PROVE_BACKEND. Without a CUDA device they fail unless given
--device cpu or --backend host.

The reference advertises depositA/depositB/withdrawA/withdrawB/sendFromA/
sendFromB (index.js:71-92; sendFromB was never implemented upstream —
index.js:170-188). Here the user is a --user flag over the same two fixed
dev keys, and every command is implemented.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import urllib.error
import urllib.request

from ..config import load_config
from ..ref import eddsa
from ..ref.mimc import multi_hash
from ..chain.simulator import RollUpContract
from ..operator.state import OperatorState
from ..operator.queue import TxQueue
from ..operator.prover import TxProver, WithdrawProver
from ..operator.batchd import BatchDaemon
from ..operator.service import OperatorApp, start_app
from ..witness.assembler import Transaction, format_tx

WEI = 10 ** 18
# proving keys are cached in the checkout, beside the kernel builds
DEFAULT_KEYS_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "build", "keys")


def to_wei(eth) -> int:
    """Exact decimal conversion (float multiplication drifts: 0.57 * 1e18
    is not 57 * 10^16 in binary floating point)."""
    from decimal import Decimal
    return int(Decimal(str(eth)) * WEI)


def from_wei(wei: int) -> float:
    return wei / WEI


# Fixed demo keys (the reference uses hardcoded dev keys too)
PRIV_A = 3461904823869495924446136355166658661994387995314494198873459573992912434327 % (2**250)
PRIV_B = 6876489714123326193969274478259787479864255376696894364275539418009183638325 % (2**250)
USERS = {"A": PRIV_A, "B": PRIV_B}


def _priv(name: str) -> int:
    try:
        return USERS[name.upper()]
    except KeyError:
        raise SystemExit(f"unknown user {name!r}: choose from {sorted(USERS)}")


def _http(url: str, body=None) -> dict:
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(
        url, data=data,
        headers={"Content-Type": "application/json"} if data else {})
    try:
        with urllib.request.urlopen(req, timeout=600) as resp:
            return json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return json.loads(e.read())
    except urllib.error.URLError as e:
        raise SystemExit(
            f"operator unreachable at {url} ({e.reason}) — "
            "start one with `python -m zkrollup_torch.cli serve`")


def _address(pub) -> str:
    return hex(multi_hash(list(pub)))


def _prover_opts(args) -> dict:
    """device and backend for the provers of a proving command; fails when
    the device route is asked of a CUDA device that is not there."""
    if args.backend == "device" and args.device.startswith("cuda"):
        import torch
        if not torch.cuda.is_available():
            raise SystemExit(
                f"no CUDA device for --device {args.device}: prove on the "
                "CPU with --device cpu, or on the native engine with "
                "--backend host")
    return {"device": args.device, "backend": args.backend}


def _withdraw_key_path(args):
    if not args.keys_dir:
        return None
    os.makedirs(args.keys_dir, exist_ok=True)
    return os.path.join(args.keys_dir, "withdraw.npz")


def cmd_serve(args) -> int:
    cfg = load_config()
    key_path = None
    if args.keys_dir:
        os.makedirs(args.keys_dir, exist_ok=True)
        key_path = os.path.join(
            args.keys_dir, f"tx_{cfg.batch_size}_{cfg.tree_depth}.npz")
    tx_prover = TxProver(cfg, key_path=key_path,
                         setup_seed=b"demo" if args.deterministic else None,
                         **_prover_opts(args))
    print("Preparing proving keys (one-time; cached under --keys-dir)...")
    pk = tx_prover.ensure_keys()
    wvk = None
    if not args.no_withdraw_keys:
        wp = WithdrawProver(key_path=_withdraw_key_path(args),
                            setup_seed=b"demo" if args.deterministic else None,
                            **_prover_opts(args))
        wvk = wp.ensure_keys().vk
    from ..chain.deploy import deploy
    contract, addrs = deploy(cfg, tx_vk=pk.vk, withdraw_vk=wvk,
                             build_dir=args.build_dir)
    if args.build_dir:
        print(f"deploy artifacts written to {args.build_dir}")
    state = OperatorState(cfg)
    queue = TxQueue(args.queue_db or ":memory:")
    daemon = BatchDaemon(cfg, state, queue, tx_prover, contract)
    app = OperatorApp(cfg, state, queue, contract, daemon)
    server = start_app(app, port=args.port)
    print(f"operator listening on http://127.0.0.1:{args.port} "
          f"(depth {cfg.tree_depth}, batch {cfg.batch_size})")
    try:
        while True:
            time.sleep(1.0)
            if args.auto_batch:
                try:
                    app.post_prove_batch()
                except (RuntimeError, ValueError) as e:
                    # keep serving: the batch stays queued for re-prove
                    print(f"auto-batch step failed: {e}")
    except KeyboardInterrupt:
        server.shutdown()
    return 0


def cmd_deposit(args) -> int:
    pub = eddsa.gen_public_key(_priv(args.user))
    resp = _http(f"{args.url}/chain/deposit",
                 {"publicKey": [str(pub[0]), str(pub[1])],
                  "value": str(to_wei(args.eth))})
    print(json.dumps(resp, indent=2))
    return 1 if "error" in resp else 0


def cmd_send(args) -> int:
    priv_from = _priv(getattr(args, "from"))
    pub_from = eddsa.gen_public_key(priv_from)
    pub_to = eddsa.gen_public_key(_priv(args.to))

    me = _http(f"{args.url}/users/address/{_address(pub_from)}")
    if "error" in me:
        print(json.dumps(me)); return 1
    them = _http(f"{args.url}/users/address/{_address(pub_to)}")
    if "error" in them:
        print(json.dumps(them)); return 1

    amount = to_wei(args.eth)
    fee = to_wei(args.fee) if args.fee is not None else amount // 1000 * 3
    nonce = args.nonce if args.nonce is not None else int(me["nonce"]) + 1
    tx = Transaction(int(me["balanceTreeLeafIndex"]),
                     int(them["balanceTreeLeafIndex"]), amount, fee, nonce)
    tx.signature = eddsa.sign(priv_from, format_tx(tx))
    resp = _http(f"{args.url}/send", {
        "from": tx.from_index, "to": tx.to_index, "amount": str(amount),
        "fee": str(fee), "nonce": nonce,
        "signature": {"R8": [str(tx.signature.R8[0]),
                             str(tx.signature.R8[1])],
                      "S": str(tx.signature.S)}})
    print(json.dumps(resp, indent=2))
    return 1 if "error" in resp else 0


def cmd_withdraw(args) -> int:
    """Generate the withdraw proof CLIENT-side (as the reference does —
    index.js:141-152) and submit it through the operator's chain gateway.
    Requires the server to run with the same --keys-dir/--deterministic so
    the embedded verifying key matches."""
    import secrets
    priv = _priv(args.user)
    wp = WithdrawProver(key_path=_withdraw_key_path(args),
                        setup_seed=b"demo" if args.deterministic else None,
                        **_prover_opts(args))
    print("Loading withdraw proving keys...")
    wp.ensure_keys()
    nullifier = secrets.randbelow(1 << 200)
    print("Proving private-key knowledge...")
    t0 = time.time()
    proof, signals = wp.prove_withdraw(
        eddsa.format_priv_key_for_babyjub(priv), nullifier)
    print(f"  proof in {time.time() - t0:.1f}s")
    resp = _http(f"{args.url}/chain/withdraw", {
        "amount": str(to_wei(args.eth)),
        "proof": {"a": [str(proof.a[0]), str(proof.a[1])],
                  "b": [[str(proof.b[0][0]), str(proof.b[0][1])],
                        [str(proof.b[1][0]), str(proof.b[1][1])]],
                  "c": [str(proof.c[0]), str(proof.c[1])]},
        "signals": [str(s) for s in signals]})
    print(json.dumps(resp, indent=2))
    return 1 if "error" in resp else 0


def cmd_user(args) -> int:
    if args.index is not None:
        resp = _http(f"{args.url}/users/index/{args.index}")
    else:
        pub = eddsa.gen_public_key(_priv(args.user))
        resp = _http(f"{args.url}/users/address/{_address(pub)}")
    print(json.dumps(resp, indent=2))
    return 1 if "error" in resp else 0


def cmd_prove_batch(args) -> int:
    resp = _http(f"{args.url}/admin/prove-batch", {})
    print(json.dumps(resp, indent=2))
    return 1 if "error" in resp else 0


def demo_rollup(args) -> int:
    cfg = load_config()
    print("Setting up rollup demo environment (in-process chain)...")

    key_path = None
    if args.keys_dir:
        os.makedirs(args.keys_dir, exist_ok=True)
        key_path = os.path.join(
            args.keys_dir, f"tx_{cfg.batch_size}_{cfg.tree_depth}.npz")

    tx_prover = TxProver(cfg, key_path=key_path,
                         setup_seed=b"demo" if args.deterministic else None,
                         **_prover_opts(args))
    print("Generating / loading proving keys (one-time)...")
    t0 = time.time()
    pk = tx_prover.ensure_keys()
    print(f"  keys ready in {time.time()-t0:.1f}s "
          f"(domain {pk.domain_size}, {pk.n_vars} vars)")

    contract = RollUpContract(cfg, tx_vk=pk.vk, withdraw_vk=None)
    state = OperatorState(cfg)
    queue = TxQueue()
    daemon = BatchDaemon(cfg, state, queue, tx_prover, contract)
    app = OperatorApp(cfg, state, queue, contract, daemon)

    pub_a = eddsa.gen_public_key(PRIV_A)
    pub_b = eddsa.gen_public_key(PRIV_B)

    print("User A deposits 1.0 ETH; user B deposits 1.0 ETH")
    contract.deposit(pub_a[0], pub_a[1], to_wei(1.0))
    contract.deposit(pub_b[0], pub_b[1], to_wei(1.0))
    app.sync_chain()

    def send(priv, frm, to, amount, fee, nonce):
        tx = Transaction(frm, to, amount, fee, nonce)
        tx.signature = eddsa.sign(priv, format_tx(tx))
        body = {"from": frm, "to": to, "amount": str(amount),
                "fee": str(fee), "nonce": nonce,
                "signature": {"R8": [str(tx.signature.R8[0]),
                                     str(tx.signature.R8[1])],
                              "S": str(tx.signature.S)}}
        resp = app.post_send(body)
        print(f"  /send {frm}->{to} {from_wei(amount)} ETH: {resp}")
        return resp

    send(PRIV_A, 0, 1, to_wei(0.1), to_wei(0.01), 1)
    send(PRIV_A, 0, 1, to_wei(0.3), to_wei(0.02), 2)

    print("Batch daemon: proving + submitting rollUp()...")
    t0 = time.time()
    if not daemon.step():
        print("ERROR: batch not processed")
        return 1
    print(f"  batch proven+settled in {time.time()-t0:.1f}s")

    a_data = contract.get_user_data(multi_hash(list(pub_a)))
    b_data = contract.get_user_data(multi_hash(list(pub_b)))
    print(f"A: balance {from_wei(a_data[3])} ETH nonce {a_data[4]}")
    print(f"B: balance {from_wei(b_data[3])} ETH nonce {b_data[4]}")
    print(f"accrued fees: {from_wei(contract.get_accrued_fees())} ETH")
    if ((a_data[3], a_data[4], b_data[3], contract.get_accrued_fees())
            != (to_wei(0.57), 2, to_wei(1.4), to_wei(0.03))):
        print("ERROR: balances differ from the reference E2E expectations")
        return 1
    print("DEMO ROLLUP OK — balances match the reference E2E expectations")
    return 0


def demo_withdraw(args) -> int:
    cfg = load_config()
    wp = WithdrawProver(key_path=_withdraw_key_path(args),
                        setup_seed=b"demo" if args.deterministic else None,
                        **_prover_opts(args))
    print("Generating / loading withdraw keys...")
    pk = wp.ensure_keys()
    contract = RollUpContract(cfg, tx_vk=None, withdraw_vk=pk.vk)

    pub_a = eddsa.gen_public_key(PRIV_A)
    contract.deposit(pub_a[0], pub_a[1], to_wei(1.0))

    import secrets
    nullifier = secrets.randbelow(1 << 200)
    fpriv = eddsa.format_priv_key_for_babyjub(PRIV_A)
    print("Proving withdraw (knowledge of private key)...")
    t0 = time.time()
    proof, signals = wp.prove_withdraw(fpriv, nullifier)
    print(f"  proof in {time.time()-t0:.1f}s")
    got = contract.withdraw(to_wei(0.4), proof, signals)
    print(f"withdrew {from_wei(got)} ETH; "
          f"remaining {from_wei(contract.get_user_data(multi_hash(list(pub_a)))[3])}")
    try:
        contract.withdraw(to_wei(0.1), proof, signals)
        print("ERROR: nullifier reuse accepted")
        return 1
    except ValueError as e:
        print(f"nullifier reuse rejected: {e}")
    print("DEMO WITHDRAW OK")
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m zkrollup_torch.cli",
        description="zk-rollup operator and client on PyTorch and CUDA")
    p.add_argument("--keys-dir",
                   default=DEFAULT_KEYS_DIR,
                   help="proving-key cache directory")
    p.add_argument("--device", default="cuda",
                   help="torch device the prover runs on (default cuda)")
    p.add_argument("--backend", choices=("device", "host"), default="device",
                   help="prove on --device with the port's kernels, or on "
                        "the native engine (host)")
    p.add_argument("--deterministic", action="store_true",
                   help="pin setup/blinding randomness (test fixtures only)")
    p.add_argument("--url", default="http://127.0.0.1:3000",
                   help="operator base URL (service-mode commands)")
    sub = p.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("serve", help="run operator + chain simulator")
    s.add_argument("--port", type=int, default=3000)
    s.add_argument("--queue-db", default=None,
                   help="sqlite path for the durable tx queue")
    s.add_argument("--auto-batch", action="store_true",
                   help="prove+settle automatically when a batch is full")
    s.add_argument("--no-withdraw-keys", action="store_true",
                   help="skip withdraw-circuit setup (faster boot)")
    s.add_argument("--build-dir", default=None,
                   help="write DeployedAddresses.json + regenerated "
                        "Solidity verifiers here (migrations parity)")

    d = sub.add_parser("deposit", help="deposit ETH for a dev user")
    d.add_argument("--user", required=True, help="A or B")
    d.add_argument("--eth", required=True, type=float)

    sd = sub.add_parser("send", help="signed L2 transfer via POST /send")
    sd.add_argument("--from", required=True, help="A or B")
    sd.add_argument("--to", required=True, help="A or B")
    sd.add_argument("--eth", required=True, type=float)
    sd.add_argument("--fee", type=float, default=None,
                    help="fee in ETH (default: the 0.3%% minimum)")
    sd.add_argument("--nonce", type=int, default=None,
                    help="default: on-chain nonce + 1")

    w = sub.add_parser("withdraw", help="prove key knowledge and withdraw")
    w.add_argument("--user", required=True, help="A or B")
    w.add_argument("--eth", required=True, type=float)

    u = sub.add_parser("user", help="look up a user")
    u.add_argument("--user", default=None, help="A or B")
    u.add_argument("--index", type=int, default=None)

    sub.add_parser("prove-batch", help="drain one batch through the daemon")
    sub.add_parser("demo-rollup", help="E2E: deposit/send/prove/rollUp")
    sub.add_parser("demo-withdraw", help="E2E: deposit/prove/withdraw")
    args = p.parse_args(argv)

    dispatch = {"serve": cmd_serve, "deposit": cmd_deposit, "send": cmd_send,
                "withdraw": cmd_withdraw, "user": cmd_user,
                "prove-batch": cmd_prove_batch, "demo-rollup": demo_rollup,
                "demo-withdraw": demo_withdraw}
    return dispatch[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
