"""zkrollup_torch's operator loop against zkrollup's on the CPU, through the
native engine (backend="host"): the BatchProcessTx(2, 6) rollup of the
demo (the CLI's demo-rollup), the pipelined batch daemon, the proof of a
prepared batch at pinned (r, s), the HTTP service and its CLI, the deploy
artifacts, and the withdraw circuit (demo-withdraw, WithdrawProver).

One proving key, made by the port's setup_host, is shared by the module
and saved under pytest's temporary directory; zkrollup's TxProver loads
the same npz, so the two packages' R1CS digests must agree. The device
route is exercised on the card (tests/test_torch_cuda.py, chip_smoke.py):
on CPU tensors a withdraw proof alone takes most of a minute.
"""

import contextlib
import io
import json
import shutil
import threading
import urllib.error
import urllib.request

import pytest
import torch

from zkrollup.chain import deploy as jdeploy
from zkrollup.chain import simulator as jsim
from zkrollup.config import RollupConfig as JConfig
from zkrollup.operator import batchd as jbatchd
from zkrollup.operator import prover as jprover
from zkrollup.operator import queue as jqueue
from zkrollup.operator import service as jservice
from zkrollup.operator import state as jstate
from zkrollup.ref import eddsa as jeddsa
from zkrollup.witness import assembler as jasm
from zkrollup_torch.chain.deploy import deploy, load_deployed_addresses
from zkrollup_torch.chain.simulator import RollUpContract
from zkrollup_torch.cli import main as cli
from zkrollup_torch.config import RollupConfig
from zkrollup_torch.groth16.keys import r1cs_digest
from zkrollup_torch.operator.batchd import BatchDaemon
from zkrollup_torch.operator.prover import TxProver, WithdrawProver
from zkrollup_torch.operator.queue import TxQueue
from zkrollup_torch.operator.service import OperatorApp, start_app
from zkrollup_torch.operator.state import OperatorState
from zkrollup_torch.ref import eddsa
from zkrollup_torch.ref.mimc import multi_hash
from zkrollup_torch.witness.assembler import Transaction, format_tx

torch.set_num_threads(1)

CFG = RollupConfig()                  # the production (2, 6) circuit
WEI = 10 ** 18
PRIV_A = 1234567890123456789
PRIV_B = 9876543210987654321
PUB_A = eddsa.gen_public_key(PRIV_A)
PUB_B = eddsa.gen_public_key(PRIV_B)
PINNED = (11, 13)


def _wei(hundredths: int) -> int:
    return hundredths * WEI // 100


@pytest.fixture(scope="module")
def key(tmp_path_factory):
    """(path of the (2, 6) key, the port's host prover holding it, the
    reference's prover that loaded the same file)."""
    path = str(tmp_path_factory.mktemp("keys") / "tx_2_6.npz")
    port = TxProver(CFG, key_path=path, setup_seed=b"operator-loop",
                    backend="host")
    pk = port.ensure_keys()
    ref = jprover.TxProver(JConfig(), key_path=path)
    # a digest that differed would send the reference to its own setup
    assert r1cs_digest(ref._structure_r1cs()) == pk.r1cs_digest
    assert vars(ref.ensure_keys().vk) == vars(pk.vk)
    return path, port, ref


# each package's loop: (contract, state, queue, daemon, app, eddsa, Transaction)
def _port_env(prover):
    contract = RollUpContract(CFG, tx_vk=prover.ensure_keys().vk,
                              withdraw_vk=None)
    state = OperatorState(CFG)
    queue = TxQueue()
    daemon = BatchDaemon(CFG, state, queue, prover, contract)
    return (contract, state, queue, daemon,
            OperatorApp(CFG, state, queue, contract, daemon), eddsa,
            Transaction, format_tx)


def _ref_env(prover):
    cfg = JConfig()
    contract = jsim.RollUpContract(cfg, tx_vk=prover.ensure_keys().vk,
                                   withdraw_vk=None)
    state = jstate.OperatorState(cfg)
    queue = jqueue.TxQueue()
    daemon = jbatchd.BatchDaemon(cfg, state, queue, prover, contract)
    return (contract, state, queue, daemon,
            jservice.OperatorApp(cfg, state, queue, contract, daemon), jeddsa,
            jasm.Transaction, jasm.format_tx)


def _send(env, priv, frm, to, amount, fee, nonce):
    *_, app, ed, tx_cls, fmt = env
    tx = tx_cls(frm, to, amount, fee, nonce)
    tx.signature = ed.sign(priv, fmt(tx))
    return app.post_send({
        "from": frm, "to": to, "amount": str(amount), "fee": str(fee),
        "nonce": nonce,
        "signature": {"R8": [str(tx.signature.R8[0]),
                             str(tx.signature.R8[1])],
                      "S": str(tx.signature.S)}})


def _pipeline(env):
    """tests/test_e2e_rollup.py's pipelined scenario: A 2 ETH, B 1 ETH,
    four sends of 0.10 ETH (fee 0.01) from A, two batches."""
    contract, state, queue, daemon, app, *_ = env
    contract.deposit(PUB_A[0], PUB_A[1], 2 * WEI)
    contract.deposit(PUB_B[0], PUB_B[1], WEI)
    app.sync_chain()
    accepted = [_send(env, PRIV_A, 0, 1, _wei(10), _wei(1), n)
                for n in range(1, 5)]
    done = daemon.run_pipeline(max_batches=2)
    m = daemon.metrics
    return {"accepted": accepted, "done": done,
            "pending": queue.pending_count(),
            "metrics": (m.batches_proven, m.txs_processed, m.proofs_failed),
            "a": contract.get_user_data(multi_hash(list(PUB_A))),
            "b": contract.get_user_data(multi_hash(list(PUB_B))),
            "fees": contract.get_accrued_fees(),
            "chain_root": contract.balance_tree.get_root(),
            "operator_root": state.load_tree().root,
            "events": [(e.name, e.args) for e in contract.events]}


def test_backend_is_device_or_host():
    """No "auto": nothing picks the native engine because no card was
    found."""
    with pytest.raises(ValueError, match="backend"):
        TxProver(CFG, backend="auto")
    with pytest.raises(ValueError, match="backend"):
        WithdrawProver(backend="auto")
    assert TxProver(CFG).device == "cuda"
    assert (WithdrawProver().device, WithdrawProver().backend) == \
        ("cuda", "device")


def test_cli_without_a_card_fails_unless_told(monkeypatch, tmp_path):
    """A proving command with the default --device cuda and no CUDA device
    fails loudly, before any setup."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cmd in ("demo-rollup", "demo-withdraw"):
        with pytest.raises(SystemExit, match="--backend host"):
            cli.main(["--keys-dir", str(tmp_path), cmd])
    assert list(tmp_path.iterdir()) == []


def test_demo_rollup_through_the_cli(key, tmp_path):
    """python -m zkrollup_torch.cli --backend host demo-rollup, with the
    key cached in --keys-dir: A 0.57 ETH nonce 2, B 1.4 ETH, fees 0.03 on
    the contract."""
    shutil.copy(key[0], tmp_path / "tx_2_6.npz")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(["--keys-dir", str(tmp_path), "--backend", "host",
                       "demo-rollup"])
    text = out.getvalue()
    assert rc == 0, text
    assert "A: balance 0.57 ETH nonce 2" in text
    assert "B: balance 1.4 ETH nonce 0" in text
    assert "accrued fees: 0.03 ETH" in text
    assert "DEMO ROLLUP OK" in text


def test_pipeline_matches_reference(key):
    """run_pipeline(max_batches=2) settles the same balances, nonces, fees,
    roots and events as zkrollup's daemon on the same sends."""
    _, port, ref = key
    env = _port_env(port)
    try:
        got = _pipeline(env)
    finally:
        env[3].close()
    want = _pipeline(_ref_env(ref))
    assert got == want
    assert got["done"] == 2 and got["pending"] == 0
    assert got["metrics"] == (2, 4, 0)
    assert got["a"][3] == _wei(156) and got["a"][4] == 4
    assert got["b"][3] == _wei(140) and got["fees"] == _wei(4)
    assert got["chain_root"] == got["operator_root"]


class _SettleFirstQueue(TxQueue):
    """A queue whose read of batch 2 waits until batch 1 has settled: the
    order in which a prover faster than the witness stage runs."""

    def __init__(self):
        super().__init__()
        self.settled = threading.Event()
        self.reads = 0

    def peek_batch(self, *args, **kwargs):
        self.reads += 1
        if self.reads == 2:
            assert self.settled.wait(30)
        return super().peek_batch(*args, **kwargs)

    def mark_processed(self, n):
        super().mark_processed(n)
        self.settled.set()


def _no_circuit(cfg, tree, txs):
    """_RecordingProver's host stage, run in the daemon's witness worker:
    no circuit, the tree passed on."""
    return {"witness": [], "public_signals": [], "final_tree": tree}


class _RecordingProver:
    """A host stage and prove_prepared without a circuit: records the
    nonces of each batch it proves."""

    host_stage = staticmethod(_no_circuit)

    def __init__(self):
        self.batches = []

    def prove_prepared(self, prep):
        self.batches.append([t.nonce for t in prep.txs])
        return object()


class _NoChain:
    def roll_up(self, proof, public_signals):
        pass

    def load_tree(self):
        return None

    def apply_rollup_batch(self, final_tree):
        pass


def test_pipeline_reads_ahead_by_queue_index():
    """run_pipeline takes every queued tx once and in order when batch i
    settles before the witness stage reads batch i+1: it reads by queue
    index, not by an offset from the processed cursor that settling
    moves."""
    queue, prover, chain = _SettleFirstQueue(), _RecordingProver(), _NoChain()
    for nonce in range(1, 9):
        queue.push(Transaction(0, 1, WEI, WEI // 100, nonce))
    daemon = BatchDaemon(CFG, chain, queue, prover, chain)
    try:
        assert daemon.run_pipeline(max_batches=4) == 4
    finally:
        daemon.close()
    assert prover.batches == [[1, 2], [3, 4], [5, 6], [7, 8]]
    assert queue.pending_count() == 0
    assert daemon.metrics.txs_processed == 8


def _settled(env):
    contract, state, queue, daemon, *_ = env
    return {"a": contract.get_user_data(multi_hash(list(PUB_A))),
            "b": contract.get_user_data(multi_hash(list(PUB_B))),
            "fees": contract.get_accrued_fees(),
            "chain_root": contract.balance_tree.get_root(),
            "operator_root": state.load_tree().root,
            "pending": queue.pending_count(),
            "metrics": (daemon.metrics.batches_proven,
                        daemon.metrics.txs_processed,
                        daemon.metrics.proofs_failed)}


def test_pipeline_witness_runs_in_the_worker(key, monkeypatch):
    """With TxProver.prepare_batch made to raise in this process,
    run_pipeline(max_batches=2) still settles what two step() calls
    settle: its witness stage ran in the worker process."""
    _, port, _ = key
    envs = []
    for _ in range(2):
        env = _port_env(port)
        env[0].deposit(PUB_A[0], PUB_A[1], 2 * WEI)
        env[0].deposit(PUB_B[0], PUB_B[1], WEI)
        env[4].sync_chain()
        for n in range(1, 5):
            assert _send(env, PRIV_A, 0, 1, _wei(10), _wei(1), n) == {
                "status": "Transaction accepted"}
        envs.append(env)
    stepped, piped = envs
    assert stepped[3].step() and stepped[3].step()

    def in_this_process(self, tree, txs):
        raise AssertionError("prepare_batch ran in the calling process")

    monkeypatch.setattr(TxProver, "prepare_batch", in_this_process)
    try:
        assert piped[3].run_pipeline(max_batches=2) == 2
    finally:
        piped[3].close()
    got = _settled(piped)
    assert got == _settled(stepped)
    assert got["pending"] == 0 and got["metrics"] == (2, 4, 0)
    assert got["chain_root"] == got["operator_root"]


def test_pipeline_worker_failure_reaches_the_caller(key):
    """A witness stage that fails in the worker (an unsigned tx) raises in
    run_pipeline, counts as a failed proof and leaves every tx queued;
    close() ends the worker process."""
    env = _port_env(key[1])
    contract, state, queue, daemon, app, *_ = env
    contract.deposit(PUB_A[0], PUB_A[1], WEI)
    contract.deposit(PUB_B[0], PUB_B[1], WEI)
    app.sync_chain()
    for nonce in (1, 2):
        queue.push(Transaction(0, 1, _wei(10), _wei(1), nonce))
    try:
        with pytest.raises(ValueError, match="must be signed"):
            daemon.run_pipeline(max_batches=1)
        procs = list(daemon._witness_pool._processes.values())
        assert len(procs) == 1 and procs[0].is_alive()
    finally:
        daemon.close()
    procs[0].join(30)
    assert not procs[0].is_alive()
    assert daemon._witness_pool is None
    assert queue.pending_count() == 2
    assert daemon.metrics.proofs_failed == 1
    assert daemon.metrics.batches_proven == 0


def test_queue_is_safe_across_threads():
    """run_pipeline's feeder thread reads the queue while its caller
    settles batches: readers and a writer on one TxQueue at once, the
    interpreter switching threads as often as it can, lose no cursor
    update and raise nothing (one sqlite connection used from two threads
    at once without the queue's lock raised InterfaceError and lost
    updates)."""
    import sys
    queue = TxQueue()
    n = 2000
    for nonce in range(n):
        queue.push(Transaction(0, 1, WEI, WEI // 100, nonce))
    errors = []

    def read():
        try:
            for i in range(n):
                assert len(queue.peek_batch(2, start=i % (n - 2))) == 2
                queue.pending_count()
        except Exception as e:
            errors.append(e)

    def write():
        try:
            for _ in range(n // 2):
                queue.mark_processed(1)
        except Exception as e:
            errors.append(e)

    threads = [threading.Thread(target=read) for _ in range(3)]
    threads.append(threading.Thread(target=write))
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert errors == []
    assert queue.last_processed == n // 2
    assert queue.pending_count() == n - n // 2


@pytest.mark.parametrize("pkg", ["zkrollup_torch", "zkrollup"])
def test_pipeline_respects_step_lock(key, pkg):
    env = (_port_env if pkg == "zkrollup_torch" else _ref_env)(
        key[1] if pkg == "zkrollup_torch" else key[2])
    daemon = env[3]
    assert daemon._step_lock.acquire(blocking=False)
    try:
        assert daemon.run_pipeline(max_batches=1) == 0
        assert daemon.step() is False
    finally:
        daemon._step_lock.release()


def test_prove_prepared_matches_reference(key):
    """The demo batch at pinned (r, s): the port's host route gives the
    reference's proof bytes, public signals and final tree."""
    _, port, ref = key
    env, jenv = _port_env(port), _ref_env(ref)
    for e in (env, jenv):
        e[0].deposit(PUB_A[0], PUB_A[1], WEI)
        e[0].deposit(PUB_B[0], PUB_B[1], WEI)
        e[4].sync_chain()
        _send(e, PRIV_A, 0, 1, _wei(10), _wei(1), 1)
        _send(e, PRIV_A, 0, 1, _wei(30), _wei(2), 2)
    prep = port.prepare_batch(env[1].load_tree(),
                              env[2].peek_batch(2))
    jprep = ref.prepare_batch(jenv[1].load_tree(),
                              jenv[2].peek_batch(2))
    got = port.prove_prepared(prep, *PINNED)
    want = ref.prove_prepared(jprep, *PINNED)
    assert (got.a, got.b, got.c) == (want.a, want.b, want.c)
    assert prep.public_signals == jprep.public_signals
    assert prep.final_tree.root == jprep.final_tree.root
    assert port.stats.prove_s > 0 and port.stats.verify_s > 0


def _http(base, path, body=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(base + path, data=data,
                                 method="GET" if body is None else "POST")
    try:
        with urllib.request.urlopen(req) as r:
            return r.status, json.load(r)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _routes(env, prove: bool):
    """tests/test_operator_chain.py's HTTP routes, then (if `prove`) a
    batch through /admin/prove-batch: every (status, reply) in order."""
    contract, state, queue, daemon, app, ed, tx_cls, fmt = env
    server = start_app(app, port=0) if ed is eddsa else \
        jservice.start_app(app, port=0)
    base = f"http://127.0.0.1:{server.server_address[1]}"
    seen = []
    try:
        for who in (PUB_A, PUB_B):
            seen.append(_http(base, "/chain/deposit", {
                "publicKey": [str(who[0]), str(who[1])], "value": str(WEI)}))
        seen.append(_http(base, "/contracts"))
        seen.append(_http(base, "/users/index/0"))
        seen.append(_http(base, "/users/index/9"))
        seen.append(_http(base, f"/users/address/"
                                f"{hex(multi_hash(list(PUB_A)))[2:]}"))
        for nonce, amount in ((1, 10), (2, 30)):
            tx = tx_cls(0, 1, _wei(amount), _wei(1), nonce)
            tx.signature = ed.sign(PRIV_A, fmt(tx))
            seen.append(_http(base, "/send", {
                "from": 0, "to": 1, "amount": str(tx.amount),
                "fee": str(tx.fee), "nonce": nonce,
                "signature": {"R8": [str(tx.signature.R8[0]),
                                     str(tx.signature.R8[1])],
                              "S": str(tx.signature.S)}}))
        seen.append(_http(base, "/send", {}))
        seen.append(_http(base, "/metrics"))
        seen.append(_http(base, "/chain/withdraw", {"amount": "1"}))
        seen.append(_http(base, "/nowhere"))
        if not prove:
            return seen
        code, reply = _http(base, "/admin/prove-batch", {})
        # the seconds differ between runs
        reply.pop("last_prove_seconds")
        reply.pop("proofs_per_second")
        seen.append((code, reply))
        seen.append(_http(base, "/users/index/0"))
        seen.append(_http(base, "/users/index/1"))
    finally:
        server.shutdown()
        server.server_close()
    return seen, contract.balance_tree.get_root(), state.load_tree().root


def test_http_routes_match_reference(key):
    """The routes answer as zkrollup's do, over a socket; then the batch
    the service proves settles A 0.58 ETH nonce 2 and B 1.4 ETH (the
    reference's settlement is held equal in test_pipeline_matches_reference)."""
    seen, chain_root, operator_root = _routes(_port_env(key[1]), prove=True)
    assert seen[:12] == _routes(_ref_env(key[2]), prove=False)
    assert seen[6] == (201, {"status": "Transaction accepted"})
    assert seen[8][0] == 400 and "Missing parameters" in seen[8][1]["error"]
    assert seen[12][1]["processed"] is True
    assert seen[13][1]["balance"] == str(_wei(58)) and seen[13][1]["nonce"] == 2
    assert seen[14][1]["balance"] == str(_wei(140))
    assert chain_root == operator_root


def test_cli_service_flow():
    """The service-mode commands over a socket: deposit, send (automatic
    fee and nonce), user, and prove-batch without a daemon."""
    contract = RollUpContract(CFG, tx_vk=None, withdraw_vk=None)
    state, queue = OperatorState(CFG), TxQueue()
    server = start_app(OperatorApp(CFG, state, queue, contract), port=0)
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            for user in ("A", "B"):
                assert cli.main(["--url", base, "deposit", "--user", user,
                                 "--eth", "1"]) == 0
            assert state.load_tree().next_leaf_index == 2
            assert cli.main(["--url", base, "send", "--from", "A", "--to",
                             "B", "--eth", "0.1"]) == 0
            assert queue.pending_count() == 1
            assert queue.pending_txs()[0].fee == _wei(10) // 1000 * 3
            assert cli.main(["--url", base, "user", "--user", "A"]) == 0
            assert cli.main(["--url", base, "user", "--index", "1"]) == 0
            assert cli.main(["--url", base, "user", "--index", "9"]) == 1
            assert cli.main(["--url", base, "prove-batch"]) == 1
    finally:
        server.shutdown()
        server.server_close()


def test_deploy_matches_reference(key, tmp_path):
    """The deploy artifacts: the same addresses and the same Solidity
    verifiers as zkrollup's deploy for the same verifying keys."""
    vk = key[1].ensure_keys().vk
    jvk = key[2].ensure_keys().vk
    contract, addrs = deploy(CFG, tx_vk=vk, withdraw_vk=vk,
                             build_dir=str(tmp_path / "port"))
    _, jaddrs = jdeploy.deploy(JConfig(), tx_vk=jvk, withdraw_vk=jvk,
                               build_dir=str(tmp_path / "ref"))
    assert addrs == jaddrs
    assert load_deployed_addresses(str(tmp_path / "port")) == addrs
    for name in ("TxVerifier.sol", "WithdrawVerifier.sol"):
        src = (tmp_path / "port" / name).read_text()
        assert src == (tmp_path / "ref" / name).read_text()
        assert f"contract {name[:-4]}" in src
    contract.deposit(PUB_A[0], PUB_A[1], WEI)
    assert contract.get_user_key(0) != 0


def test_demo_withdraw_through_the_cli(tmp_path):
    """python -m zkrollup_torch.cli --backend host demo-withdraw: a key
    from setup_host, the payout, then nullifier reuse rejected."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(["--keys-dir", str(tmp_path), "--backend", "host",
                       "demo-withdraw"])
    text = out.getvalue()
    assert rc == 0, text
    assert "withdrew 0.4 ETH; remaining 0.6" in text
    assert "nullifier reuse rejected: Nullifier has been used" in text
    assert (tmp_path / "withdraw.npz").exists()


def test_withdraw_prover_matches_reference(tmp_path):
    """WithdrawProver on the host route against zkrollup's, which loads
    the port's key: the same proof bytes and public signals at pinned
    (r, s); the contract pays once per nullifier."""
    path = str(tmp_path / "withdraw.npz")
    port = WithdrawProver(key_path=path, setup_seed=b"withdraw",
                          backend="host")
    pk = port.ensure_keys()
    assert (pk.n_vars, pk.n_public, pk.domain_size) == (3585, 4, 4096)
    ref = jprover.WithdrawProver(key_path=path)
    assert vars(ref.ensure_keys().vk) == vars(pk.vk)
    fpriv = eddsa.format_priv_key_for_babyjub(PRIV_A)
    got, signals = port.prove_withdraw(fpriv, 4242, *PINNED)
    want, jsignals = ref.prove_withdraw(fpriv, 4242, *PINNED)
    assert (got.a, got.b, got.c) == (want.a, want.b, want.c)
    assert signals == jsignals and len(signals) == 3
    contract = RollUpContract(CFG, tx_vk=None, withdraw_vk=pk.vk)
    contract.deposit(PUB_A[0], PUB_A[1], WEI)
    assert contract.withdraw(_wei(40), got, signals) == _wei(40)
    with pytest.raises(ValueError, match="Nullifier has been used"):
        contract.withdraw(_wei(10), got, signals)
    assert contract.get_user_data(multi_hash(list(PUB_A)))[3] == _wei(60)


def test_withdraw_prover_replaces_a_stale_key(tmp_path, capsys):
    """A cached key of another circuit is not used: ensure_keys warns,
    makes the withdraw key and saves it over the stale one, creating the
    key's directory."""
    from zkrollup_torch.groth16.keys import ProvingKey
    from zkrollup_torch.groth16.setup import setup_host
    from zkrollup_torch.r1cs.builder import Builder
    bld = Builder()
    out = bld.alloc_output_deferred()
    x = bld.alloc_public_input(3)
    bld.bind_output(out, bld.mul(x, x))
    path = tmp_path / "new" / "withdraw.npz"
    path.parent.mkdir()
    setup_host(bld.r1cs(), seed=b"stale").save(str(path))
    fresh = WithdrawProver(key_path=str(tmp_path / "other" / "w.npz"),
                           setup_seed=b"w", backend="host").ensure_keys()
    assert (tmp_path / "other" / "w.npz").exists()
    prover = WithdrawProver(key_path=str(path), setup_seed=b"w",
                            backend="host")
    pk = prover.ensure_keys()
    assert "stale R1CS digest" in capsys.readouterr().err
    assert pk.r1cs_digest == r1cs_digest(prover.structure_r1cs())
    assert vars(pk.vk) == vars(fresh.vk)
    assert vars(ProvingKey.load(str(path)).vk) == vars(pk.vk)
