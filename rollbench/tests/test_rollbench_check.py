"""The check that decides `correct`, driven through the rest of a run on
the CPU: the look for a card skipped, the program's prove and setup on its
native host engine (the same proof bytes as the card's, which these tests
do not need), short windows. A sound run reads correct; the control (the
reference, quotient or a batch's credits left out, in the program's place)
and each fault planted in the program beneath the timed path read not
correct: a proof or a public signal altered where it is produced, a state
update that leaves the state unchanged, half of each batch left out of the
contract's replay. The card's readings come from rollbench/control.py."""

import os

import pytest

from rollbench import harness
from rollbench.reference import bn254


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """One checkout-like root for the module: the keys made once."""
    return str(tmp_path_factory.mktemp("rollbench_root"))


@pytest.fixture
def host(monkeypatch):
    import zkrollup_torch.operator.prover as P
    monkeypatch.setattr(P, "prove", lambda pk, r1cs, w, r=None, s=None,
                        **k: P.prove_host(pk, r1cs, w, r=r, s=s))
    monkeypatch.setattr(P, "setup", lambda r1cs, seed=None, device=None:
                        P.setup_host(r1cs, seed=seed))
    return P


def run(root, cell_name, seconds=1.0, control=False, **mix):
    """A cell named <config>.<traffic>, from its files (the withdraw
    configuration has no cell in BENCHMARK.json yet)."""
    config_name, traffic = cell_name.split(".")
    cell = {"name": cell_name, "config": config_name, "traffic": traffic,
            "chips": 1}
    config = harness.load_json(os.path.join(
        harness.ROOT, "rollbench", "configs", f"{config_name}.json"))
    base = harness.load_json(os.path.join(
        harness.ROOT, "rollbench", "traffic", f"{traffic}.json"))
    ctx = harness.Context(root=root, cell=cell, config=config,
                          mix={**base, **mix}, seed=2 ** 31 + 77,
                          device="cpu")
    r, loop = harness.measure(ctx, seconds, False, 0.0)
    loop.release()
    checks = loop.check(control=control)
    failed = len(r.calls) - len(r.done())
    ok = failed == 0 and all(v <= lim for _, v, lim in checks)
    return ok, dict((n, v) for n, v, _ in checks), r


def test_withdraw_sound_and_control(root, host):
    ok, checks, r = run(root, "withdraw.prove")
    assert ok and checks["proofs_wrong"] == 0 and len(r.done()) >= 1
    ok, checks, r = run(root, "withdraw.prove", control=True)
    assert not ok and checks["proofs_wrong"] == len(r.done())


def test_withdraw_proof_altered(root, host, monkeypatch):
    prove = host.prove

    def altered(*a, **k):
        p = prove(*a, **k)
        return host.Proof(a=bn254.g1_neg(p.a), b=p.b, c=p.c)
    monkeypatch.setattr(host, "prove", altered)
    monkeypatch.setattr(host, "verify", lambda *a: True)
    ok, checks, _ = run(root, "withdraw.prove")
    assert not ok and checks["proofs_wrong"] > 0


def test_withdraw_signal_altered(root, host, monkeypatch):
    synth = host.synthesize_withdraw

    class Altered:
        def __init__(self, res):
            self.r1cs = res.r1cs
            self.witness = res.witness
            self.public_signals = [res.public_signals[0] + 1,
                                   *res.public_signals[1:]]

    monkeypatch.setattr(host, "synthesize_withdraw",
                        lambda *a, **k: Altered(synth(*a, **k)))
    monkeypatch.setattr(host, "verify", lambda *a: True)
    ok, checks, _ = run(root, "withdraw.prove")
    assert not ok and checks["signals_wrong"] > 0


def test_withdraw_proof_rejected(root, host, monkeypatch):
    """Proofs that fail their self-verify after the warm-up never come:
    counted missing."""
    verify, calls = host.verify, []

    def after_warmup(*a):
        calls.append(1)
        return verify(*a) and len(calls) <= 2
    monkeypatch.setattr(host, "verify", after_warmup)
    ok, checks, r = run(root, "withdraw.prove")
    assert not ok and checks["proofs_missing"] == len(r.calls) > 0


def test_tx_prove_sound_and_control(root, host):
    ok, checks, r = run(root, "tx_b2_d6.prove", pool=2, warmup_calls=1)
    assert ok and checks["signals_wrong"] == 0 and len(r.done()) >= 1
    ok, checks, _ = run(root, "tx_b2_d6.prove", control=True, pool=2,
                        warmup_calls=1)
    assert not ok and checks["proofs_wrong"] > 0


OPERATOR = dict(txs=10, warmup_batches=1)


def test_operator_sound_and_control(root, host):
    ok, checks, r = run(root, "tx_b2_d6.operator", **OPERATOR)
    assert ok and len(r.done()) >= 1
    ok, checks, _ = run(root, "tx_b2_d6.operator", control=True, **OPERATOR)
    assert not ok and checks["state_wrong"] > 0


def test_operator_state_unchanged(root, host, monkeypatch):
    from zkrollup_torch.operator.state import OperatorState
    monkeypatch.setattr(OperatorState, "apply_rollup_batch",
                        lambda self, tree: None)
    ok, checks, _ = run(root, "tx_b2_d6.operator", **OPERATOR)
    assert not ok and checks["state_wrong"] > 0


def test_operator_half_batch_left_out(root, host, monkeypatch):
    from zkrollup_torch.chain import simulator
    roll_up = simulator.RollUpContract.roll_up

    def half(self, proof, inputs):
        inputs = list(inputs)
        off = self.cfg.tx_data_offset + 8 * (self.cfg.batch_size // 2)
        inputs[off + 2] = inputs[off + 3] = 0   # amount, fee
        return roll_up(self, proof, inputs)
    monkeypatch.setattr(simulator.RollUpContract, "roll_up", half)
    monkeypatch.setattr(simulator, "groth16_verify", lambda *a: True)
    ok, checks, _ = run(root, "tx_b2_d6.operator", **OPERATOR)
    assert not ok and checks["state_wrong"] > 0
