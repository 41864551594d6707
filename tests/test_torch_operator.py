"""zkrollup_torch's TxProver against the reference's interface: prove_batch
runs ensure_keys, prepare_batch and prove_prepared and returns (proof,
public signals, final tree) in the reference's order; prove_prepared asks
prove for no stage timings; _structure_r1cs is the reference's name of
structure_r1cs.

groth16.prove is monkeypatched (a stand-in under its span): a
BatchProcessTx proof on the CPU's plain kernels takes minutes. The card test of prove_batch is in
test_torch_cuda.py."""

import inspect

import pytest
import torch

from zkrollup.operator import prover as jprover
from zkrollup_torch.config import RollupConfig
from zkrollup_torch.operator import prover as P
from zkrollup_torch.ref import eddsa
from zkrollup_torch.spans import span
from zkrollup_torch.tree.merkle import create_merkle_tree
from zkrollup_torch.witness.assembler import (Transaction, format_tx,
                                              hash_balance_tree_leaf)

torch.set_num_threads(1)

PRIV = 41516261718191101


class _Key:
    vk = "vk"


@pytest.fixture
def patched(monkeypatch):
    """A BatchProcessTx(1, 4) prover whose prove and verify are recorded
    stand-ins, with a stand-in key; returns (prover, calls)."""
    calls = []

    def prove(pk, r1cs, witness, r=None, s=None, **kw):
        with span("groth16.prove"):
            calls.append(("prove", kw))
            return ("proof", len(witness), r, s)

    def verify(vk, proof, signals):
        calls.append(("verify", vk, proof))
        return True

    monkeypatch.setattr(P, "prove", prove)
    monkeypatch.setattr(P, "verify", verify)
    prover = P.TxProver(RollupConfig(batch_size=1, tree_depth=4),
                        device="cpu")
    prover.pk = _Key()
    for name in ("ensure_keys", "prepare_batch", "prove_prepared"):
        method = getattr(prover, name)

        def logged(*a, _name=name, _method=method, **kw):
            calls.append((_name,))
            return _method(*a, **kw)
        monkeypatch.setattr(prover, name, logged)
    return prover, calls


def _batch(cfg):
    tree = create_merkle_tree(cfg.tree_depth)
    for k in (PRIV, PRIV + 1):
        leaf = {"publicKey": list(eddsa.gen_public_key(k)),
                "balance": 10 ** 18, "nonce": 0}
        tree.insert_(hash_balance_tree_leaf(leaf), leaf)
    tx = Transaction(0, 1, 10 ** 17, 10 ** 15, 1)
    tx.signature = eddsa.sign(PRIV, format_tx(tx))
    return tree, [tx]


def test_prove_batch_returns_prepared_results_in_reference_order(patched):
    prover, calls = patched
    tree, txs = _batch(prover.cfg)
    proof, signals, final = prover.prove_batch(tree, txs, r=5, s=6)
    prep = P.TxProver.prepare_batch(prover, tree, txs)
    assert proof == ("proof", len(prep.witness), 5, 6)
    assert signals == prep.public_signals
    assert final.root == prep.final_tree.root
    assert final.leaves_raw[0]["nonce"] == 1
    assert tree.leaves_raw[0]["nonce"] == 0      # the snapshot is kept
    names = [c[0] for c in calls]
    assert names[:3] == ["ensure_keys", "prepare_batch", "prove_prepared"]
    assert names[-2:] == ["prove", "verify"]


def test_prove_prepared_passes_no_timings(patched):
    """No stage timings asked of prove (they synchronise the device); the
    stats come from the proof's spans."""
    prover, calls = patched
    prep = prover.prepare_batch(*_batch(prover.cfg))
    prover.structure_r1cs()          # made once, on the first proof
    proof = prover.prove_prepared(prep, r=1, s=2)
    (kw,) = [c[1] for c in calls if c[0] == "prove"]
    assert "timings" not in kw
    assert kw == {"device": "cpu", "c": 12, "glv": False, "tree": "scan"}
    assert ("verify", "vk", proof) in calls
    st = prover.stats
    assert set(st.stages) == {"groth16.prove", "groth16.verify"}
    assert st.prove_s == st.stages["groth16.prove"] > 0
    assert st.verify_s == st.stages["groth16.verify"] > 0
    assert st.witness_s == prep.witness_s > 0


def test_prove_prepared_raises_on_a_proof_that_does_not_verify(patched,
                                                              monkeypatch):
    prover, _ = patched
    monkeypatch.setattr(P, "verify", lambda *a: False)
    with pytest.raises(RuntimeError, match="Invalid proof"):
        prover.prove_batch(*_batch(prover.cfg))


def test_structure_r1cs_has_the_reference_name():
    assert P.TxProver._structure_r1cs is P.TxProver.structure_r1cs
    assert hasattr(jprover.TxProver, "_structure_r1cs")
    ours = inspect.signature(P.TxProver.prove_batch)
    ref = inspect.signature(jprover.TxProver.prove_batch)
    assert list(ours.parameters) == list(ref.parameters)
