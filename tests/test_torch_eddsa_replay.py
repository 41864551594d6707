"""zkrollup_torch.r1cs.eddsa_replay, the witness-only replay of the EdDSA
gadget, against the LC gadget it replays, on the CPU:

- one signature synthesized witness-only (record=False, the replay) and
  with the R1CS recorded (record=True, the LC gadget), under check=True
  and check=False: the same values element for element, the same row
  count and `valid` variable, or the same AssertionError. Cases: valid
  signatures, a wrong message, S >= SUB_ORDER, S >= 2^253, a low-order A,
  an R8 off the curve; and, where the replay declines and the LC gadget
  runs, an A off the curve whose ladder meets a zero denominator and an
  A given as constants;
- a whole BatchProcessTx(2, 6) witness-only synthesis equals the
  recorded one (witness, public signals, rows);
- prepare_fields opens one synth.signature.replay under each
  synth.signature; a recorded synthesis opens none.
"""

import random

import pytest

from zkrollup_torch import spans
from zkrollup_torch.config import RollupConfig
from zkrollup_torch.r1cs import gadgets as g
from zkrollup_torch.r1cs.builder import Builder
from zkrollup_torch.r1cs.circuits import synthesize_batch_process_tx
from zkrollup_torch.ref import babyjubjub as bjj
from zkrollup_torch.ref import eddsa
from zkrollup_torch.ref.bn254 import R as P
from zkrollup_torch.ref.mimc import multi_hash
from zkrollup_torch.spans import span
from zkrollup_torch.tree.merkle import create_merkle_tree
from zkrollup_torch.witness.assembler import (Transaction, assemble_batch_inputs,
                                              format_tx, hash_balance_tree_leaf)
from zkrollup_torch.witness.batch import prepare_fields

REPLAY = "synth.signature.replay"

# An A off the curve whose 8A = M0 (three formula doublings) has
# 1 + D x(M0) x(M1) y(M0) y(M1) = 0 for M1 = 2 M0: the variable-base
# ladder's step 1 divides by zero where h is odd. Found by solving for M0
# with x(M0) y(M0) = 11 and halving it three times by the addition law
# (square roots mod p); the test checks the property itself.
ZERO_DEN_A = (
    16585700535479179409729061074844231729082697142451177472013829530509944260974,
    519737940390816071740094013731470448636622222328326492104804270998603274887,
)

# case: (raises under check=True, `valid` under check=False or None where
# the values alone are compared)
CASES = {
    "valid-0": (False, 1),
    "valid-1": (False, 1),
    "valid-2": (False, 1),
    "wrong-message": (False, 0),
    "s-above-suborder": (True, 1),      # S + SUB_ORDER: same S B8
    "s-above-2^253": (True, 1),         # the ladder reads S's low 253 bits
    "low-order-a": (True, None),
    "r8-off-curve": (False, 0),
    "zero-denominator": (True, None),
    "constant-a": (False, 1),           # A passed as ints: the replay declines
}


def _signed(seed: int):
    rng = random.Random(seed)
    priv = rng.getrandbits(250)
    preimage = [rng.randrange(P) for _ in range(5)]
    sig = eddsa.sign(priv, preimage)
    return eddsa.gen_public_key(priv), sig, preimage


def _inputs(case: str):
    """(A, R8, S, preimage) of a case."""
    if case.startswith("valid-"):
        a, sig, pre = _signed(int(case[-1]))
        return a, sig.R8, sig.S, pre
    a, sig, pre = _signed(7)
    if case == "constant-a":
        return a, sig.R8, sig.S, pre
    if case == "wrong-message":
        return a, sig.R8, sig.S, [pre[0] + 1, *pre[1:]]
    if case == "s-above-suborder":
        return a, sig.R8, sig.S + bjj.SUB_ORDER, pre
    if case == "s-above-2^253":
        return a, sig.R8, sig.S + (1 << 253), pre
    if case == "low-order-a":
        return (0, P - 1), sig.R8, sig.S, pre     # order 2: 8A = identity
    if case == "r8-off-curve":
        return a, (sig.R8[0], sig.R8[1] + 1), sig.S, pre
    assert case == "zero-denominator"
    for k in range(64):                           # an odd h
        pre = [k, 1, 2, 3, 4]
        h = multi_hash([*sig.R8, *ZERO_DEN_A, multi_hash(pre)])
        if h & 1:
            return ZERO_DEN_A, sig.R8, sig.S, pre
    raise AssertionError("no odd h in 64 messages")


def _synthesize(record: bool, check: bool, inputs, constant_a=False):
    """One signature in a fresh builder: ("valid", its LC's terms,
    witness, rows) or ("raised", the message); and the replay spans.
    constant_a passes A's coordinates as ints, not variables."""
    (ax, ay), (r8x, r8y), s, pre = inputs
    bld = Builder(check=check, record=record)
    lcs = [bld.alloc_public_input(v) for v in (ax, ay, r8x, r8y, s, *pre)]
    if constant_a:
        lcs[:2] = [ax, ay]
    with spans.trace() as t, span("synth.signature"):
        try:
            valid = g.verify_eddsa_signature(bld, *lcs[:5], lcs[5:])
            got = ("valid", valid.terms, bld.witness(), len(bld.constraints))
        except AssertionError as e:
            got = ("raised", str(e))
    return got, [s for s in t.spans() if s.name == REPLAY]


def test_zero_denominator_case_divides_by_zero():
    """ZERO_DEN_A's 8A and 16A make the ladder's step-1 denominator 1 + f
    zero, and A is off the curve (the law is complete on it)."""
    m0 = ZERO_DEN_A
    for _ in range(3):
        m0 = bjj.double(m0)
    m1 = bjj.double(m0)
    f = bjj.D * m0[0] % P * m1[0] % P * m0[1] % P * m1[1] % P
    assert (1 + f) % P == 0
    assert not bjj.is_on_curve(ZERO_DEN_A)


@pytest.mark.parametrize("check", [True, False], ids=["check", "nocheck"])
@pytest.mark.parametrize("case", list(CASES))
def test_replay_matches_the_gadget(case, check):
    """record=False (the replay) gives record=True's (the LC gadget's)
    values, rows and `valid`, or its AssertionError; one replay span
    where the replay wrote the witness, none where it declined (the zero
    denominator, a constant A) or raised before its points, none when
    recording."""
    inputs = _inputs(case)
    constant_a = case == "constant-a"
    want, recorded_spans = _synthesize(True, check, inputs, constant_a)
    got, replay_spans = _synthesize(False, check, inputs, constant_a)
    assert got == want
    assert recorded_spans == []
    raises, valid = CASES[case]
    if check and raises:
        assert want[0] == "raised"
    else:
        assert want[0] == "valid"
        (idx, coeff), = want[1].items()
        assert coeff == 1
        if valid is not None:
            assert want[2][idx] == valid
    declined = case in ("zero-denominator", "constant-a") or (
        check and case.startswith("s-above"))
    assert len(replay_spans) == (0 if declined else 1)


# -- a whole batch ------------------------------------------------------------

CFG = RollupConfig(batch_size=2, tree_depth=6)
PRIVS = (31415926535, 27182818284)


@pytest.fixture(scope="module")
def batch():
    """A depth-6 tree with two funded accounts and two signed transfers."""
    tree = create_merkle_tree(CFG.tree_depth)
    for priv in PRIVS:
        leaf = {"publicKey": list(eddsa.gen_public_key(priv)),
                "balance": 10 ** 18, "nonce": 0}
        tree.insert_(hash_balance_tree_leaf(leaf), leaf)
    txs = []
    for i, (frm, to) in enumerate(((0, 1), (1, 0)), start=1):
        tx = Transaction(frm, to, 10 ** 16 * i, 10 ** 15, 1)    # nonce 1
        tx.signature = eddsa.sign(PRIVS[frm], format_tx(tx))
        txs.append(tx)
    return tree, txs


def test_whole_batch_witness_matches_recorded_synthesis(batch):
    """BatchProcessTx(2, 6) on honest inputs: the witness-only synthesis
    (both signatures replayed) gives the recorded synthesis's witness,
    public signals and row count."""
    inputs, _ = assemble_batch_inputs(*batch)
    want = synthesize_batch_process_tx(inputs, CFG.batch_size,
                                       CFG.tree_depth, record=True)
    got = synthesize_batch_process_tx(inputs, CFG.batch_size,
                                      CFG.tree_depth, record=False)
    assert got.witness == want.witness
    assert got.public_signals == want.public_signals
    assert len(got.builder.constraints) == want.r1cs.n_constraints


def test_prepare_fields_replays_every_signature(batch):
    """prepare_fields: one synth.signature.replay child under each
    synth.signature; a recorded synthesis of the batch opens none."""
    found = prepare_fields(CFG, *batch)["spans"]
    sigs = [s for s in found if s.name == "synth.signature"]
    replays = [s for s in found if s.name == REPLAY]
    assert len(sigs) == CFG.batch_size
    assert sorted(s.parent for s in replays) == sorted(s.id for s in sigs)
    inputs, _ = assemble_batch_inputs(*batch)
    with spans.trace() as t:
        synthesize_batch_process_tx(inputs, CFG.batch_size, CFG.tree_depth,
                                    record=True)
    assert [s for s in t.spans() if s.name == REPLAY] == []
