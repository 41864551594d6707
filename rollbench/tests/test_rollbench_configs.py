"""Every configuration file's sizes are its circuit's: n_vars,
n_constraints, n_public, public_signals and domain against the frozen
reference's structure synthesis (check=False, all-zero inputs: the
constraint structure does not depend on them). tx_b15_d20's synthesis
takes about 20 s and 2 GB of host memory."""

import glob
import json
import os

import pytest

from rollbench import harness
from rollbench.reference import circuits
from rollbench.reference.groth16 import domain

FILES = sorted(glob.glob(os.path.join(harness.ROOT, "rollbench", "configs",
                                      "*.json")))


def _zero_batch(b: int, d: int) -> dict:
    z = 0
    return {
        "balanceTreeRoot": [z] * b,
        "txData": [[z] * 8 for _ in range(b)],
        "txSenderPublicKey": [[z, z] for _ in range(b)],
        "txSenderBalance": [z] * b,
        "txSenderNonce": [z] * b,
        "txSenderPathElements": [[z] * d for _ in range(b)],
        "txRecipientPublicKey": [[z, z] for _ in range(b)],
        "txRecipientBalance": [z] * b,
        "txRecipientNonce": [z] * b,
        "txRecipientPathElements": [[z] * d for _ in range(b)],
        "intermediateBalanceTreeRoot": [z] * b,
        "intermediateBalanceTreePathElements": [[z] * d for _ in range(b)],
    }


def test_every_configuration_is_checked():
    names = {os.path.basename(f)[:-5] for f in FILES}
    assert {"tx_b2_d6", "withdraw", "tx_b15_d20"} <= names
    bench = harness.benchmark()
    assert {os.path.join(harness.ROOT, c["file"])
            for c in bench["configs"]} <= set(FILES)


@pytest.mark.parametrize("path", FILES,
                         ids=[os.path.basename(f)[:-5] for f in FILES])
def test_sizes_are_the_circuits(path):
    with open(path) as f:
        config = json.load(f)
    if config["circuit"] == "withdraw":
        res = circuits.synthesize_withdraw(0, 0, check=False)
    else:
        b, d = config["batch_size"], config["tree_depth"]
        res = circuits.synthesize_batch_process_tx(_zero_batch(b, d), b, d,
                                                   check=False)
    r1cs = res.r1cs
    got = {"n_vars": r1cs.n_vars, "n_constraints": r1cs.n_constraints,
           "n_public": r1cs.n_public,
           "public_signals": len(res.public_signals),
           "domain": domain(r1cs.n_constraints, r1cs.n_public)}
    assert got == {k: config[k] for k in got}
    assert config["name"] == os.path.basename(path)[:-5]
