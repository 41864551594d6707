"""Deployment pipeline — parity with the reference's truffle migrations.

Mirrors simple-zk-rollups/contracts/migrations/3_deploy_contracts.js:14-56
(and 2_deploy_mimcsponge.js): wire hasher -> tree -> verifiers -> RollUp,
whitelist RollUp on the tree, and persist the deploy artifacts:

    build/DeployedAddresses.json     same keys as the reference artifact
                                     (operator/src/utils/env.ts:26-50
                                     reads it in dev mode)
    build/TxVerifier.sol             Solidity Groth16 verifiers regenerated
    build/WithdrawVerifier.sol       from THIS deployment's verifying keys
                                     (keys+verifiers are only valid as a
                                     set — SURVEY §3.5 note)

There is no EVM in this environment; the chain simulator IS the settlement
layer, so "addresses" are the simulator's stable identifiers.
"""

from __future__ import annotations

import json
import os
from typing import Optional, Tuple

from ..config import RollupConfig
from .simulator import RollUpContract
from .genverifier import generate_verifier


def deploy(cfg: RollupConfig, tx_vk, withdraw_vk,
           build_dir: Optional[str] = None) -> Tuple[RollUpContract, dict]:
    """Deploy the contract system; optionally write build artifacts.
    Returns (rollup contract, DeployedAddresses dict)."""
    contract = RollUpContract(cfg, tx_vk=tx_vk, withdraw_vk=withdraw_vk)
    addresses = {
        "balanceTreeAddress": "sim://balanceTree",
        "rollUpAddress": RollUpContract.ADDRESS,
        "withdrawVerifierAddress": "sim://withdrawVerifier",
        "txVerifierAddress": "sim://txVerifier",
    }
    if build_dir:
        os.makedirs(build_dir, exist_ok=True)
        with open(os.path.join(build_dir, "DeployedAddresses.json"),
                  "w") as f:
            json.dump(addresses, f, indent=1)
        if tx_vk is not None:
            with open(os.path.join(build_dir, "TxVerifier.sol"), "w") as f:
                f.write(generate_verifier(tx_vk, name="TxVerifier"))
        if withdraw_vk is not None:
            with open(os.path.join(build_dir, "WithdrawVerifier.sol"),
                      "w") as f:
                f.write(generate_verifier(withdraw_vk,
                                          name="WithdrawVerifier"))
    return contract, addresses


def load_deployed_addresses(build_dir: str) -> dict:
    """env.ts:26-50 analog: read the deploy artifact."""
    with open(os.path.join(build_dir, "DeployedAddresses.json")) as f:
        return json.load(f)
