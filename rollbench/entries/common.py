"""What the entry loops share: the program's objects built from the
benchmark's inputs, the cached proving key, and the reference's side of the
rollup state."""

from __future__ import annotations

import os
from typing import Dict, List

from ..reference import assembler as ref_asm
from ..reference import circuits as ref_circuits
from ..reference import eddsa as ref_eddsa
from ..reference import merkle as ref_merkle


def key_path(ctx) -> str:
    """The proving key's cache: a fixed path inside the checkout, one file
    a configuration. The key is made from the configuration's setup seed
    (the deployment's ceremony) on the first run and loaded, as an
    operator's restart loads it, by every later one."""
    return os.path.join(ctx.root, "build", "rollbench", "keys",
                        f"{ctx.config['name']}.npz")


def setup_seed(config: Dict) -> bytes:
    return config["setup_seed"].encode()


def rollup_config(config: Dict):
    from zkrollup_torch.config import RollupConfig
    return RollupConfig(tree_depth=config["tree_depth"],
                        batch_size=config["batch_size"])


def program_tx(t: Dict):
    """A benchmark transfer as the program's signed Transaction."""
    from zkrollup_torch.ref.eddsa import Signature
    from zkrollup_torch.witness.assembler import Transaction
    return Transaction(t["from"], t["to"], t["amount"], t["fee"],
                       t["nonce"], Signature(R8=tuple(t["R8"]), S=t["S"]))


def deposit_all(contract, state, accts: List[Dict]) -> None:
    """Each account deposits on the contract, in order, and the operator's
    state follows the contract's events."""
    for a in accts:
        contract.deposit(a["pub"][0], a["pub"][1], a["deposit"])
    for ev in contract.events:
        state.on_chain_event(ev)


# -- the reference's side ----------------------------------------------------

def reference_tx(t: Dict):
    return ref_asm.Transaction(
        t["from"], t["to"], t["amount"], t["fee"], t["nonce"],
        ref_eddsa.Signature(R8=tuple(t["R8"]), S=t["S"]))


def reference_tree(config: Dict, accts: List[Dict]):
    """The balance tree after the deposits, each leaf hash(pub, balance,
    nonce 0) at the account's index."""
    tree = ref_merkle.create_merkle_tree(config["tree_depth"], 0)
    for a in accts:
        leaf = {"publicKey": list(a["pub"]), "balance": a["deposit"],
                "nonce": 0}
        tree.insert_(ref_asm.hash_balance_tree_leaf(leaf), leaf)
    return tree


def reference_batch(config: Dict, tree, txs: List[Dict], record=False):
    """(synthesis result, tree after the batch) of one batch on `tree`."""
    inputs, final = ref_asm.assemble_batch_inputs(
        tree, [reference_tx(t) for t in txs])
    res = ref_circuits.synthesize_batch_process_tx(
        inputs, config["batch_size"], config["tree_depth"], record=record)
    return res, final
