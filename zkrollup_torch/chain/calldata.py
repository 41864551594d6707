"""Solidity calldata formatting + minimal ABI encoding for the RollUp ABI.

Parity with the reference's proof reformatter
(simple-zk-rollups/operator/src/snarks/common.ts:40-51): proof points become
uint256 arrays with pi_b's INNER Fq2 coordinates REVERSED (EVM pairing
precompile expects (imag, real) ordering), inputs reduced mod r. The ABI
encoder covers the static tuple/array shapes RollUp.sol uses so calldata
hex can be produced for a real chain without web3 dependencies.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

from ..ref.bn254 import R as FR_MOD
from ..ref.keccak import keccak256
from ..groth16.keys import Proof


def to_solidity_proof(proof: Proof, public_signals: Sequence[int]) -> Dict:
    """{a, b, c, inputs} with the pi_b inner-coordinate reversal
    (common.ts:45-47)."""
    ax, ay = proof.a
    bx, by = proof.b
    cx, cy = proof.c
    return {
        "a": [ax, ay],
        "b": [[bx[1], bx[0]], [by[1], by[0]]],
        "c": [cx, cy],
        "inputs": [s % FR_MOD for s in public_signals],
    }


def _u256(x: int) -> bytes:
    return int(x).to_bytes(32, "big")


def encode_static_words(words: Sequence[int]) -> bytes:
    return b"".join(_u256(w) for w in words)


def function_selector(signature: str) -> bytes:
    return keccak256(signature.encode())[:4]


def rollup_calldata(proof: Proof, inputs: Sequence[int]) -> bytes:
    """calldata for rollUp(uint[2],uint[2][2],uint[2],uint[73])
    (RollUp.sol:81-86) — all-static ABI, words in declaration order."""
    sp = to_solidity_proof(proof, inputs)
    n = len(sp["inputs"])
    sel = function_selector(
        f"rollUp(uint256[2],uint256[2][2],uint256[2],uint256[{n}])")
    words = (sp["a"] + sp["b"][0] + sp["b"][1] + sp["c"] + sp["inputs"])
    return sel + encode_static_words(words)


def withdraw_calldata(amount: int, proof: Proof,
                      inputs: Sequence[int]) -> bytes:
    """withdraw(uint256,uint[2],uint[2][2],uint[2],uint[3])
    (RollUp.sol:212-218)."""
    sp = to_solidity_proof(proof, inputs)
    sel = function_selector(
        "withdraw(uint256,uint256[2],uint256[2][2],uint256[2],uint256[3])")
    words = ([amount] + sp["a"] + sp["b"][0] + sp["b"][1] + sp["c"]
             + sp["inputs"])
    return sel + encode_static_words(words)


def deposit_calldata(public_key_x: int, public_key_y: int) -> bytes:
    """deposit(uint256,uint256) (RollUp.sol:255)."""
    sel = function_selector("deposit(uint256,uint256)")
    return sel + encode_static_words([public_key_x, public_key_y])
