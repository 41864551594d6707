"""Solidity Groth16 verifier generator.

Parity with the reference's `snarkjs generateverifier` build step
(simple-zk-rollups/prover/package.json:36,39), which emits
TxVerifier.sol / WithdrawVerifier.sol with the verifying key embedded as
contract constants. Given one of our VerifyingKeys this produces a
standalone Solidity contract with the exact external ABI the RollUp
contract calls (`verifyProof(uint[2], uint[2][2], uint[2], uint[N])` —
simple-zk-rollups/contracts/contracts/TxVerifier.sol:277-296) and the same
precompile-based verification procedure (ecAdd 0x6 / ecMul 0x7 /
pairing 0x8; vk_x = IC_0 + sum input_i * IC_{i+1}; 4-term pairing product).

The emitted source is original (not the snarkjs template); only the ABI and
acceptance semantics match.
"""

from __future__ import annotations

from typing import List

from ..groth16.keys import VerifyingKey

_TEMPLATE = """\
// SPDX-License-Identifier: MIT
// Auto-generated Groth16 verifier ({name}) — zkrollup-tpu framework.
// ABI-compatible with the reference rollup's verifier contracts.
pragma solidity ^0.5.11;

contract {name} {{
    uint256 constant PRIME_Q =
        21888242871839275222246405745257275088696311157297823662689037894645226208583;
    uint256 constant SNARK_SCALAR_FIELD =
        21888242871839275222246405745257275088548364400416034343698204186575808495617;

    function negateY(uint256 y) internal pure returns (uint256) {{
        if (y == 0) return 0;
        return PRIME_Q - (y % PRIME_Q);
    }}

    function ecAdd(uint256[4] memory input_)
        internal view returns (uint256[2] memory r)
    {{
        bool ok;
        assembly {{
            ok := staticcall(sub(gas, 2000), 6, input_, 0x80, r, 0x40)
        }}
        require(ok, "ec-add-failed");
    }}

    function ecMul(uint256[3] memory input_)
        internal view returns (uint256[2] memory r)
    {{
        bool ok;
        assembly {{
            ok := staticcall(sub(gas, 2000), 7, input_, 0x60, r, 0x40)
        }}
        require(ok, "ec-mul-failed");
    }}

    // 4-pair product: e(a1,a2) e(b1,b2) e(c1,c2) e(d1,d2) == 1
    function pairing4(uint256[24] memory input_)
        internal view returns (bool)
    {{
        uint256[1] memory out;
        bool ok;
        assembly {{
            ok := staticcall(sub(gas, 2000), 8, input_, 0x300, out, 0x20)
        }}
        require(ok, "pairing-failed");
        return out[0] != 0;
    }}

    function verifyProof(
        uint256[2] memory a,
        uint256[2][2] memory b,
        uint256[2] memory c,
        uint256[{n_inputs}] memory input
    ) public view returns (bool) {{
        // vk_x = IC_0 + sum input_i * IC_{{i+1}}
        uint256[2] memory vkX = [uint256({ic0_x}), uint256({ic0_y})];
        uint256[2] memory t;
{ic_terms}
        // e(-A, B) * e(alpha, beta) * e(vkX, gamma) * e(C, delta) == 1
        return pairing4([
            a[0], negateY(a[1]), b[0][0], b[0][1], b[1][0], b[1][1],
            uint256({alpha_x}), uint256({alpha_y}),
            uint256({beta_x1}), uint256({beta_x0}),
            uint256({beta_y1}), uint256({beta_y0}),
            vkX[0], vkX[1],
            uint256({gamma_x1}), uint256({gamma_x0}),
            uint256({gamma_y1}), uint256({gamma_y0}),
            c[0], c[1],
            uint256({delta_x1}), uint256({delta_x0}),
            uint256({delta_y1}), uint256({delta_y0})
        ]);
    }}
}}
"""


def _ic_terms(ic: List, indent: str = "        ") -> str:
    lines = []
    for i, pt in enumerate(ic[1:]):
        x, y = pt
        lines.append(
            f"{indent}require(input[{i}] < SNARK_SCALAR_FIELD, "
            f"\"input-gte-snark-scalar-field\");")
        lines.append(
            f"{indent}t = ecMul([uint256({x}), uint256({y}), "
            f"input[{i}]]);")
        lines.append(
            f"{indent}vkX = ecAdd([vkX[0], vkX[1], t[0], t[1]]);")
    return "\n".join(lines)


def generate_verifier(vk: VerifyingKey, name: str = "TxVerifier") -> str:
    """VerifyingKey -> Solidity source with the embedded key."""
    n_inputs = len(vk.ic) - 1
    ax, ay = vk.alpha1
    (bx0, bx1), (by0, by1) = vk.beta2
    (gx0, gx1), (gy0, gy1) = vk.gamma2
    (dx0, dx1), (dy0, dy1) = vk.delta2
    ic0x, ic0y = vk.ic[0]
    return _TEMPLATE.format(
        name=name, n_inputs=n_inputs,
        ic0_x=ic0x, ic0_y=ic0y, ic_terms=_ic_terms(vk.ic),
        alpha_x=ax, alpha_y=ay,
        beta_x0=bx0, beta_x1=bx1, beta_y0=by0, beta_y1=by1,
        gamma_x0=gx0, gamma_x1=gx1, gamma_y0=gy0, gamma_y1=gy1,
        delta_x0=dx0, delta_x1=dx1, delta_y0=dy0, delta_y1=dy1,
    )
