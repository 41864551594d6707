"""Parse a snarkjs-generated Groth16 verifier contract into a VerifyingKey.

The reference checks in TxVerifier.sol / WithdrawVerifier.sol with a
verifying key from a real snarkjs setup embedded as Solidity constants
(simple-zk-rollups/contracts/contracts/TxVerifier.sol:176-257, 74 IC points;
WithdrawVerifier.sol:176-186, 4 IC points). Those constants are the only
externally-generated BN254 data in this environment (zero egress), which
makes them the independent acceptance anchor this repo's own pairing/
verifier stack is tested against (tests/test_anchors.py):

  - every parsed G1/G2 point must lie on the curve / the twist and in the
    right subgroup under OUR arithmetic (ref/bn254.py + native/src),
  - the generators embedded in the contract's Pairing library must equal
    OUR G1_GEN/G2_GEN constants,
  - chain/genverifier.py must reproduce the parsed constants byte-for-byte
    when re-emitting a verifier from the parsed key.

Coordinate conventions: the Solidity Pairing library documents its Fq2
encoding as "X[0] * z + X[1]" (TxVerifier.sol:18), i.e. imaginary
component first. Our VerifyingKey stores ((re, im), (re, im)).
"""

from __future__ import annotations

import re
from typing import List, Tuple

from .keys import VerifyingKey

_G1_RE = r"Pairing\.G1Point\(\s*(\d+)\s*,\s*(\d+)\s*\)"
_G2_RE = (r"Pairing\.G2Point\(\s*\[\s*(\d+)\s*,\s*(\d+)\s*\]\s*,"
          r"\s*\[\s*(\d+)\s*,\s*(\d+)\s*\]\s*\)")


def _g1(src: str, name: str) -> Tuple[int, int]:
    m = re.search(rf"vk\.{name}\s*=\s*{_G1_RE}", src)
    if m is None:
        raise ValueError(f"no G1 assignment for vk.{name}")
    return (int(m.group(1)), int(m.group(2)))


def _g2(src: str, name: str) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    m = re.search(rf"vk\.{name}\s*=\s*{_G2_RE}", src)
    if m is None:
        raise ValueError(f"no G2 assignment for vk.{name}")
    x_im, x_re, y_im, y_re = (int(m.group(i)) for i in range(1, 5))
    return ((x_re, x_im), (y_re, y_im))


def parse_verifier_source(src: str) -> VerifyingKey:
    """snarkjs 0.1.20 `generateverifier` output -> VerifyingKey (plain-int
    coordinates, our (re, im) Fq2 ordering)."""
    alfa1 = _g1(src, "alfa1")
    beta2 = _g2(src, "beta2")
    gamma2 = _g2(src, "gamma2")
    delta2 = _g2(src, "delta2")

    m = re.search(r"vk\.IC\s*=\s*new Pairing\.G1Point\[\]\((\d+)\)", src)
    if m is None:
        raise ValueError("no IC array declaration")
    n_ic = int(m.group(1))
    ic: List[Tuple[int, int]] = [(0, 0)] * n_ic
    seen = 0
    for mm in re.finditer(rf"vk\.IC\[(\d+)\]\s*=\s*{_G1_RE}", src):
        i = int(mm.group(1))
        if not 0 <= i < n_ic:
            raise ValueError(f"IC index {i} out of range {n_ic}")
        ic[i] = (int(mm.group(2)), int(mm.group(3)))
        seen += 1
    if seen != n_ic:
        raise ValueError(f"expected {n_ic} IC points, found {seen}")
    return VerifyingKey(alpha1=alfa1, beta2=beta2, gamma2=gamma2,
                        delta2=delta2, ic=ic)


def parse_verifier_file(path: str) -> VerifyingKey:
    with open(path) as f:
        return parse_verifier_source(f.read())


def parse_pairing_generators(src: str):
    """Extract the G1/G2 generators embedded in the contract's Pairing
    library (P1()/P2(), TxVerifier.sol:24-35) — external constants our
    ref/bn254.py generators are checked against. Returns (g1, g2) with g2
    in our ((re, im), (re, im)) ordering."""
    m1 = re.search(r"function P1\(\).*?return G1Point\(\s*(\d+)\s*,\s*(\d+)\s*\)",
                   src, re.S)
    # first (uncommented) G2Point literal inside P2(); the commented
    # "Changed by Jordi" alternative swaps component order
    m2 = re.search(
        r"function P2\(\).*?return G2Point\(\s*\[\s*(\d+)\s*,\s*(\d+)\s*\]\s*,"
        r"\s*\[\s*(\d+)\s*,\s*(\d+)\s*\]", src, re.S)
    if m1 is None or m2 is None:
        raise ValueError("no Pairing library generators found")
    g1 = (int(m1.group(1)), int(m1.group(2)))
    x_im, x_re, y_im, y_re = (int(m2.group(i)) for i in range(1, 5))
    return g1, ((x_re, x_im), (y_re, y_im))
