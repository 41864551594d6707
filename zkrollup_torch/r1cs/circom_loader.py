"""Loader for circom 0.0.35 compiled-circuit JSON.

The reference compiles its circuits to JSON with the circom JS compiler
(`circom circuits/tx.circom -o build/tx.json`,
simple-zk-rollups/prover/package.json:34-39) and feeds that to snarkjs setup /
witness calculation. This loader ingests the constraint system from such a
file into this framework's R1CS container, enabling Groth16 setup + proving
with a FOREIGN (circom-compiled) circuit: witnesses must then follow circom's
signal ordering (var 0 = ONE, then outputs, then public inputs, then private
inputs/internals — the same convention r1cs/builder.py uses).

Schema consumed (the subset snarkjs 0.1.20's Circuit class reads):
  nVars / nSignals, nOutputs, nPubInputs, constraints: [[A, B, C], ...]
  where each of A/B/C maps signal-index strings to coefficient strings.
"""

from __future__ import annotations

import json
from typing import Dict, List

from ..ref.bn254 import R as FR_MOD
from .builder import R1CS


def _lc_from_json(lc: Dict) -> Dict[int, int]:
    out = {}
    for k, v in (lc or {}).items():
        coeff = int(v) % FR_MOD
        if coeff:
            out[int(k)] = coeff
    return out


def load_circom_dict(obj: Dict) -> R1CS:
    """Compiled-circuit dict -> R1CS."""
    n_vars = int(obj.get("nVars", obj.get("nSignals")))
    n_outputs = int(obj.get("nOutputs", 0))
    n_pub_inputs = int(obj.get("nPubInputs", 0))
    constraints = [
        (_lc_from_json(a), _lc_from_json(b), _lc_from_json(c))
        for a, b, c in obj["constraints"]
    ]
    return R1CS(n_vars=n_vars, n_outputs=n_outputs,
                n_public_inputs=n_pub_inputs, constraints=constraints)


def load_circom_json(path: str) -> R1CS:
    with open(path) as f:
        return load_circom_dict(json.load(f))


def r1cs_to_circom_dict(r1cs: R1CS) -> Dict:
    """Inverse: export an R1CS in the circom-JSON constraint schema (for
    round-trip tests and external tooling)."""
    return {
        "nVars": r1cs.n_vars,
        "nOutputs": r1cs.n_outputs,
        "nPubInputs": r1cs.n_public_inputs,
        "nPrvInputs": 0,
        "constraints": [
            [{str(k): str(v) for k, v in a.items()},
             {str(k): str(v) for k, v in b.items()},
             {str(k): str(v) for k, v in c.items()}]
            for a, b, c in r1cs.constraints
        ],
    }
