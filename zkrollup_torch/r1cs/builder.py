"""R1CS constraint-system builder — the circom-compiler replacement.

The reference compiles circom source at proof time
(simple-zk-rollups/operator/src/snarks/common.ts:12-17, circom@0.0.35) to get
an R1CS + witness calculator. Here circuits are Python functions over a
builder; one pass yields BOTH the constraint system and the witness, so
witness generation is re-running synthesis with new inputs (the R1CS
structure is input-independent and asserted identical).

Conventions (Groth16-standard, same variable layout circom/snarkjs use):
  var 0            constant ONE
  vars 1..n_out    main outputs            (public)
  ..n_out+n_pub    main public inputs      (public)
  rest             private inputs + internal signals

Linear combinations are first-class: linear "assignments" cost no variables
or constraints (unlike circom, which materializes every <== — we are not a
port; only the PUBLIC signal layout must match the reference ABI, which is
preserved exactly: 73 signals for tx, 3 for withdraw — TxVerifier.sol:281,
WithdrawVerifier.sol:211).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ..ref.bn254 import R as P


class LC:
    """Sparse linear combination over witness variables (mod p)."""

    __slots__ = ("terms",)

    def __init__(self, terms: Optional[Dict[int, int]] = None):
        self.terms = terms or {}

    @staticmethod
    def const(c: int) -> "LC":
        c %= P
        return LC({0: c} if c else {})

    @staticmethod
    def var(idx: int, coeff: int = 1) -> "LC":
        coeff %= P
        return LC({idx: coeff} if coeff else {})

    def __add__(self, other):
        other = _as_lc(other)
        t = dict(self.terms)
        for k, v in other.terms.items():
            nv = (t.get(k, 0) + v) % P
            if nv:
                t[k] = nv
            else:
                t.pop(k, None)
        return LC(t)

    def __sub__(self, other):
        return self + _as_lc(other) * (P - 1)

    def __mul__(self, scalar: int):
        scalar %= P
        if scalar == 0:
            return LC()
        return LC({k: (v * scalar) % P for k, v in self.terms.items()})

    __rmul__ = __mul__
    __radd__ = __add__

    def __rsub__(self, other):
        return _as_lc(other) - self

    def is_const(self) -> bool:
        return all(k == 0 for k in self.terms)

    def const_value(self) -> int:
        return self.terms.get(0, 0)


def _as_lc(x) -> LC:
    if isinstance(x, LC):
        return x
    if isinstance(x, int):
        return LC.const(x)
    raise TypeError(f"cannot coerce {type(x)} to LC")


@dataclass
class R1CS:
    """Finalized constraint system: rows of sparse (A, B, C) maps."""
    n_vars: int
    n_outputs: int
    n_public_inputs: int
    constraints: List[Tuple[Dict[int, int], Dict[int, int], Dict[int, int]]]

    @property
    def n_public(self) -> int:
        """Public section size incl. the ONE wire: 1 + outputs + pub inputs."""
        return 1 + self.n_outputs + self.n_public_inputs

    @property
    def n_constraints(self) -> int:
        return len(self.constraints)


class _NullConstraintSink:
    """list stand-in for witness-only synthesis: counts appends,
    stores nothing."""

    __slots__ = ("n",)

    def __init__(self):
        self.n = 0

    def append(self, _row) -> None:
        self.n += 1

    def __len__(self) -> int:
        return self.n


class Builder:
    """Synthesis context: allocates variables, records constraints, and
    (when values are supplied) computes the witness alongside."""

    def __init__(self, check: bool = True, record: bool = True):
        """record=False skips constraint recording: the WITNESS-ONLY
        replay mode (circuits are static, so the R1CS from one structure
        synthesis serves every proof — the witness calculator just needs
        identical allocation order). self.constraints then behaves as a
        sink that counts rows (cheap) so gadget row-index math stays
        valid."""
        self.values: List[int] = [1]          # var 0 = ONE
        self.constraints = [] if record else _NullConstraintSink()
        self.n_outputs = 0
        self.n_public_inputs = 0
        self._io_frozen = False
        self.check = check
        self.record = record

    # -- variable allocation ----------------------------------------------

    def alloc(self, value: int) -> LC:
        """Private/internal variable with concrete value."""
        self._io_frozen = True
        idx = len(self.values)
        self.values.append(value % P)
        return LC.var(idx)

    def alloc_output(self, value: int) -> LC:
        assert not self._io_frozen, "outputs must be allocated before internals"
        assert self.n_public_inputs == 0, "outputs must precede public inputs"
        idx = len(self.values)
        self.values.append(value % P)
        self.n_outputs += 1
        return LC.var(idx)

    def alloc_output_deferred(self) -> LC:
        """Output whose value is computed later in synthesis (e.g. the new
        tree root); bind with bind_output() before finalizing."""
        assert not self._io_frozen and self.n_public_inputs == 0
        idx = len(self.values)
        self.values.append(None)  # type: ignore[arg-type]
        self.n_outputs += 1
        return LC.var(idx)

    def bind_output(self, out_lc: LC, computed) -> None:
        """Set the deferred output's value from a computed LC and constrain
        them equal."""
        (idx, coeff), = out_lc.terms.items()
        assert coeff == 1 and self.values[idx] is None
        self.values[idx] = self.value(computed)
        self.enforce_equal(out_lc, computed)

    def alloc_public_input(self, value: int) -> LC:
        assert not self._io_frozen, "public inputs precede internals"
        idx = len(self.values)
        self.values.append(value % P)
        self.n_public_inputs += 1
        return LC.var(idx)

    # -- evaluation --------------------------------------------------------

    def value(self, lc) -> int:
        lc = _as_lc(lc)
        terms = lc.terms
        if len(terms) == 1:  # single-term LCs dominate the replay
            (k, c), = terms.items()
            return c * self.values[k] % P
        vals = self.values
        acc = 0
        for k, c in terms.items():
            acc += c * vals[k]
        return acc % P

    # -- constraints -------------------------------------------------------

    def enforce(self, a, b, c) -> None:
        """a * b = c (each an LC or int)."""
        a, b, c = _as_lc(a), _as_lc(b), _as_lc(c)
        if self.check:
            va, vb, vc = self.value(a), self.value(b), self.value(c)
            if va * vb % P != vc:
                raise AssertionError(
                    f"unsatisfied constraint #{len(self.constraints)}: "
                    f"{va} * {vb} != {vc}")
        if self.record:
            self.constraints.append(
                (dict(a.terms), dict(b.terms), dict(c.terms)))
        else:  # witness-only replay: count the row, skip the dict copies
            self.constraints.append(None)

    def enforce_zero(self, lc) -> None:
        self.enforce(lc, LC.const(1), LC.const(0))

    def enforce_equal(self, a, b) -> None:
        self.enforce_zero(_as_lc(a) - _as_lc(b))

    # -- common ops (allocate product/inverse witnesses) --------------------

    def mul(self, a, b) -> LC:
        a, b = _as_lc(a), _as_lc(b)
        if a.is_const():
            return b * a.const_value()
        if b.is_const():
            return a * b.const_value()
        out = self.alloc(self.value(a) * self.value(b) % P)
        self.enforce(a, b, out)
        return out

    def square(self, a) -> LC:
        return self.mul(a, a)

    def inv(self, a) -> LC:
        """Multiplicative inverse witness; constrains a * inv = 1
        (so `a` must be nonzero for satisfiability)."""
        a = _as_lc(a)
        va = self.value(a)
        # pow(x, -1, p) is extgcd — ~50x faster than Fermat on 254 bits
        out = self.alloc(pow(va, -1, P) if va else 0)
        self.enforce(a, out, LC.const(1))
        return out

    def div(self, a, b) -> LC:
        """a / b with b != 0 enforced via witness inverse."""
        a, b = _as_lc(a), _as_lc(b)
        vb = self.value(b)
        out = self.alloc(self.value(a) * pow(vb, -1, P) % P if vb else 0)
        self.enforce(b, out, a)
        return out

    def materialize(self, lc, max_terms: int = 8) -> LC:
        """Rebind a long linear combination to a fresh variable (one linear
        constraint). Keeps R1CS rows sparse and synthesis-time evaluation
        O(1) in chained accumulators (e.g. the MiMC Feistel state, which
        otherwise grows one term per round)."""
        lc = _as_lc(lc)
        if len(lc.terms) <= max_terms:
            return lc
        v = self.alloc(self.value(lc))
        self.enforce_equal(v, lc)
        return v

    # -- finalize ----------------------------------------------------------

    def r1cs(self) -> R1CS:
        if not self.record:
            raise RuntimeError(
                "witness-only synthesis (record=False) has no R1CS; "
                "take it from a structure synthesis instead")
        return R1CS(n_vars=len(self.values), n_outputs=self.n_outputs,
                    n_public_inputs=self.n_public_inputs,
                    constraints=self.constraints)

    def witness(self) -> List[int]:
        return list(self.values)

    def public_signals(self) -> List[int]:
        """Outputs then public inputs, in allocation order (the on-chain
        `input[]` array layout)."""
        return self.values[1:1 + self.n_outputs + self.n_public_inputs]
