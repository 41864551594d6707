"""The witness encoding of zkrollup_torch's prover, on the CPU, against
zkrollup's (JAX) expression for it, zkrollup/groth16/prove.py's
ints_to_limbs([w % r for w in witness]) with zkrollup.fields.limbs's
ints_to_limbs.

- fields/limbs.py encode_fr (the native pass of native/limbs.c, and the
  port's Python expression for the entries it leaves) gives that
  expression's rows as int32, bit for bit, or raises as it raises: field elements, the edges around r and 2^256,
  negative values, bools, numpy integers, a subclass of int, a tuple, an
  empty list and a BatchProcessTx(2, 6) witness; ENCODED counts exactly
  the entries that took the Python path, which run under one span
  groth16.encode.fallback (no profiler label), absent where none did;
- with the library's loader failing, every entry takes the Python path
  and gives the same rows; a library that does not build warns with the
  compiler's error; a buffer written twice holds the second witness's
  rows alone;
- prove() on the CPU, whose encoding this is, gives prove_host's proof
  and zkrollup's host-engine proof on the same witness and (r, s), as a
  list, a tuple and with entries not reduced mod r.
"""

import functools
import random

import numpy as np
import pytest
import torch

from zkrollup.fields.limbs import ints_to_limbs as ref_ints_to_limbs
from zkrollup.groth16 import prove as jprove, setup as jsetup
from zkrollup_torch import spans
from zkrollup_torch.config import RollupConfig
from zkrollup_torch.fields import limbs as L
from zkrollup_torch.groth16.prove import prove, prove_host
from zkrollup_torch.groth16.setup import setup_host
from zkrollup_torch.native import limbs as native_limbs
from zkrollup_torch.r1cs.builder import Builder
from zkrollup_torch.ref import eddsa
from zkrollup_torch.ref.bn254 import R
from zkrollup_torch.tree.merkle import create_merkle_tree
from zkrollup_torch.witness.assembler import (Transaction, format_tx,
                                              hash_balance_tree_leaf)
from zkrollup_torch.witness.batch import prepare_fields

torch.set_num_threads(1)

FALLBACK = "groth16.encode.fallback"


class Sub(int):
    """A subclass of int whose % is its own."""

    def __mod__(self, m):
        return Sub(int(self) * 3 % m)


def _random(n, seed=1):
    rng = random.Random(seed)
    return [rng.randrange(R) for _ in range(n)]


@functools.lru_cache(maxsize=None)
def _witness_2_6():
    """A BatchProcessTx(2, 6) witness: two funded accounts, two signed
    transfers, witness-only synthesis."""
    cfg = RollupConfig(batch_size=2, tree_depth=6)
    privs = (31415926535, 27182818284)
    tree = create_merkle_tree(cfg.tree_depth)
    for priv in privs:
        leaf = {"publicKey": list(eddsa.gen_public_key(priv)),
                "balance": 10 ** 18, "nonce": 0}
        tree.insert_(hash_balance_tree_leaf(leaf), leaf)
    txs = []
    for i, (frm, to) in enumerate(((0, 1), (1, 0)), start=1):
        tx = Transaction(frm, to, 10 ** 16 * i, 10 ** 15, 1)
        tx.signature = eddsa.sign(privs[frm], format_tx(tx))
        txs.append(tx)
    return tuple(prepare_fields(cfg, tree, txs)["witness"])


CASES = {
    "random": lambda: _random(300),
    "edges": lambda: [0, 1, R - 1, R, R + 1, 1 << 254, (1 << 256) - 1,
                      1 << 256, 1 << 300, (1 << 30) - 1, 1 << 30,
                      (1 << 64) - 1, 1 << 64, 1 << 253],
    "negative": lambda: [-1, -R, -(R + 1), -(1 << 256), -(1 << 300), 7],
    "bools": lambda: [True, False, 2],
    "numpy-int": lambda: [3, np.int64(5), 4],
    "int-subclass": lambda: [Sub(5), 5, Sub(R + 2)],
    "tuple": lambda: tuple(_random(50, seed=2) + [R + 9]),
    "empty": lambda: [],
    "witness-2-6": lambda: list(_witness_2_6()),
}


def _old(ws):
    """zkrollup's expression, as the port's int32 rows."""
    return ref_ints_to_limbs([w % R for w in ws]).astype(np.int32)


def _slow(ws):
    """The entries the native pass leaves to Python."""
    return sum(1 for w in ws if not (type(w) is int and 0 <= w < R))


def _encode(ws):
    out = torch.full((len(ws), L.N_LIMBS), -7, dtype=L.DTYPE)
    with spans.trace() as t:
        L.encode_fr(ws, out)
    return out.numpy(), [s for s in t.spans() if s.name == FALLBACK]


@pytest.mark.parametrize("case", list(CASES))
def test_encode_fr_matches_the_python_expression(case):
    """Rows bit for bit as the old expression (or its exception); the
    counter counts the Python path's entries; one fallback span where
    there are any, none otherwise."""
    ws = CASES[case]()
    try:
        want = _old(ws)
    except Exception as e:
        with pytest.raises(type(e)):
            _encode(ws)
        return
    L.reset_encoded()
    rows, fallback = _encode(ws)
    assert rows.dtype == np.int32 and rows.shape == (len(ws), L.N_LIMBS)
    assert np.array_equal(rows, want)
    slow = _slow(ws)
    assert L.ENCODED == {"native": len(ws) - slow, "fallback": slow}
    assert len(fallback) == (1 if slow else 0)
    assert all(s.labels is False for s in fallback)
    if case in ("random", "witness-2-6"):
        assert slow == 0          # a canonical witness never leaves C


def test_encode_fr_without_the_library(monkeypatch):
    """The loader failing: every entry takes the Python path, with the
    same rows, all counted as fallback, under one span."""
    monkeypatch.setattr(native_limbs, "_load", lambda: None)
    ws = CASES["edges"]() + _random(40) + [True, -3]
    L.reset_encoded()
    rows, fallback = _encode(ws)
    assert np.array_equal(rows, _old(ws))
    assert L.ENCODED == {"native": 0, "fallback": len(ws)}
    assert len(fallback) == 1


def test_library_that_does_not_build_warns(tmp_path, monkeypatch):
    """A source the compiler refuses: no library, one RuntimeWarning that
    carries the compiler's error, and no file left behind."""
    src = tmp_path / "limbs.c"
    src.write_text("this is not C\n")
    monkeypatch.setattr(native_limbs, "_SRC", str(src))
    monkeypatch.setattr(native_limbs, "_LIB_PATH", str(tmp_path / "l.so"))
    with pytest.warns(RuntimeWarning, match="error"):
        assert native_limbs._open() is None
    assert [p.name for p in tmp_path.iterdir()] == ["limbs.c"]


def test_encode_fr_rewrites_every_row():
    """One buffer encoded twice, the second witness with slow entries where
    the first had none: the second witness's rows alone."""
    first, second = _random(64, seed=3), _random(64, seed=4)
    second[::5] = [w + R for w in second[::5]]
    out = torch.empty((64, L.N_LIMBS), dtype=L.DTYPE)
    for ws in (first, second):
        L.encode_fr(ws, out)
        assert np.array_equal(out.numpy(), _old(ws))


@pytest.mark.parametrize("out", [
    np.zeros((3, 16), np.int64), np.zeros((3, 15), np.int32),
    np.zeros((4, 16), np.int32), np.zeros((16, 3), np.int32).T])
def test_fr_rows_rejects_bad_buffers(out):
    with pytest.raises(ValueError):
        native_limbs.fr_rows([1, 2, 3], out)


def _cubic():
    """out = x^3 + y with private x, public y."""
    bld = Builder(check=True)
    out = bld.alloc_output_deferred()
    ypub = bld.alloc_public_input(R - 5)
    xv = bld.alloc(123456789123456789)
    x3 = bld.mul(bld.mul(xv, xv), xv)
    bld.bind_output(out, x3 + ypub)
    return bld


@pytest.fixture(scope="module")
def cubic_key():
    bld = _cubic()
    r1cs = bld.r1cs()
    seed = b"zkrollup-test-seed"
    return (r1cs, setup_host(r1cs, seed=seed), jsetup(r1cs, seed=seed),
            bld.witness())


@pytest.mark.parametrize("form", ["list", "tuple", "unreduced"])
def test_prove_on_cpu_equals_prove_host(cubic_key, form):
    """prove() on the CPU gives prove_host's proof and zkrollup's
    host-engine proof on the same witness and (r, s); a witness with
    entries r above their values takes the fallback for those entries and
    still gives it."""
    r1cs, pk, jpk, w = cubic_key
    if form == "tuple":
        w = tuple(w)
    elif form == "unreduced":
        w = [v + R if i % 2 else v for i, v in enumerate(w)]
    L.reset_encoded()
    with spans.trace() as t:
        got = prove(pk, r1cs, w, r=11, s=13, device="cpu", c=8)
    want = prove_host(pk, r1cs, list(w), r=11, s=13)
    assert (got.a, got.b, got.c) == (want.a, want.b, want.c)
    ref = jprove(jpk, r1cs, list(w), r=11, s=13, backend="host")
    assert (got.a, got.b, got.c) == (ref.a, ref.b, ref.c)
    slow = _slow(w)
    assert L.ENCODED == {"native": len(w) - slow, "fallback": slow}
    assert (form == "unreduced") == (slow > 0)
    names = [s.name for s in t.spans()]
    assert names.count(FALLBACK) == (1 if slow else 0)
