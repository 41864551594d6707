"""zkrollup_torch.hash.mimc and tree.bulk against zkrollup.hash.mimc_jax and
zkrollup.tree.bulk (JAX, on the CPU): the MiMCSponge permutation, the
sponge over 2 and 4 inputs, a Merkle level, a dense root, the bulk tree
rebuild, leaf-row hashing and the tree store's integrity check.

Inputs are made with numpy from a seed and handed to both packages; results
must be equal limb for limb, and equal to the port's pure-Python
ref.mimc. The port runs on CPU tensors, where multi_hash_mont takes the
plain version of the mimc_sponge[fr] kernel (the reference's loop over the
plain product and add; chip_smoke.py phase 10 runs the kernel on the
card).

A word-level model of csrc/mimc.cu's mimc_sponge_kernel (each input
absorbed with Fp::add, the 220 rounds of Fp::add and Fp::mul on 8 x 32-bit
words, the swap back after the last; test_torch_field_add.py's model of
field.cuh) is held against the reference's multi_hash_mont and ref.mimc on
a few lanes, and, in place of the launch, behind the port's wrapper: its
inputs, keys and round constants read at their addresses.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from zkrollup.fields.mont import FR as JFR
from zkrollup.hash import mimc_jax
from zkrollup.tree import bulk as jbulk
from zkrollup.tree.merkle import create_merkle_tree as jcreate
from zkrollup.tree.store import TreeStore as JTreeStore
import test_torch_field_add as words
from zkrollup_torch import kernels
from zkrollup_torch.fields import limbs as L
from zkrollup_torch.fields.mont import FR
from zkrollup_torch.hash import mimc
from zkrollup_torch.ref.mimc import mimcsponge_permute, multi_hash_py
from zkrollup_torch.tree import bulk
from zkrollup_torch.tree.merkle import create_merkle_tree
from zkrollup_torch.tree.store import TreeStore

# One intra-op thread per process: the suite runs in several worker
# processes, whose torch thread pools would otherwise fight for the cores.
torch.set_num_threads(1)

P = FR.p


def _ints(n: int, seed: int) -> list:
    """n random elements of Fr, with 0, 1 and p - 1 among the first."""
    rng = np.random.RandomState(seed)
    words = rng.randint(0, 1 << 32, size=(n, 8), dtype=np.uint64)
    vals = [sum(int(w) << (32 * i) for i, w in enumerate(row)) % P
            for row in words]
    return [0, 1, P - 1] + vals[3:]


def _both(vals, shape):
    """Montgomery limbs of vals for the port (a CPU tensor) and the
    reference (a jnp array), reshaped to shape + (16,)."""
    enc = FR.to_mont_host(vals)
    return (L.to_device(enc, "cpu").reshape(*shape, 16),
            jnp.asarray(enc).reshape(*shape, 16))


def _same(got: torch.Tensor, want) -> list:
    """The port's limbs equal the reference's; returns their ints."""
    np.testing.assert_array_equal(got.numpy().astype(np.uint32),
                                  np.asarray(want))
    return FR.from_mont_host(got)


def test_permute_mont_matches_jax():
    """One permutation of 32 lanes under a nonzero key per lane."""
    n = 32
    xl, xr, k = (_ints(n, s) for s in (1, 2, 3))
    (pl, jl), (pr, jr), (pk, jk) = (_both(v, (n,)) for v in (xl, xr, k))
    got = mimc.permute_mont(pl, pr, pk)
    want = mimc_jax.permute_mont(jl, jr, jk)
    out_l, out_r = _same(got[0], want[0]), _same(got[1], want[1])
    assert list(zip(out_l, out_r)) == [
        mimcsponge_permute(a, b, c) for a, b, c in zip(xl, xr, k)]


@pytest.mark.parametrize("n_in,key", [(2, 0), (4, 12345)])
def test_multi_hash_mont_matches_jax(n_in, key):
    """The sponge over rows of 2 and of 4 inputs (the 4-input one under a
    nonzero key), 32 rows."""
    n = 32
    vals = _ints(n * n_in, 4 + n_in)
    port, ref = _both(vals, (n, n_in))
    k = None
    jk = None
    if key:
        k, jk = _both([key] * n, (n,))
    got = mimc.multi_hash_mont(port, k)
    want = mimc_jax.multi_hash_mont(ref, jk)
    rows = [vals[i * n_in:(i + 1) * n_in] for i in range(n)]
    assert _same(got, want) == [multi_hash_py(r, key) for r in rows]


def test_merkle_level_up_matches_jax():
    """One level of 64 nodes (32 pairs), and hash_pairs_mont beside it."""
    vals = _ints(64, 9)
    port, ref = _both(vals, (64,))
    got = mimc.merkle_level_up(port)
    assert torch.equal(got, mimc.hash_pairs_mont(port.reshape(32, 2, 16)))
    want = _same(got, mimc_jax.merkle_level_up(ref))
    assert want == [multi_hash_py(vals[i:i + 2]) for i in range(0, 64, 2)]


def test_build_tree_root_mont_matches_jax():
    """The dense root over 4 leaves (depth 2)."""
    vals = _ints(4, 10)
    port, ref = _both(vals, (4,))
    got = mimc.build_tree_root_mont(port, 2)
    want = _same(got, mimc_jax.build_tree_root_mont(ref, 2))
    h = [multi_hash_py(vals[:2]), multi_hash_py(vals[2:])]
    assert want == [multi_hash_py(h)]


@pytest.mark.parametrize("n", [1, 2, 3, 5, 16, 31])
def test_from_leaves_equals_incremental(n):
    """tests/test_tree.py's cases at depth 6: the bulk rebuild equals the
    tree insert_ builds, caches included. At n = 31 the leaf level's 32
    nodes take the batched route (on CPU tensors)."""
    inc = create_merkle_tree(6)
    for i in range(n):
        inc.insert_(1000 + i, {"i": i})
    got = bulk.from_leaves([1000 + i for i in range(n)], 6,
                           leaves_raw=[{"i": i} for i in range(n)],
                           device="cpu")
    assert got.equals(inc)


def test_from_leaves_matches_reference():
    """40 leaves at depth 7 (the leaf level batched), against zkrollup's
    from_leaves on its device route: root and caches."""
    leaves = _ints(40, 11)
    got = bulk.from_leaves(leaves, 7, device="cpu")
    want = jbulk.from_leaves(leaves, 7)
    assert (got.root, got.zeros, got.filled_subtrees, got.filled_paths) == (
        want.root, want.zeros, want.filled_subtrees, want.filled_paths)
    assert got.equals(bulk.from_leaves(leaves, 7, use_device=False))


def test_multi_hash_rows_matches_reference():
    """20 four-wide rows (balance-tree leaf data, helpers.ts:80), batched,
    against zkrollup's multi_hash_rows and the host sponge."""
    rows = [[i, i * 31 + 5, i ** 3, 1] for i in range(20)]
    got = bulk.multi_hash_rows(rows, device="cpu")
    assert got == jbulk.multi_hash_rows(rows)
    assert got == [multi_hash_py(r) for r in rows]
    assert bulk.multi_hash_rows([]) == []


def test_tree_store_verify_integrity_matches_reference():
    """The same store in both packages (31 leaves at depth 6, the leaf
    level batched): verify_integrity on its default use_device=True (the
    port on CPU tensors) gives the reference's answer, True while the store
    is intact and False once a leaf hash is corrupted."""
    seen = []
    for create, Store, kw in ((create_merkle_tree, TreeStore,
                               {"device": "cpu"}),
                              (jcreate, JTreeStore, {})):
        tree = create(6)
        for i in range(31):
            tree.insert_(7 * i + 3, {"i": i})
        store = Store()
        store.save_all_leaves("balanceTree", tree)
        intact = store.verify_integrity("balanceTree", **kw)
        store.conn.execute("UPDATE leaves SET hash='12345' WHERE idx=3")
        store.conn.commit()
        seen.append((intact, store.verify_integrity("balanceTree", **kw)))
    assert seen == [(True, False), (True, False)]


def test_constants_mont_cached_per_device():
    """The round constants: the reference's host array, one tensor a
    device."""
    cts = mimc.constants_mont("cpu")
    assert cts is mimc.constants_mont(torch.device("cpu"))
    np.testing.assert_array_equal(cts.numpy().astype(np.uint32),
                                  mimc_jax.constants_mont())
    assert JFR.p == FR.p


# -- the kernel, modelled word by word ----------------------------------------

def sponge_model(rows: list, k: list, cts: list) -> list:
    """mimc_sponge_kernel on one lane: rows, the lane's inputs as 8-word
    values; k its key; cts the round constants. Montgomery form in and
    out."""
    p, inv = words.field_words(FR)
    xl = xr = [0] * 8
    for x in rows:
        xl = words.add_words(xl, x, p)
        for c in cts:
            t = words.add_words(words.add_words(xl, k, p), c, p)
            t2 = words.mul_words(t, t, p, inv)
            t4 = words.mul_words(t2, t2, p, inv)
            xl, xr = words.add_words(xr, words.mul_words(t4, t, p, inv),
                                     p), xl
        xl, xr = xr, xl                  # the swap back
    return xl


def _cts_words() -> list:
    return [words.load(row) for row in mimc.constants_mont("cpu").numpy()]


@pytest.mark.parametrize("n_in,keyed", [(2, False), (2, True), (4, False),
                                        (4, True)])
def test_sponge_model_matches_reference(n_in, keyed):
    """The model on 2 lanes of 2 and 4 inputs, key zero or random per
    lane: the reference's multi_hash_mont limbs and ref.mimc's ints."""
    n = 2
    vals = _ints(n * n_in, 40 + n_in)
    keys = _ints(n + 3, 50)[3:] if keyed else [0] * n
    port, ref = _both(vals, (n, n_in))
    want = np.asarray(mimc_jax.multi_hash_mont(
        ref, _both(keys, (n,))[1] if keyed else None))
    enc, kenc = port.numpy(), FR.to_mont_host(keys)
    cts = _cts_words()
    got = np.array([words.store(sponge_model(
        [words.load(x) for x in enc[i]], words.load(kenc[i]), cts))
        for i in range(n)])
    np.testing.assert_array_equal(got.astype(np.uint32), want)
    assert FR.from_mont_host(got) == [
        multi_hash_py(vals[i * n_in:(i + 1) * n_in], keys[i])
        for i in range(n)]


@pytest.mark.parametrize("key", ["none", "row", "lanes"])
def test_sponge_wrapper_launch_model_matches_plain(monkeypatch, key):
    """mimc.mimc_sponge's one launch with the kernel replaced by the model
    over CPU memory (lane i's n_in rows at in + i n_in rows, its key at
    row 0 or row i, or zero without one, the constants' 220 rows): equal
    to multi_hash_mont_plain on 2 lanes of strided inputs."""
    seen = []

    def launch(name, device, x, n_in, k, k_bcast, cts, out, n, lanes):
        rows = words.rows_at(x, n * n_in).reshape(n, n_in, 16)
        keys = (np.zeros((n, 16), np.int32) if not k else
                np.repeat(words.rows_at(k, 1), n, 0) if k_bcast else
                words.rows_at(k, n))
        cw = [words.load(c) for c in words.rows_at(cts, 220)]
        words.rows_at(out, n)[:] = [words.store(sponge_model(
            [words.load(r) for r in rows[i]], words.load(keys[i]), cw))
            for i in range(n)]
        seen.append((name, n_in, k_bcast, n, lanes))

    monkeypatch.setattr(kernels, "launch", launch)
    monkeypatch.setattr(kernels, "check_cuda", words.check_cuda_but_device)
    port, _ = _both(_ints(8, 60), (2, 4))
    x = port[:, ::2]                                  # (2, 2, 16), strided
    k = {"none": None, "row": _both([777], (1,))[0][0],
         "lanes": _both([5, 6], (2,))[0]}[key]
    got = mimc.mimc_sponge(x, k)
    assert torch.equal(got, mimc.multi_hash_mont_plain(x, k))
    assert seen == [("mimc_sponge[fr]", 2, int(key == "row"), 2, 2)]
