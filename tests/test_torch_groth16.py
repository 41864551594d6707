"""zkrollup_torch Groth16 against zkrollup.groth16 (JAX) and the native
engine: setup from one seed gives the same key, key files load across the
two packages, the COO matrices and the quotient agree, and proofs at pinned
(r, s) equal zkrollup's host-engine proofs byte for byte and verify.

The port proves here on the CPU (plain PyTorch versions of its kernels);
the BatchProcessTx(2, 6) proof on the card is in test_torch_cuda.py.
"""

import dataclasses
import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from zkrollup.groth16 import keys as jkeys
from zkrollup.groth16 import prove as jprove, setup as jsetup, verify as jverify
from zkrollup.groth16.qap import to_coo as jto_coo
from zkrollup.native import engine
from zkrollup.r1cs.builder import Builder
from zkrollup.r1cs.circuits import synthesize_withdraw
from zkrollup.ref import eddsa
from zkrollup.ref.bn254 import R as FR_MOD
from zkrollup_torch.fields import limbs as L
from zkrollup_torch.fields.mont import FR
from zkrollup_torch.groth16 import prove as P, verify as V
from zkrollup_torch.groth16.keys import Proof, ProvingKey
from zkrollup_torch.groth16.qap import to_coo
from zkrollup_torch.groth16.setup import setup_host

# One intra-op thread per process: the suite runs in several worker
# processes, whose torch thread pools would otherwise fight for the cores.
torch.set_num_threads(1)

# the module (zkrollup.groth16 re-exports its function under the same name)
jprove_mod = importlib.import_module("zkrollup.groth16.prove")

SEED = b"zkrollup-test-seed"
PRIV = 41516261718191101
NULLIFIER = 31337


def cubic_builder(x=3, y=5, check=True):
    """out = x^3 + y with private x, public y."""
    bld = Builder(check=check)
    out = bld.alloc_output_deferred()
    ypub = bld.alloc_public_input(y)
    xv = bld.alloc(x)
    x3 = bld.mul(bld.mul(xv, xv), xv)
    bld.bind_output(out, x3 + ypub)
    return bld


def _withdraw_r1cs():
    return synthesize_withdraw(0, 0, check=False).r1cs


@pytest.fixture(scope="module")
def keys():
    """circuit -> (r1cs, port key, zkrollup key), same seed. The port's
    key comes from its native-engine setup; its device setup is held
    against both in test_torch_setup.py."""
    out = {}
    for name, r1cs in (("cubic", cubic_builder().r1cs()),
                       ("withdraw", _withdraw_r1cs())):
        out[name] = (r1cs, setup_host(r1cs, seed=SEED),
                     jsetup(r1cs, seed=SEED))
    return out


def _same_key(a, b):
    for f in dataclasses.fields(jkeys.ProvingKey):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if f.name == "vk":
            assert dataclasses.astuple(x) == dataclasses.astuple(y)
        elif f.name.endswith(("_g1", "_g2")):
            fx = [np.asarray(v) for v in _leaves(x)]
            fy = [np.asarray(v) for v in _leaves(y)]
            assert all(np.array_equal(u, v) for u, v in zip(fx, fy)), f.name
        else:
            assert x == y, f.name


def _leaves(t):
    return [v for c in t for v in (c if isinstance(c, tuple) else (c,))]


def _abc(proof):
    return (proof.a, proof.b, proof.c)


@pytest.mark.parametrize("name", ["cubic", "withdraw"])
def test_setup_matches_reference(keys, name):
    _, pk, jpk = keys[name]
    _same_key(pk, jpk)


def test_key_files_load_across_packages(keys, tmp_path):
    _, pk, jpk = keys["cubic"]
    jpk.save(str(tmp_path / "from_jax.npz"))
    _same_key(ProvingKey.load(str(tmp_path / "from_jax.npz")), jpk)
    pk.save(str(tmp_path / "from_torch.npz"))
    _same_key(jkeys.ProvingKey.load(str(tmp_path / "from_torch.npz")), pk)


@pytest.mark.parametrize("name", ["cubic", "withdraw"])
def test_to_coo_matches_reference(keys, name):
    r1cs = keys[name][0]
    got, want = to_coo(r1cs), jto_coo(r1cs)
    for f in dataclasses.fields(want):
        x, y = getattr(got, f.name), getattr(want, f.name)
        if isinstance(y, np.ndarray):
            assert np.array_equal(x, y), f.name
        else:
            assert x == y, f.name


def _h_port(r1cs, witness):
    coo = to_coo(r1cs)
    w_mont = FR.to_mont(L.to_device(L.ints_to_limbs(witness), "cpu"))
    evals = P._abc_evals(P._coo_on(coo, "cpu"), w_mont, coo.m)
    z = (pow(P.COSET_SHIFT, coo.m, FR_MOD) - 1) % FR_MOD
    zinv = FR.const_mont(pow(z, FR_MOD - 2, FR_MOD), "cpu")
    return evals, P._quotient_plain(*evals, zinv), coo


def test_quotient_matches_jax():
    bld = cubic_builder()
    (a_e, b_e, c_e), h, coo = _h_port(bld.r1cs(), bld.witness())
    jcoo = jto_coo(bld.r1cs())
    coo_dev = tuple(tuple(jnp.asarray(a) for a in t) for t in (
        (jcoo.a_row, jcoo.a_var, jcoo.a_coeff),
        (jcoo.b_row, jcoo.b_var, jcoo.b_coeff),
        (jcoo.c_row, jcoo.c_var, jcoo.c_coeff)))
    w_mont = jnp.asarray(FR.to_mont_host(bld.witness()))
    jevals = jprove_mod._abc_evals(coo_dev, w_mont, jcoo.m)
    for got, want in zip((a_e, b_e, c_e), jevals):
        assert np.array_equal(got.numpy().astype(np.uint32), np.asarray(want))
    z = (pow(jprove_mod.COSET_SHIFT, jcoo.m, FR_MOD) - 1) % FR_MOD
    from zkrollup.fields.mont import FR as JFR
    jh = jprove_mod._quotient_plain(*jevals, JFR.const_mont(
        pow(z, FR_MOD - 2, FR_MOD)))
    assert np.array_equal(h.numpy().astype(np.uint32), np.asarray(jh))


def test_quotient_matches_native_engine(keys):
    r1cs = keys["withdraw"][0]
    res = synthesize_withdraw(eddsa.format_priv_key_for_babyjub(PRIV),
                              NULLIFIER)
    _, h, coo = _h_port(r1cs, res.witness)
    raw = engine.groth16_quotient(coo, engine.ints_to_fr_bytes(res.witness),
                                  r1cs.n_vars, coo.m)
    want = [int.from_bytes(raw[32 * i:32 * (i + 1)], "little")
            for i in range(coo.m - 1)]
    assert L.limbs_to_ints(h[:coo.m - 1]) == want


@pytest.fixture(scope="module")
def cubic_proof(keys):
    r1cs, pk, _ = keys["cubic"]
    bld = cubic_builder()
    return P.prove(pk, r1cs, bld.witness(), r=7, s=9, device="cpu", c=8), \
        bld.public_signals()


def test_cubic_proof_equals_host_engine_and_verifies(keys, cubic_proof):
    r1cs, pk, jpk = keys["cubic"]
    proof, pub = cubic_proof
    bld = cubic_builder()
    want = jprove(jpk, r1cs, bld.witness(), r=7, s=9, backend="host")
    assert _abc(proof) == _abc(want)
    assert _abc(P.prove_host(pk, r1cs, bld.witness(), r=7, s=9)) == \
        _abc(want)
    assert V.verify(pk.vk, proof, pub)
    assert jverify(jpk.vk, jkeys.Proof(*_abc(proof)), pub)


def test_proof_does_not_depend_on_window(keys, cubic_proof):
    r1cs, pk, _ = keys["cubic"]
    bld = cubic_builder()
    other = P.prove(pk, r1cs, bld.witness(), r=7, s=9, device="cpu", c=3)
    assert _abc(other) == _abc(cubic_proof[0])


def test_verify_rejects_tampering_on_both_verifiers(keys, cubic_proof):
    _, pk, _ = keys["cubic"]
    proof, pub = cubic_proof
    bad_pub = [(pub[0] + 1) % FR_MOD] + list(pub[1:])
    bad_c = Proof(a=proof.a, b=proof.b, c=pk.alpha1)
    for check in (V.verify, V._verify_py):
        assert check(pk.vk, proof, pub)
        assert not check(pk.vk, proof, bad_pub)
        assert not check(pk.vk, bad_c, pub)


def test_wrong_witness_gives_an_invalid_proof(keys):
    r1cs, pk, _ = keys["cubic"]
    bld = cubic_builder()
    w = bld.witness()
    w[-1] = (w[-1] + 1) % FR_MOD
    proof = P.prove(pk, r1cs, w, r=7, s=9, device="cpu", c=8)
    assert not V.verify(pk.vk, proof, bld.public_signals())


def test_withdraw_proof_equals_host_engine_and_verifies(keys):
    r1cs, pk, jpk = keys["withdraw"]
    res = synthesize_withdraw(eddsa.format_priv_key_for_babyjub(PRIV),
                              NULLIFIER)
    proof = P.prove(pk, res.r1cs, res.witness, r=3, s=4, device="cpu", c=8)
    want = jprove(jpk, res.r1cs, res.witness, r=3, s=4, backend="host")
    assert _abc(proof) == _abc(want)
    assert V.verify(pk.vk, proof, res.public_signals)
