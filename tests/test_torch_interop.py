"""zkrollup_torch's key, proof and circuit formats against zkrollup's, on
the CPU.

groth16/interop.py (snarkjs JSON, websnark binary) is the reference's module
over the port's own codecs: on one key both give the same dicts and bytes,
and a key round-tripped through either format proves the same bytes.
groth16/solvk.py, r1cs/circom_loader.py and ref/cipher.py are copies
(also held by test_torch_copies.py); here they meet the repository's
fixtures.
"""

import dataclasses
import json
import os

import pytest
import torch

import test_interop as ref_interop
from zkrollup.chain.genverifier import generate_verifier as jgen
from zkrollup.groth16 import interop as jio
from zkrollup.groth16 import solvk as jsolvk
from zkrollup.r1cs import circom_loader as jcircom
from zkrollup.r1cs.builder import Builder as JBuilder
from zkrollup.ref import cipher as jcipher
from zkrollup_torch.chain.genverifier import generate_verifier
from zkrollup_torch.groth16 import interop as io, solvk
from zkrollup_torch.groth16 import prove as P
from zkrollup_torch.groth16.keys import VerifyingKey
from zkrollup_torch.groth16.setup import setup_host
from zkrollup_torch.groth16.verify import verify
from zkrollup_torch.r1cs import circom_loader
from zkrollup_torch.r1cs.builder import Builder
from zkrollup_torch.ref import bn254 as ref, cipher, eddsa
from zkrollup_torch.ref.bn254 import R as FR_MOD

# One intra-op thread per process: the suite runs in several worker
# processes, whose torch thread pools would otherwise fight for the cores.
torch.set_num_threads(1)

SEED = b"interop-test-seed"
RS = (5, 6)
FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")


def cubic(builder, x=3, y=5):
    bld = builder()
    out = bld.alloc_output_deferred()
    ypub = bld.alloc_public_input(y)
    xv = bld.alloc(x)
    bld.bind_output(out, bld.mul(bld.mul(xv, xv), xv) + ypub)
    return bld


def _abc(proof):
    return (proof.a, proof.b, proof.c)


@pytest.fixture(scope="module")
def keyed():
    """(port builder, reference builder, port key, the device proof at RS
    on the CPU)."""
    bld, jbld = cubic(Builder), cubic(JBuilder)
    pk = setup_host(bld.r1cs(), seed=SEED)
    proof = P.prove(pk, bld.r1cs(), bld.witness(), *RS, device="cpu", c=8)
    assert verify(pk.vk, proof, bld.public_signals())
    return bld, jbld, pk, proof


def test_snarkjs_key_and_proof_match_reference(keyed):
    bld, jbld, pk, proof = keyed
    pkj = io.proving_key_to_snarkjs(pk, bld.r1cs())
    assert pkj == jio.proving_key_to_snarkjs(pk, jbld.r1cs())
    assert io.verifying_key_to_snarkjs(pk.vk) == \
        jio.verifying_key_to_snarkjs(pk.vk)
    assert io.proof_to_snarkjs(proof) == jio.proof_to_snarkjs(proof)
    assert _abc(io.proof_from_snarkjs(io.proof_to_snarkjs(proof))) == \
        _abc(proof)
    vk = io.verifying_key_from_snarkjs(io.verifying_key_to_snarkjs(pk.vk))
    assert vk == pk.vk


@pytest.mark.parametrize("fmt", ["snarkjs", "websnark"])
def test_key_round_trip_proves_the_same_bytes(keyed, fmt):
    """The key through snarkjs JSON (as text) or the websnark binary and
    back, then proved on the CPU at the same (r, s)."""
    bld, jbld, pk, proof = keyed
    pkj = json.loads(json.dumps(io.proving_key_to_snarkjs(pk, bld.r1cs())))
    if fmt == "websnark":
        raw = io.binarify_proving_key(pkj)
        assert raw == jio.binarify_proving_key(pkj)
        parsed = io.parse_websnark_proving_key(raw)
        assert parsed == jio.parse_websnark_proving_key(raw)
        pkj = io.stringify_bigints(parsed)
    pk2 = io.proving_key_from_snarkjs(pkj, vk=pk.vk)
    got = P.prove(pk2, bld.r1cs(), bld.witness(), *RS, device="cpu", c=8)
    assert _abc(got) == _abc(proof)


def test_websnark_witness_matches_reference(keyed):
    w = keyed[0].witness()
    raw = io.binarify_witness(w)
    assert raw == jio.binarify_witness(w)
    assert io.parse_websnark_witness(raw) == [x % FR_MOD for x in w]


GOLDEN = ref_interop.TestWebsnarkGoldenFixture


@pytest.mark.parametrize("case", ["parse", "write", "witness"])
def test_websnark_golden_fixture(case):
    """tests/test_interop.py's golden bytes, written from the layout's
    spec and not by either package's writer."""
    expected = GOLDEN().expected
    if case == "parse":
        got = io.parse_websnark_proving_key(bytes.fromhex(GOLDEN.FIXTURE_HEX))
        assert got == expected
    elif case == "write":
        assert io.binarify_proving_key(expected).hex() == GOLDEN.FIXTURE_HEX
    else:
        w = [1, 0, 2 ** 255 - 19]
        want = (b"\x01" + b"\x00" * 63
                + ((2 ** 255 - 19) % FR_MOD).to_bytes(32, "little"))
        assert io.binarify_witness(w) == want


def test_circom_fixture_sets_up_proves_and_verifies():
    path = os.path.join(FIXTURES, "circom035_multiplier.json")
    r1 = circom_loader.load_circom_json(path)
    jr1 = jcircom.load_circom_json(path)
    assert (r1.n_vars, r1.n_public, r1.constraints) == \
        (jr1.n_vars, jr1.n_public, jr1.constraints)
    a_v, b_v, c_v = 3, 4, 10
    wit = [1, a_v * b_v + c_v, c_v, a_v, b_v, a_v * b_v]
    pk = setup_host(r1, seed=b"circom-fixture")
    proof = P.prove(pk, r1, wit, r=5, s=7, device="cpu", c=4)
    assert _abc(proof) == _abc(P.prove_host(pk, r1, wit, r=5, s=7))
    assert verify(pk.vk, proof, wit[1:3])
    assert not verify(pk.vk, proof, [wit[1] + 1, wit[2]])


def _fixture_vk() -> VerifyingKey:
    with open(os.path.join(FIXTURES, "txverifier_vk.json")) as f:
        s = json.load(f)
    g2 = lambda p: ((int(p[0][0]), int(p[0][1])), (int(p[1][0]), int(p[1][1])))
    return VerifyingKey(alpha1=(int(s["alpha1"][0]), int(s["alpha1"][1])),
                        beta2=g2(s["beta2"]), gamma2=g2(s["gamma2"]),
                        delta2=g2(s["delta2"]),
                        ic=[(int(x), int(y)) for x, y in s["ic"]])


def snarkjs_verifier_source(vk: VerifyingKey) -> str:
    """The lines of a verifier written by snarkjs 0.1.20's generateverifier
    that solvk reads (the Pairing library's generators and the
    verifyingKey() body), with Fq2 coordinates imaginary first, as that
    contract writes them. chain/genverifier.py writes another layout."""
    g1 = lambda p: f"Pairing.G1Point({p[0]}, {p[1]})"
    g2 = lambda q: (f"Pairing.G2Point([{q[0][1]}, {q[0][0]}], "
                    f"[{q[1][1]}, {q[1][0]}])")
    (gx, gy), ((gxr, gxi), (gyr, gyi)) = ref.G1_GEN, ref.G2_GEN
    lines = ["library Pairing {",
             f"    function P1() internal pure returns (G1Point) {{",
             f"        return G1Point({gx}, {gy});", "    }",
             f"    function P2() internal pure returns (G2Point) {{",
             f"        return G2Point([{gxi}, {gxr}], [{gyi}, {gyr}]);",
             "    }", "}",
             "    function verifyingKey() pure internal returns (VerifyingKey"
             " memory vk) {",
             f"        vk.alfa1 = {g1(vk.alpha1)};",
             f"        vk.beta2 = {g2(vk.beta2)};",
             f"        vk.gamma2 = {g2(vk.gamma2)};",
             f"        vk.delta2 = {g2(vk.delta2)};",
             f"        vk.IC = new Pairing.G1Point[]({len(vk.ic)});"]
    lines += [f"        vk.IC[{i}] = {g1(p)};" for i, p in enumerate(vk.ic)]
    return "\n".join(lines + ["    }"]) + "\n"


def test_solvk_reads_the_fixture_vk():
    """The snarkjs TxVerifier's VK (74 IC points, tests/fixtures) in the
    layout snarkjs writes, read back by the port's solvk and the
    reference's; the Pairing library's generators are ours."""
    vk = _fixture_vk()
    src = snarkjs_verifier_source(vk)
    got = solvk.parse_verifier_source(src)
    assert got == vk
    assert dataclasses.astuple(got) == \
        dataclasses.astuple(jsolvk.parse_verifier_source(src))
    assert len(got.ic) == 74
    assert solvk.parse_pairing_generators(src) == \
        jsolvk.parse_pairing_generators(src) == (ref.G1_GEN, ref.G2_GEN)
    # the port's genverifier writes the reference's layout for that key
    assert generate_verifier(vk) == jgen(vk)


def test_cipher_matches_reference():
    priv_a = 0x52F84E3F063F5F78C2FA0B8D3A5E8240F5F0C8E2A1D73B9465F30E2C19A70301 % FR_MOD
    priv_b = priv_a + 17
    msg = [1, 0, FR_MOD - 1, 10 ** 18 + 7, FR_MOD + 12345]
    enc = cipher.encrypt(msg, priv_a)
    want = jcipher.encrypt(msg, priv_a)
    assert (enc.iv, enc.msg) == (want.iv, want.msg)
    assert cipher.decrypt(enc, priv_a) == msg
    pub_b = eddsa.gen_public_key(priv_b)
    e1 = cipher.ecdh_encrypt(msg, priv_a, pub_b)
    j1 = jcipher.ecdh_encrypt(msg, priv_a, pub_b)
    assert (e1.iv, e1.msg) == (j1.iv, j1.msg)
    assert cipher.ecdh_decrypt(e1, priv_b, eddsa.gen_public_key(priv_a)) == msg
