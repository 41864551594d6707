"""The port's jax-free copies of zkrollup modules (ref, config, r1cs, tree,
witness, native engine) against their originals on the same inputs.

zkrollup_torch carries its own copy of each module it needs from zkrollup,
so that it imports nothing of the JAX package. A copy must compute what the
original computes: each case runs one entry point of both and compares the
results, and the native engine case compares the port's build of the
engine (build/native/) with the original's.
"""

import importlib

import pytest

PRIV_A = 3461904823869495924446136355166658661994387995314494198873459573992912434327 % (2 ** 250)


def _both(name):
    return (importlib.import_module(f"zkrollup_torch.{name}"),
            importlib.import_module(f"zkrollup.{name}"))


def _synthesize(pkg):
    circuits = importlib.import_module(f"{pkg}.r1cs.circuits")
    keys = importlib.import_module(f"{pkg}.groth16.keys")
    prover = importlib.import_module(f"{pkg}.operator.prover")
    res = circuits.synthesize_batch_process_tx(
        prover._dummy_tx_inputs(1, 3), 1, 3, check=False)
    return keys.r1cs_digest(res.r1cs), res.witness, res.public_signals


def _merkle(pkg):
    merkle = importlib.import_module(f"{pkg}.tree.merkle")
    tree = merkle.create_merkle_tree(5)
    for v in (11, 22, 33, 44, 55):
        tree.insert_(v)
    tree.update_(2, 99)
    path = tree.get_update_path(3)
    return tree.root, path.path_elements, path.path_indexes


def _eddsa(pkg):
    eddsa = importlib.import_module(f"{pkg}.ref.eddsa")
    pub = eddsa.gen_public_key(PRIV_A)
    sig = eddsa.sign(PRIV_A, [1, 2, 3])
    return (pub, (sig.R8, sig.S), eddsa.verify([1, 2, 3], sig, pub),
            eddsa.verify([1, 2, 4], sig, pub))


def _mimc(pkg):
    mimc = importlib.import_module(f"{pkg}.ref.mimc")
    return (mimc.multi_hash([1, 2, 3, 2 ** 200]), mimc.multi_hash_py([7, 8]),
            mimc.mimc7_multi_hash([5, 6], 9))


def _keccak(pkg):
    keccak = importlib.import_module(f"{pkg}.ref.keccak")
    return keccak.keccak256(b""), keccak.keccak256(b"mimcsponge" * 20)


def _pairing(pkg):
    bn254 = importlib.import_module(f"{pkg}.ref.bn254")
    return bn254.pairing(bn254.g1_mul(bn254.G1_GEN, 5),
                         bn254.g2_mul(bn254.G2_GEN, 7))


def _config(pkg):
    config = importlib.import_module(f"{pkg}.config")
    cfg = config.RollupConfig()
    return cfg.batch_size, cfg.tree_depth, cfg.tree_zero_value


def _fixed_base(pkg):
    engine = importlib.import_module(f"{pkg}.native.engine")
    assert engine.available()
    sc = [0, 1, 5, 2 ** 253 + 17, 12345678901234567890]
    x, y, inf = engine.g1_fixed_base_mont(engine.ints_to_fr_bytes(sc),
                                          len(sc))
    return x.tobytes(), y.tobytes(), inf.tobytes(), engine._LIB_PATH


CASES = {"synthesize_batch_process_tx": _synthesize, "merkle": _merkle,
         "eddsa": _eddsa, "mimc": _mimc, "keccak": _keccak,
         "pairing": _pairing, "config": _config,
         "engine_fixed_base": _fixed_base}


@pytest.mark.parametrize("case", sorted(CASES))
def test_copy_matches_original(case):
    got = CASES[case]("zkrollup_torch")
    want = CASES[case]("zkrollup")
    if case == "engine_fixed_base":
        # two libraries, built apart: the port's under build/native/
        assert "build" in got[3] and got[3] != want[3]
        got, want = got[:3], want[:3]
    assert got == want


def test_copies_are_the_port_own_modules():
    for name in ("ref.bn254", "ref.mimc", "r1cs.builder", "tree.merkle",
                 "witness.assembler", "config", "native.engine"):
        port, orig = _both(name)
        assert port is not orig
        assert port.__name__.startswith("zkrollup_torch.")
        assert "zkrollup_torch" in port.__file__
