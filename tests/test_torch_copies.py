"""The port's jax-free copies of zkrollup modules (ref, config, r1cs, tree,
witness, native engine, and the operator loop's chain, tree store, queue
and validation) against their originals on the same inputs.

zkrollup_torch carries its own copy of each module it needs from zkrollup,
so that it imports nothing of the JAX package. A copy must compute what the
original computes: each case runs one entry point of both and compares the
results, and the native engine case compares the port's build of the
engine (build/native/) with the original's.
"""

import importlib

import numpy as np
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


def _words(n: int, seed: int) -> list:
    """n 254-bit values from a numpy seed."""
    rng = np.random.RandomState(seed)
    return [sum(int(w) << (32 * i) for i, w in enumerate(row)) >> 2
            for row in rng.randint(0, 1 << 32, size=(n, 8), dtype=np.uint64)]


def _proof(pkg, seed=7):
    keys = importlib.import_module(f"{pkg}.groth16.keys")
    w = _words(8, seed)
    return keys.Proof(a=(w[0], w[1]), b=((w[2], w[3]), (w[4], w[5])),
                      c=(w[6], w[7]))


def _calldata(pkg):
    cd = importlib.import_module(f"{pkg}.chain.calldata")
    proof = _proof(pkg)
    signals = _words(73, 8)
    bn254 = importlib.import_module(f"{pkg}.ref.bn254")
    signals[5] += bn254.R          # reduced mod r by to_solidity_proof
    return (cd.to_solidity_proof(proof, signals),
            cd.rollup_calldata(proof, signals),
            cd.withdraw_calldata(10 ** 17, proof, signals[:3]),
            cd.deposit_calldata(*signals[3:5]))


def _genverifier(pkg):
    keys = importlib.import_module(f"{pkg}.groth16.keys")
    gv = importlib.import_module(f"{pkg}.chain.genverifier")
    bn254 = importlib.import_module(f"{pkg}.ref.bn254")
    g1 = lambda k: bn254.g1_mul(bn254.G1_GEN, k)
    g2 = lambda k: bn254.g2_mul(bn254.G2_GEN, k)
    vk = keys.VerifyingKey(alpha1=g1(3), beta2=g2(5), gamma2=g2(7),
                           delta2=g2(11), ic=[g1(13), g1(17), g1(19)])
    return gv.generate_verifier(vk), gv.generate_verifier(vk, "WithdrawVerifier")


def _simulator(pkg):
    sim = importlib.import_module(f"{pkg}.chain.simulator")
    config = importlib.import_module(f"{pkg}.config")
    eddsa = importlib.import_module(f"{pkg}.ref.eddsa")
    c = sim.RollUpContract(config.RollupConfig(), None, None)
    pubs = [eddsa.gen_public_key(k) for k in (PRIV_A, PRIV_A + 1)]
    roots = []
    for pub, value in ((pubs[0], 10 ** 18), (pubs[1], 2 * 10 ** 18),
                       (pubs[0], 5 * 10 ** 17)):   # the third: an update
        c.deposit(pub[0], pub[1], value)
        roots.append(c.balance_tree.get_root())
    tree = sim.ChainMerkleTree(5, 0)
    tree.whitelist.add("x")
    for v in (11, 22, 33):
        tree.insert(v, "x")
    tree.update(1, 99, "x")
    return (roots, [c.get_user_data(c.get_user_key(i)) for i in (0, 1)],
            [(e.name, e.args) for e in c.events], c.eth_balance,
            c.balance_tree.get_inserted_leaves_no(), tree.get_root(),
            tree.filled_paths)


def _signed(pkg, priv, frm, to, amount, fee, nonce):
    eddsa = importlib.import_module(f"{pkg}.ref.eddsa")
    asm = importlib.import_module(f"{pkg}.witness.assembler")
    tx = asm.Transaction(frm, to, amount, fee, nonce)
    tx.signature = eddsa.sign(priv, asm.format_tx(tx))
    return tx


def _queue(pkg):
    q = importlib.import_module(f"{pkg}.operator.queue").TxQueue()
    seen = [q.peek_batch(1)]
    for i in range(3):
        q.push(_signed(pkg, PRIV_A, 0, 1, 10 ** 17, 10 ** 15, i + 1))
    view = lambda b: None if b is None else [
        (t.from_index, t.to_index, t.amount, t.fee, t.nonce,
         t.signature.R8, t.signature.S) for t in b]
    seen += [q.pending_count(), view(q.peek_batch(2)),
             view(q.peek_batch(2, offset=1)), view(q.peek_batch(3, offset=1))]
    q.mark_processed(2)
    seen += [q.last_inserted, q.last_processed, q.pending_count(),
             view(q.peek_batch(2)), view(q.peek_batch(1)),
             view(q.pending_txs())]
    return seen


# the cases of tests/test_operator_chain.py's TestValidation: (sender key,
# from, to, amount, fee, nonce, the queued txs ahead of it)
_W = 10 ** 18
_PRIV_B = 9876543210987654321
VALIDATION_CASES = [
    (PRIV_A, 0, 1, _W // 10, _W // 100, 1, []),
    (PRIV_A, 5, 1, _W // 10, _W // 100, 1, []),
    (PRIV_A, 0, 5, _W // 10, _W // 100, 1, []),
    (PRIV_A, 0, 1, 2 * _W, _W // 100, 1, []),
    (PRIV_A, 0, 1, _W // 10, 10 ** 14 // 10, 1, []),
    (PRIV_A, 0, 1, _W // 10, _W // 100, 5, []),
    (_PRIV_B, 0, 1, _W // 10, _W // 100, 1, []),
    (PRIV_A, 0, 1, _W // 10, _W // 100, 2, []),
    (PRIV_A, 0, 1, _W // 10, _W // 100, 2,
     [(PRIV_A, 0, 1, _W // 10, _W // 100, 1)]),
    (PRIV_A, 0, 1, _W * 5 // 10, _W // 100, 2,
     [(PRIV_A, 0, 1, _W * 7 // 10, _W // 100, 1)]),
    (_PRIV_B, 1, 0, _W * 15 // 10, _W // 100, 1, []),
    (_PRIV_B, 1, 0, _W * 15 // 10, _W // 100, 1,
     [(PRIV_A, 0, 1, _W * 9 // 10, _W // 100, 1)]),
]


def _validation(pkg):
    val = importlib.import_module(f"{pkg}.operator.validation")
    state = importlib.import_module(f"{pkg}.operator.state")
    sim = importlib.import_module(f"{pkg}.chain.simulator")
    config = importlib.import_module(f"{pkg}.config")
    eddsa = importlib.import_module(f"{pkg}.ref.eddsa")
    cfg = config.RollupConfig()
    c, st = sim.RollUpContract(cfg, None, None), state.OperatorState(cfg)
    for k in (PRIV_A, _PRIV_B):
        pub = eddsa.gen_public_key(k)
        c.deposit(pub[0], pub[1], _W)
    for ev in c.events:
        st.on_chain_event(ev)
    tree = st.load_tree()
    verdicts = []
    for *tx, ahead in VALIDATION_CASES:
        try:
            val.validate_tx(cfg, tree, _signed(pkg, *tx),
                            pending=[_signed(pkg, *a) for a in ahead])
            verdicts.append("accepted")
        except val.ValidationError as e:
            verdicts.append(str(e))
    return verdicts


def _tree_store(pkg):
    store_mod = importlib.import_module(f"{pkg}.tree.store")
    merkle = importlib.import_module(f"{pkg}.tree.merkle")
    store = store_mod.TreeStore()
    tree = merkle.create_merkle_tree(5)
    store.save("t", tree)
    for i, v in enumerate((11, 22, 33, 44)):
        tree.insert_(v, {"balance": v, "nonce": i})
        store.save("t", tree)
    loaded = store.load("t")
    seen = [loaded.root, loaded.leaves, loaded.leaves_raw,
            loaded.filled_paths, loaded.next_leaf_index, loaded.equals(tree),
            store.exists("t"), store.exists("u"),
            store.verify_integrity("t", use_device=False)]
    tree.update_(1, 99, {"balance": 99, "nonce": 7})
    store.save("t", tree, leaf_index=1)
    loaded = store.load("t")
    seen += [loaded.root, loaded.leaves_raw,
             store.verify_integrity("t", use_device=False)]
    # every leaf of a tree saved at once: the same rows
    store.save_all_leaves("all", tree)
    seen += [store.load("all").equals(tree), store.conn.execute(
        "SELECT l.id, l.idx, l.raw, l.hash FROM leaves l JOIN merkletrees m"
        " ON l.merkletree_id = m.id WHERE m.name = 'all' ORDER BY l.id"
    ).fetchall()]
    # a corrupted leaf row: the rebuilt root no longer matches
    store.conn.execute("UPDATE leaves SET hash='5' WHERE idx=2")
    return seen + [store.verify_integrity("t", use_device=False)]


CASES = {"synthesize_batch_process_tx": _synthesize, "merkle": _merkle,
         "eddsa": _eddsa, "mimc": _mimc, "keccak": _keccak,
         "pairing": _pairing, "config": _config,
         "engine_fixed_base": _fixed_base, "calldata": _calldata,
         "genverifier": _genverifier, "simulator": _simulator,
         "tx_queue": _queue, "validate_tx": _validation,
         "tree_store": _tree_store}


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
                 "witness.assembler", "config", "native.engine",
                 "chain.simulator", "chain.calldata", "chain.genverifier",
                 "chain.deploy", "tree.store", "operator.state",
                 "operator.queue", "operator.validation", "operator.batchd",
                 "operator.service", "cli.main"):
        port, orig = _both(name)
        assert port is not orig
        assert port.__name__.startswith("zkrollup_torch.")
        assert "zkrollup_torch" in port.__file__


def test_calldata_reverses_pi_b():
    """to_solidity_proof swaps each of pi_b's Fq2 coordinates (the EVM
    pairing precompile reads (imaginary, real)) and reduces the inputs."""
    from zkrollup_torch.chain.calldata import to_solidity_proof
    from zkrollup_torch.ref.bn254 import R
    proof = _proof("zkrollup_torch")
    sp = to_solidity_proof(proof, [R + 3, 4])
    assert sp["b"] == [[proof.b[0][1], proof.b[0][0]],
                       [proof.b[1][1], proof.b[1][0]]]
    assert sp["inputs"] == [3, 4]


def test_validation_cases_reach_each_verdict():
    """The validation cases above cover acceptance and every message."""
    verdicts = _validation("zkrollup_torch")
    assert verdicts.count("accepted") == 3
    for part in ("(from) not found", "(to) not found", "unable to send",
                 "0.3%", "Expected nonce", "Invalid signature"):
        assert any(part in v for v in verdicts), part
