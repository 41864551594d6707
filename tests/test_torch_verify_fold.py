"""The port's Groth16 verify (groth16/verify.py) against the native
engine's groth16_verify and the JAX package's verify: the same verdict on
valid, tampered and malformed proofs and inputs, on setup keys and on keys
built from known discrete logs (an IC entry at infinity, vk_x at
infinity); its fold, one engine Pippenger over the IC planes packed once a
key, against the naive fold; and the FOLDS counter by route.
"""

import random

import pytest
import torch

from zkrollup.groth16 import keys as jkeys
from zkrollup.groth16 import verify as jverify
from zkrollup_torch.groth16 import verify as V
from zkrollup_torch.groth16.keys import Proof, VerifyingKey
from zkrollup_torch.groth16.prove import prove_host
from zkrollup_torch.groth16.setup import setup_host
from zkrollup_torch.native import engine
from zkrollup_torch.r1cs.builder import Builder
from zkrollup_torch.r1cs.circuits import synthesize_withdraw
from zkrollup_torch.ref import bn254 as ref
from zkrollup_torch.ref import eddsa
from zkrollup_torch.ref.bn254 import Q, R as FR_MOD
from zkrollup_torch.spans import finished

# One intra-op thread per process, as in the other port test files.
torch.set_num_threads(1)

G1, G2 = ref.G1_GEN, ref.G2_GEN
SEED = b"verify-fold"


def _cubic():
    """out = x^3 + y with private x = 3, public y = 5: signals [32, 5]."""
    bld = Builder()
    out = bld.alloc_output_deferred()
    ypub = bld.alloc_public_input(5)
    xv = bld.alloc(3)
    bld.bind_output(out, bld.mul(bld.mul(xv, xv), xv) + ypub)
    return bld.r1cs(), bld.witness(), bld.public_signals()


def _withdraw():
    res = synthesize_withdraw(eddsa.format_priv_key_for_babyjub(4151626),
                              31337)
    return res.r1cs, res.witness, res.public_signals


def _dlog_key(ks, rng):
    """A key whose IC_i = ks[i] G1 (None where ks[i] is 0) and a maker of
    accepting proofs for it: A B = alpha beta + x gamma + c delta in the
    exponent, x the discrete log of vk_x."""
    al, be, ga, de = (rng.randrange(1, FR_MOD) for _ in range(4))
    vk = VerifyingKey(alpha1=engine.g1_mul(G1, al),
                      beta2=engine.g2_mul(G2, be),
                      gamma2=engine.g2_mul(G2, ga),
                      delta2=engine.g2_mul(G2, de),
                      ic=[engine.g1_mul(G1, k) if k else None for k in ks])

    def prove(signals):
        x = (ks[0] + sum(s * k for s, k in zip(signals, ks[1:]))) % FR_MOD
        b, c = rng.randrange(1, FR_MOD), rng.randrange(1, FR_MOD)
        a = (al * be + x * ga + c * de) * pow(b, -1, FR_MOD) % FR_MOD
        return Proof(a=engine.g1_mul(G1, a), b=engine.g2_mul(G2, b),
                     c=engine.g1_mul(G1, c))
    return vk, prove


@pytest.fixture(scope="module")
def cases():
    """name -> (vk, valid proof, its public signals)."""
    out = {}
    for name, (r1cs, w, pub) in (("cubic", _cubic()),
                                 ("withdraw", _withdraw())):
        pk = setup_host(r1cs, seed=SEED)
        out[name] = (pk.vk, prove_host(pk, r1cs, w, r=7, s=9), pub)
    rng = random.Random(22)
    # four inputs, IC_2 at infinity: s_1 does not enter vk_x
    vk, prove = _dlog_key([rng.randrange(1, FR_MOD), 5, 0, 7, 11], rng)
    pub = [rng.randrange(FR_MOD) for _ in range(4)]
    out["ic_infinity"] = (vk, prove(pub), pub)
    # one input s with IC_0 = -(s IC_1): vk_x at infinity
    t, s = rng.randrange(1, FR_MOD), rng.randrange(1, FR_MOD)
    vk, prove = _dlog_key([(-s * t) % FR_MOD, t], rng)
    out["vkx_infinity"] = (vk, prove([s]), [s])
    return out


def _neg_y(p):
    return (p[0], Q - p[1])


def _off(p):
    return (p[0], (p[1] + 1) % Q)


def _off2(p):
    (x0, x1), (y0, y1) = p
    return ((x0, x1), ((y0 + 1) % Q, y1))


def _tamper(kind, vk, proof, pub):
    """(proof, signals) of a case derived from a valid one."""
    a, b, c = proof.a, proof.b, proof.c
    return {
        "valid": (proof, pub),
        "a_tampered": (Proof(_neg_y(a), b, c), pub),
        "b_tampered": (Proof(a, ref.g2_add(b, G2), c), pub),
        "c_tampered": (Proof(a, b, vk.alpha1), pub),
        "input_tampered": (proof, [(pub[0] + 1) % FR_MOD] + pub[1:]),
        "input_plus_r": (proof, pub[:-1] + [pub[-1] + FR_MOD]),
        "input_plus_5r": (proof, pub[:-1] + [pub[-1] + 5 * FR_MOD]),
        "input_r": (proof, pub[:-1] + [FR_MOD]),
        "input_2_256_minus_1": (proof, pub[:-1] + [(1 << 256) - 1]),
        "a_off_curve": (Proof(_off(a), b, c), pub),
        "b_off_curve": (Proof(a, _off2(b), c), pub),
        "c_off_curve": (Proof(a, b, _off(c)), pub),
        "a_x_at_least_q": (Proof((a[0] + Q, a[1]), b, c), pub),
        "b_y_at_least_q": (Proof(a, (b[0], (b[1][0] + Q, b[1][1])), c), pub),
        "c_y_at_least_q": (Proof(a, b, (c[0], c[1] + Q)), pub),
        "a_infinity": (Proof(None, b, c), pub),
        "b_infinity": (Proof(a, None, c), pub),
        "c_infinity": (Proof(a, b, None), pub),
        "one_input_more": (proof, pub + [0]),
        "one_input_fewer": (proof, pub[:-1]),
    }[kind]


ACCEPTED = {"valid", "input_plus_r", "input_plus_5r"}
KINDS = ["valid", "a_tampered", "b_tampered", "c_tampered", "input_tampered",
         "input_plus_r", "input_plus_5r", "input_r", "input_2_256_minus_1",
         "a_off_curve", "b_off_curve", "c_off_curve", "a_x_at_least_q",
         "b_y_at_least_q", "c_y_at_least_q", "a_infinity", "b_infinity",
         "c_infinity", "one_input_more", "one_input_fewer"]


def _verdicts(vk, proof, pub):
    """(the port's, engine.groth16_verify's, the JAX package's)."""
    jvk = jkeys.VerifyingKey(alpha1=vk.alpha1, beta2=vk.beta2,
                             gamma2=vk.gamma2, delta2=vk.delta2,
                             ic=list(vk.ic))
    return (V.verify(vk, proof, pub),
            engine.groth16_verify(vk, proof, pub) == 1,
            jverify(jvk, jkeys.Proof(proof.a, proof.b, proof.c), pub))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("key", ["cubic", "withdraw"])
def test_verdict_matches_engine_and_reference(cases, key, kind):
    vk, proof, pub = cases[key]
    proof, pub = _tamper(kind, vk, proof, pub)
    assert _verdicts(vk, proof, pub) == (kind in ACCEPTED,) * 3


@pytest.mark.parametrize("key,change,want", [
    ("ic_infinity", None, True),
    ("ic_infinity", "input_of_the_ic_at_infinity", True),
    ("ic_infinity", "c_tampered", False),
    ("vkx_infinity", None, True),
    ("vkx_infinity", "c_tampered", False),
])
def test_verdict_on_keys_with_points_at_infinity(cases, key, change, want):
    vk, proof, pub = cases[key]
    if change == "input_of_the_ic_at_infinity":
        pub = [pub[0], pub[1] + 1] + pub[2:]
    elif change == "c_tampered":
        proof = Proof(proof.a, proof.b, _neg_y(proof.c))
    if key == "vkx_infinity":
        assert V.fold(vk, pub) is None
    assert _verdicts(vk, proof, pub) == (want,) * 3


def _naive_fold(vk, signals):
    return engine.g1_add(vk.ic[0], engine.g1_msm(vk.ic[1:], signals))


@pytest.mark.parametrize("n", [1, 73, 1171])
def test_fold_equals_naive_fold(n):
    """Random IC multiples of G1, some scalars zero, some at or above r."""
    rng = random.Random(n)
    vk = VerifyingKey(alpha1=None, beta2=None, gamma2=None, delta2=None,
                      ic=[engine.g1_mul(G1, rng.randrange(1, FR_MOD))
                          for _ in range(n + 1)])
    signals = [rng.choice((0, rng.randrange(FR_MOD),
                           rng.randrange(FR_MOD, 1 << 256)))
               for _ in range(n)]
    signals[0] = FR_MOD + 3
    assert V.fold(vk, signals) == _naive_fold(vk, signals)


def test_ic_planes_packed_once_a_key_and_again_for_a_new_ic(cases,
                                                            monkeypatch):
    calls = []
    pack = engine.pack_g1_points_mont
    monkeypatch.setattr(engine, "pack_g1_points_mont",
                        lambda pts: calls.append(len(pts)) or pack(pts))
    vk0, proof, pub = cases["cubic"]
    vk = VerifyingKey(vk0.alpha1, vk0.beta2, vk0.gamma2, vk0.delta2,
                      list(vk0.ic))
    assert V.verify(vk, proof, pub) and V.verify(vk, proof, pub)
    assert calls == [len(pub)]
    planes = V.ic_planes(vk)
    assert planes == pack(vk.ic[1:])
    assert vk == vk0 and "_ic_planes" not in repr(vk)
    vk.ic = [vk.ic[0], vk.ic[2], vk.ic[1]]     # another list: repacked
    assert not V.verify(vk, proof, pub)
    assert calls == [len(pub)] * 2 and V.ic_planes(vk) != planes
    vk.ic = list(vk0.ic)
    assert V.verify(vk, proof, pub) and len(calls) == 3


def test_pack_g1_points_mont_matches_the_key_table_packing():
    """The planes from ints equal pack_g1_table_mont's from Montgomery
    limbs, infinity entries included."""
    from zkrollup_torch.fields.mont import FQ
    pts = [engine.g1_mul(G1, k) for k in (3, 5, 7)] + [None]
    xs = FQ.to_mont_host([0 if p is None else p[0] for p in pts])
    ys = FQ.to_mont_host([0 if p is None else p[1] for p in pts])
    inf = [[p is None] for p in pts]
    assert engine.pack_g1_points_mont(pts) == \
        engine.pack_g1_table_mont((xs, ys, inf))


def test_folds_counted_by_route_and_spans_timed(cases, monkeypatch):
    vk, proof, pub = cases["cubic"]
    V.reset_folds()
    before = {s.id for s in finished()}
    assert V.verify(vk, proof, pub)
    assert V.FOLDS == {"native": 1, "native_inputs": len(pub),
                       "python": 0, "python_inputs": 0}
    new = [s.name for s in finished() if s.id not in before]
    assert new == ["groth16.verify.fold", "groth16.verify.pairing"]
    assert not V.verify(vk, Proof(None, proof.b, proof.c), pub)
    assert V.FOLDS["native"] == 1               # no fold: A at infinity
    monkeypatch.setattr(engine, "available", lambda: False)
    assert V.verify(vk, proof, pub)
    assert V.FOLDS == {"native": 1, "native_inputs": len(pub),
                       "python": 1, "python_inputs": len(pub)}
