"""zkrollup_torch setup on a torch device against zkrollup's (JAX) device
setup and the native engine: the fixed-base tables limb for limb, and the
whole proving key of the cubic circuit byte for byte.

zkrollup prefers the native engine for its tables whenever it is built;
ZKROLLUP_SETUP_BACKEND=device (read at call time) makes it take its JAX
fixed-base path instead, which is the one the port's device setup follows.
The scalar counts equal the cubic circuit's (25 G1 and 6 G2 scalars), so
the reference compiles each of its fixed-base programs once in this file.
The card runs the same code in test_torch_cuda.py and chip_smoke.py.
"""

import numpy as np
import pytest
import torch

from zkrollup.groth16.setup import setup as jax_setup
from zkrollup.msm import fixed_base as jfb
from zkrollup.ref.bn254 import R as FR_MOD
from zkrollup_torch.groth16.setup import setup, setup_host
from zkrollup_torch.msm import fixed_base as fb
from zkrollup_torch.r1cs.builder import Builder

# One intra-op thread per process: the suite runs in several worker
# processes, whose torch thread pools would otherwise fight for the cores.
torch.set_num_threads(1)

N_G1, N_G2 = 25, 6


def _cubic():
    bld = Builder()
    out = bld.alloc_output_deferred()
    y = bld.alloc_public_input(5)
    x = bld.alloc(3)
    bld.bind_output(out, bld.mul(bld.mul(x, x), x) + y)
    return bld.r1cs()


def _scalars(n, seed):
    """0, 1, r - 1, a scalar twice, then random scalars below r."""
    rng = np.random.RandomState(seed)
    rand = [int.from_bytes(rng.bytes(32), "little") % FR_MOD
            for _ in range(n)]
    return ([0, 1, FR_MOD - 1, rand[0], rand[0]] + rand[1:])[:n]


def _leaves(t):
    return [np.asarray(v) for c in t
            for v in (c if isinstance(c, tuple) else (c,))]


def _same_bytes(got, want):
    got, want = _leaves(got), _leaves(want)
    assert len(got) == len(want)
    for u, v in zip(got, want):
        assert u.dtype == v.dtype and u.shape == v.shape
        assert u.tobytes() == v.tobytes()


@pytest.fixture
def jax_device_backend(monkeypatch):
    monkeypatch.setenv("ZKROLLUP_SETUP_BACKEND", "device")


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_points_from_scalars_match_jax(jax_device_backend, group):
    n = N_G1 if group == "g1" else N_G2
    sc = _scalars(n, 7 if group == "g1" else 8)
    got = getattr(fb, f"{group}_points_from_scalars")(sc, device="cpu")
    want = getattr(jfb, f"{group}_points_from_scalars")(sc)
    _same_bytes(got, want)
    inf = got[2][:, 0]
    assert inf[0] and not inf[1:].any()          # 0 * G is infinity
    assert not np.asarray(_leaves(got[:2])[0][0]).any()   # stored as 0, 0


def test_window_tables_match_jax():
    _same_bytes(fb._g1_table_host(), jfb._g1_table_host())
    _same_bytes(fb._g2_table_host(), jfb._g2_table_host())


def _same_key(got, want):
    for f in ("a_g1", "b1_g1", "c_g1", "h_g1", "b2_g2"):
        _same_bytes(getattr(got, f), getattr(want, f))
    for f in ("n_vars", "n_public", "domain_size", "alpha1", "beta1",
              "delta1", "beta2", "delta2", "r1cs_digest"):
        assert getattr(got, f) == getattr(want, f), f
    assert (got.vk.alpha1, got.vk.beta2, got.vk.gamma2, got.vk.delta2,
            got.vk.ic) == (want.vk.alpha1, want.vk.beta2, want.vk.gamma2,
                           want.vk.delta2, want.vk.ic)


def test_setup_on_cpu_matches_jax_device_setup_and_setup_host(
        jax_device_backend):
    r1cs = _cubic()
    assert (3 * r1cs.n_vars + 7, r1cs.n_vars) == (N_G1, N_G2)
    got = setup(r1cs, seed=b"setup-parity", device="cpu")
    _same_key(got, jax_setup(r1cs, seed=b"setup-parity"))
    _same_key(got, setup_host(r1cs, seed=b"setup-parity"))


def test_setup_on_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises((RuntimeError, AssertionError)):
        setup(_cubic(), seed=b"no-card", device="cuda")
