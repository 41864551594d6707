"""zkrollup_torch.tools.profile_alu, the integer-unit microbenchmark: its
plain version against the TPU tool's Pallas body (tools/profile_vpu.py:make)
run by pl.pallas_call in interpret mode, for each of the tool's five ops at
(16, 1024) and the tool's 16 reps, bit for bit; __umulhi, which the TPU
tool lacks, against Python ints; and the wrapper's checks.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from zkrollup_torch.tools import profile_alu

# One intra-op thread per process: the suite runs in several worker
# processes, whose torch thread pools would otherwise fight for the cores.
torch.set_num_threads(1)

N = 1024


def _profile_vpu():
    path = os.path.join(os.path.dirname(__file__), "..", "tools",
                        "profile_vpu.py")
    spec = importlib.util.spec_from_file_location("profile_vpu", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# the five ops of tools/profile_vpu.py:main, as it writes them
JAX_OPS = {
    "mul": lambda a, b: a * b,
    "add": lambda a, b: a + b,
    "shift_add": lambda a, b: ((a >> 16) & jnp.uint32(0xFFFF)) + b,
    "f32_mul12": lambda a, b: ((a & jnp.uint32(0xFFF)).astype(jnp.float32)
                               * (b & jnp.uint32(0xFFF)).astype(jnp.float32))
    .astype(jnp.uint32),
    "mul16": lambda a, b: (a & jnp.uint32(0xFFFF)) * (b & jnp.uint32(0xFFFF)),
}


@pytest.fixture(scope="module")
def inputs():
    a, b = profile_alu.inputs(N, "cpu", seed=3)
    return a, b


@pytest.mark.parametrize("op", sorted(JAX_OPS))
def test_plain_matches_pallas_body_interpret(inputs, op):
    vpu = _profile_vpu()
    a, b = inputs
    ua, ub = (jnp.asarray(t.numpy().astype(np.uint32)) for t in (a, b))
    want = pl.pallas_call(
        vpu.make(JAX_OPS[op]),
        out_shape=jax.ShapeDtypeStruct((profile_alu.ROWS, N), jnp.uint32),
        interpret=True)(ua, ub)
    got = profile_alu.alu(op, a, b, vpu.REPS_IN_KERNEL)
    assert vpu.REPS_IN_KERNEL == 16
    assert np.array_equal(got.numpy().astype(np.uint32), np.asarray(want))


def test_umulhi_plain_matches_python_ints(inputs):
    a, b = (t[:, :64] for t in inputs)
    reps = 16
    got = profile_alu.alu("umulhi", a, b, reps).numpy().astype(np.uint32)
    x = a.numpy().astype(np.uint32).astype(object)
    y = b.numpy().astype(np.uint32).astype(object)
    acc = np.zeros_like(x)
    for _ in range(reps):
        acc = acc ^ ((x * y) >> 32)
        x = x ^ acc
    assert np.array_equal(got, acc.astype(np.uint32))


def test_full_width_inputs_wrap_as_uint32():
    """After the first rep a is a full 32-bit word: the int64 plain
    version must wrap products and sums at 2^32 exactly."""
    vals = [0, 1, 0xFFFF, 0x10000, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF,
            0xDEADBEEF]
    grid = np.array([[u, v] for u in vals for v in vals], np.uint64)
    a = torch.from_numpy(grid[:, 0].astype(np.uint32).view(np.int32))
    b = torch.from_numpy(grid[:, 1].astype(np.uint32).view(np.int32))
    a = a.reshape(1, -1).expand(16, -1).contiguous()
    b = b.reshape(1, -1).expand(16, -1).contiguous()
    u = grid[:, 0].astype(object)
    v = grid[:, 1].astype(object)
    want = {"mul": (u * v) % (1 << 32), "umulhi": (u * v) >> 32,
            "add": (u + v) % (1 << 32),
            "shift_add": ((u >> 16) + v) % (1 << 32),
            "f32_mul12": (u & 0xFFF) * (v & 0xFFF),
            "mul16": (u & 0xFFFF) * (v & 0xFFFF)}
    for op, w in want.items():
        got = profile_alu.alu(op, a, b, 1)[0].numpy().astype(np.uint32)
        assert np.array_equal(got, w.astype(np.uint32)), op


def test_unknown_op_raises(inputs):
    with pytest.raises(ValueError, match="unknown op"):
        profile_alu.alu("div", *inputs, 16)
