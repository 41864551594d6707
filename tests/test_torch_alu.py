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


@pytest.mark.parametrize("op", sorted(profile_alu.CHAINS))
def test_mad_chain_plain_matches_python_ints(op):
    """The multiply-only bodies: acc = a ^ b, then reps multiply-adds,
    mad.lo (acc * a + b mod 2^32) or mad.hi (high word of acc * a, plus b,
    mod 2^32), on full 32-bit words."""
    rng = np.random.RandomState(5)
    u = rng.randint(0, 1 << 32, size=(16, 64), dtype=np.uint64)
    v = rng.randint(0, 1 << 32, size=(16, 64), dtype=np.uint64)
    a, b = (torch.from_numpy(w.astype(np.uint32).view(np.int32))
            for w in (u, v))
    reps = 9
    got = profile_alu.alu(op, a, b, reps).numpy().astype(np.uint32)
    x, y = u.astype(object), v.astype(object)
    acc = x ^ y
    for _ in range(reps):
        prod = acc * x
        acc = ((prod >> 32 if profile_alu.CHAINS[op] else prod) + y) % (1 << 32)
    assert np.array_equal(got, acc.astype(np.uint32))


# a loop as cuobjdump -sass prints it for sm_90, with a smaller loop
# before it: sass_counts takes the largest loop, label to the branch back
_SASS = """
        /*0100*/                   IMAD.MOV.U32 R1, RZ, RZ, c[0x0][0x28] ;
.L_x_0:
        /*0110*/                   IADD3 R2, R2, 0x1, RZ ;
        /*0120*/                   ISETP.NE.AND P0, PT, R2, R3, PT ;
        /*0130*/              @P0 BRA `(.L_x_0) ;
.L_x_1:
        /*0140*/                   IMAD R4, R5, R6, RZ ;
        /*0150*/                   LOP3.LUT R7, R7, R4, RZ, 0x3c, !PT ;
        /*0160*/                   LOP3.LUT R5, R5, R7, RZ, 0x3c, !PT ;
        /*0170*/                   I2FP.F32.U32 R8, R9 ;
        /*0180*/                   FMUL R8, R8, R8 ;
        /*0190*/                   IMAD.HI.U32 R4, R5, R6, R7 ;
        /*01a0*/                   VIADD R2, R2, 0x4 ;
        /*01b0*/              @!P1 BRA `(.L_x_1) ;
        /*01c0*/                   EXIT ;
"""


# the same loops as cuobjdump prints branches: to an address
_SASS_ADDR = """
        /*0100*/                   IMAD.MOV.U32 R1, RZ, RZ, c[0x0][0x28] ;
                                                       /* 0x000fe200078e00ff */
        /*0110*/                   IADD3 R2, R2, 0x1, RZ ;
        /*0120*/                   ISETP.NE.AND P0, PT, R2, R3, PT ;
        /*0130*/              @P0 BRA 0x110 ;
        /*0140*/                   IMAD R4, R5, R6, RZ ;
        /*0150*/                   LOP3.LUT R7, R7, R4, RZ, 0x3c, !PT ;
        /*0160*/                   LOP3.LUT R5, R5, R7, RZ, 0x3c, !PT ;
        /*0170*/                   I2FP.F32.U32 R8, R9 ;
        /*0180*/                   FMUL R8, R8, R8 ;
        /*0190*/                   IMAD.HI.U32 R4, R5, R6, R7 ;
        /*01a0*/                   VIADD R2, R2, 0x4 ;
        /*01b0*/              @!P1 BRA 0x140 ;
        /*01c0*/                   EXIT ;
        /*01d0*/                   BRA 0x1d0;
"""


@pytest.mark.parametrize("sass", [_SASS, _SASS_ADDR],
                         ids=["labels", "addresses"])
def test_sass_loop_classes(sass):
    """The largest loop's opcodes by class, and the clocks an SM needs for
    them at the documented CC 9.0 rates."""
    ops = profile_alu._loop_opcodes(sass)
    assert ops == ["IMAD", "LOP3.LUT", "LOP3.LUT", "I2FP.F32.U32", "FMUL",
                   "IMAD.HI.U32", "VIADD", "BRA"]
    counts = profile_alu.classify(ops)
    assert counts == {"imad": 2, "int": 4, "fp32": 1, "conv": 0,
                      "other": 1, "total": 8}
    # the integer ops at 64 a clock bound it: 4/64 > 2/64 and 8/128
    assert profile_alu.issue_clocks(counts) == 4 / 64
    # an F2I (16 a clock) in place of the FMUL would bound it: 1/16
    counts = profile_alu.classify([o.replace("FMUL", "F2I.U32") for o in ops])
    assert counts["conv"] == 1 and profile_alu.issue_clocks(counts) == 1 / 16
