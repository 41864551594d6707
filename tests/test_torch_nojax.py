"""zkrollup_torch needs no JAX: with `jax` blocked, every module of the port
imports, and the port sets up, proves and verifies the cubic circuit on the
CPU. No source file of the port names jax in an import."""

import os
import pathlib
import re
import subprocess
import sys

import zkrollup_torch

PKG = pathlib.Path(zkrollup_torch.__file__).parent
ROOT = PKG.parent

SCRIPT = r"""
import sys
sys.modules["jax"] = None            # any `import jax` now raises
import importlib, pkgutil
import zkrollup_torch
names = [m.name for m in pkgutil.walk_packages(zkrollup_torch.__path__,
                                               "zkrollup_torch.")]
for name in names:
    importlib.import_module(name)

from zkrollup.r1cs.builder import Builder
from zkrollup_torch.groth16.prove import prove, prove_host
from zkrollup_torch.groth16.setup import setup
from zkrollup_torch.groth16.verify import verify

bld = Builder()
out = bld.alloc_output_deferred()
y = bld.alloc_public_input(5)
x = bld.alloc(3)
bld.bind_output(out, bld.mul(bld.mul(x, x), x) + y)
pk = setup(bld.r1cs(), seed=b"nojax")
proof = prove(pk, bld.r1cs(), bld.witness(), r=2, s=3, device="cpu", c=4)
assert verify(pk.vk, proof, bld.public_signals())
host = prove_host(pk, bld.r1cs(), bld.witness(), r=2, s=3)
assert (proof.a, proof.b, proof.c) == (host.a, host.b, host.c)
assert not any(m == "jax" or m.startswith("jax.") for m, v in
               sys.modules.items() if v is not None)
print("OK", len(names))
"""


def test_port_runs_with_jax_blocked():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in [env.get("PYTHONPATH")] if p])
    env["OMP_NUM_THREADS"] = "1"      # as the other test files: one thread
    res = subprocess.run([sys.executable, "-c", SCRIPT], cwd=str(ROOT),
                         env=env, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.startswith("OK")
    assert int(res.stdout.split()[1]) >= 15       # every module was imported


def test_no_jax_import_in_the_port():
    pattern = re.compile(r"^\s*(import\s+jax|from\s+jax[\s.])", re.M)
    offenders = [str(p.relative_to(ROOT)) for p in PKG.rglob("*.py")
                 if pattern.search(p.read_text())]
    assert offenders == []
