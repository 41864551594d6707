"""zkrollup_torch stands alone: with `jax` and the `zkrollup` package both
blocked, every module of the port imports, and the port sets up (on the
CPU), proves and verifies the cubic circuit built with its own r1cs
builder. No source file of the port, chip_smoke.py or the on-card tests
names jax or the zkrollup package in an import."""

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
sys.modules["zkrollup"] = None       # and so does `import zkrollup...`
import importlib, pkgutil
import zkrollup_torch
names = [m.name for m in pkgutil.walk_packages(zkrollup_torch.__path__,
                                               "zkrollup_torch.")]
for name in names:
    importlib.import_module(name)

from zkrollup_torch.r1cs.builder import Builder
from zkrollup_torch.groth16.prove import prove, prove_host
from zkrollup_torch.groth16.setup import setup, setup_host
from zkrollup_torch.groth16.verify import verify

bld = Builder()
out = bld.alloc_output_deferred()
y = bld.alloc_public_input(5)
x = bld.alloc(3)
bld.bind_output(out, bld.mul(bld.mul(x, x), x) + y)
pk = setup(bld.r1cs(), seed=b"nojax", device="cpu")
assert pk.vk == setup_host(bld.r1cs(), seed=b"nojax").vk
proof = prove(pk, bld.r1cs(), bld.witness(), r=2, s=3, device="cpu", c=4)
assert verify(pk.vk, proof, bld.public_signals())
host = prove_host(pk, bld.r1cs(), bld.witness(), r=2, s=3)
assert (proof.a, proof.b, proof.c) == (host.a, host.b, host.c)
loaded = [m for m, v in sys.modules.items() if v is not None and (
    m in ("jax", "zkrollup") or m.startswith(("jax.", "zkrollup.")))]
assert not loaded, loaded
print("OK", len(names))
"""

# `import zkrollup`, `import zkrollup.x`, `from zkrollup import`,
# `from zkrollup.x import` (the JAX package; zkrollup_torch does not match)
_ZKROLLUP = re.compile(r"^\s*(import\s+zkrollup(\s|\.|,|$)|"
                       r"from\s+zkrollup(\s|\.))", re.M)
_JAX = re.compile(r"^\s*(import\s+jax|from\s+jax[\s.])", re.M)


def test_port_runs_with_jax_blocked():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in [env.get("PYTHONPATH")] if p])
    env["OMP_NUM_THREADS"] = "1"      # as the other test files: one thread
    res = subprocess.run([sys.executable, "-c", SCRIPT], cwd=str(ROOT),
                         env=env, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.startswith("OK")
    assert int(res.stdout.split()[1]) >= 30       # every module was imported


def _sources():
    return list(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                      ROOT / "tests" / "test_torch_cuda.py"]


def test_the_scan_covers_every_source():
    """The port's subpackages, its tools (the measurement tools too),
    operator loop (chain, operator, tree store, CLI), multi-device prover
    (dist) and formats (interop, solvk, circom_loader, cipher) included,
    the smoke script and the on-card tests."""
    names = {str(p.relative_to(ROOT)) for p in _sources()}
    for want in ("zkrollup_torch/tools/profile_alu.py",
                 "zkrollup_torch/tools/g2_kernel_check.py",
                 "zkrollup_torch/msm/glv.py", "chip_smoke.py",
                 "tests/test_torch_cuda.py",
                 "zkrollup_torch/chain/simulator.py",
                 "zkrollup_torch/chain/calldata.py",
                 "zkrollup_torch/chain/genverifier.py",
                 "zkrollup_torch/chain/deploy.py",
                 "zkrollup_torch/tree/store.py",
                 "zkrollup_torch/operator/state.py",
                 "zkrollup_torch/operator/queue.py",
                 "zkrollup_torch/operator/validation.py",
                 "zkrollup_torch/operator/batchd.py",
                 "zkrollup_torch/operator/service.py",
                 "zkrollup_torch/cli/main.py",
                 "zkrollup_torch/cli/__main__.py",
                 "zkrollup_torch/dist/mesh.py",
                 "zkrollup_torch/dist/launch.py",
                 "zkrollup_torch/tools/multihost_sim.py",
                 "zkrollup_torch/groth16/interop.py",
                 "zkrollup_torch/groth16/solvk.py",
                 "zkrollup_torch/r1cs/circom_loader.py",
                 "zkrollup_torch/ref/cipher.py",
                 "zkrollup_torch/tools/common.py",
                 "zkrollup_torch/tools/trace_prove.py",
                 "zkrollup_torch/tools/prove_breakdown.py",
                 "zkrollup_torch/tools/profile_msm.py",
                 "zkrollup_torch/tools/profile_msm2.py",
                 "zkrollup_torch/tools/msm_sweep.py",
                 "zkrollup_torch/tools/profile_kernels.py",
                 "zkrollup_torch/tools/mesh_prove_check.py",
                 "zkrollup_torch/tools/profiler_drops.py"):
        assert want in names


def test_no_jax_import_in_the_port():
    offenders = [str(p.relative_to(ROOT)) for p in _sources()
                 if _JAX.search(p.read_text())]
    assert offenders == []


def test_no_zkrollup_import_in_the_port():
    offenders = [str(p.relative_to(ROOT)) for p in _sources()
                 if _ZKROLLUP.search(p.read_text())]
    assert offenders == []
    assert _ZKROLLUP.search("from zkrollup.ref import bn254\n")
    assert _ZKROLLUP.search("import zkrollup\n")
    assert not _ZKROLLUP.search("from zkrollup_torch.ref import bn254\n")
