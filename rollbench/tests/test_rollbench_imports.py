"""Nothing the benchmark's command loads has jax, jaxlib, flax or the JAX
package (zkrollup) as its top-level name, compared whole (the program,
zkrollup_torch, begins with zkrollup); the reference and the input
generator load nothing of the program, nor torch."""

import ast
import os
import subprocess
import sys

from rollbench import harness

FORBIDDEN = {"jax", "jaxlib", "flax", "zkrollup"}
PROGRAM = "zkrollup_torch"


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _sources(sub=""):
    top = os.path.join(harness.ROOT, "rollbench", sub)
    for d, _, files in os.walk(top):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_source_names_jax():
    for path in _sources():
        assert not set(_imports(path)) & FORBIDDEN, path


def test_reference_names_no_program():
    for path in list(_sources("reference")) + [
            os.path.join(harness.ROOT, "rollbench", "inputs.py"),
            os.path.join(harness.ROOT, "rollbench", "workmodel.py")]:
        assert not set(_imports(path)) & {PROGRAM, "torch", "numpy"}, path


def _loaded(code):
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys; print(' '.join("
         "sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=600,
        env={**os.environ, "PYTHONPATH": harness.ROOT})
    assert out.returncode == 0, out.stderr
    return set(out.stdout.split())


def test_command_loads_no_jax():
    """Everything a run imports: the harness, every entry loop, metric
    reader, the trace and the program modules the entries use."""
    code = "\n".join([
        "from rollbench import harness, trace, workmodel, inputs, control",
        "from rollbench.entries import prove, operator, common",
        "b = harness.benchmark()",
        "[harness.reader(m['name']) for m in b['end_to_end'] + "
        "b['per_layer']]",
        "from zkrollup_torch.operator import prover, batchd, queue, state",
        "from zkrollup_torch.chain import simulator",
        "from zkrollup_torch.groth16 import prove as gp, setup, verify",
    ])
    loaded = _loaded(code)
    assert PROGRAM in loaded and not loaded & FORBIDDEN


def test_reference_loads_no_program():
    code = ("from rollbench.reference import groth16, circuits, assembler, "
            "merkle, eddsa\nfrom rollbench import inputs, workmodel")
    loaded = _loaded(code)
    assert not loaded & (FORBIDDEN | {PROGRAM, "torch"})
