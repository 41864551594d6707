"""The mesh prover on a real circuit against a single-device proof.

    python -m zkrollup_torch.tools.mesh_prove_check
        [--circuit toy|withdraw|batch:B,D] [--devices 8] [--device cuda]

The counterpart of tools/mesh_prove_check.py (MESH_CIRCUIT and
MESH_DEVICES there). Circuits: toy (the reference's 40 squarings),
withdraw (3,585 variables, domain 4,096), or batch:B,D for
BatchProcessTx(B, D) on all-zero inputs. The key comes from setup on the
device (seed b"mesh-check"); prove(mesh=) runs on a mesh of --devices
shards: the visible cards when there are that many and the device is a
card, else a virtual mesh of the device repeated (dist/mesh.py:
make_mesh). The mesh proof must verify, and its bytes must equal a
single proof by the native engine (prove_host) where it is built, else by
prove(device=), at r = 3, s = 5. Prints

    MESH <CIRCUIT> OK (bit-identical vs <host|device>)

and exits 0 only then.
"""

from __future__ import annotations

import argparse
import time

import torch

from . import common


def build(which: str):
    """(r1cs, witness, public signals) of the circuit `which`."""
    if which == "toy":
        from ..r1cs.builder import Builder
        bld = Builder(check=True)
        out = bld.alloc_output_deferred()
        x = bld.alloc_public_input(7)
        t = x
        for _ in range(40):
            t = bld.mul(t, t) + x
        bld.bind_output(out, t)
        return bld.r1cs(), bld.witness(), bld.public_signals()
    if which == "withdraw":
        from ..r1cs.circuits import synthesize_withdraw
        res = synthesize_withdraw(12345678901234567, 42)
        return res.r1cs, res.witness, res.public_signals
    if which.startswith("batch:"):
        from ..operator.prover import _dummy_tx_inputs
        from ..r1cs.circuits import synthesize_batch_process_tx
        b, d = (int(v) for v in which.split(":")[1].split(","))
        res = synthesize_batch_process_tx(_dummy_tx_inputs(b, d), b, d,
                                          check=False)
        return res.r1cs, res.witness, res.public_signals
    raise ValueError(f"unknown circuit {which!r}: toy, withdraw or "
                     "batch:B,D")


def mesh_of(n: int, dev: torch.device):
    """The visible cards when there are n of them and dev is a card, else
    a virtual mesh of n shards of dev."""
    from ..dist.mesh import make_mesh
    if dev.type == "cuda" and torch.cuda.device_count() >= n:
        return make_mesh(n)
    return make_mesh(n, device=dev)


def run(which: str, n_devices: int, device, log=print) -> str:
    """The check; returns the backend of the single proof, raises unless
    the mesh proof verifies and equals it."""
    from ..groth16.prove import prove, prove_host
    from ..groth16.setup import setup
    from ..groth16.verify import verify
    from ..native import engine

    dev = common.device(str(device))
    r1cs, witness, publics = build(which)
    log(f"{which}: n_vars={r1cs.n_vars} n_cons={r1cs.n_constraints}")
    pk = setup(r1cs, seed=b"mesh-check", device=dev)
    mesh = mesh_of(n_devices, dev)
    t0 = time.perf_counter()
    pd = prove(pk, r1cs, witness, r=3, s=5, mesh=mesh)
    common.sync(dev)
    log(f"mesh prove on {mesh}: {time.perf_counter() - t0:.1f} s")
    if not verify(pk.vk, pd, publics):
        raise AssertionError("the mesh proof does not verify")
    backend = "host" if engine.available() else "device"
    ps = (prove_host(pk, r1cs, witness, r=3, s=5) if backend == "host"
          else prove(pk, r1cs, witness, r=3, s=5, device=dev))
    if (pd.a, pd.b, pd.c) != (ps.a, ps.b, ps.c):
        raise AssertionError(f"the mesh proof differs from the {backend} "
                             "proof")
    return backend


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--circuit", default="toy")
    ap.add_argument("--devices", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = common.device(args.device)
    backend = run(args.circuit, args.devices, dev,
                  log=lambda m: print(m, flush=True))
    print(f"MESH {args.circuit.upper()} OK (bit-identical vs {backend})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
