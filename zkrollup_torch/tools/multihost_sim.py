"""Two processes over the loopback: the port's mesh across processes.

    python -m zkrollup_torch.tools.multihost_sim [--device cpu|cuda:0]
                                                 [--backend gloo|nccl]

The counterpart of tools/multihost_sim.py. The parent picks a free port
on 127.0.0.1 and starts two processes; each joins one torch.distributed
group (dist/launch.py:init_distributed) and drives two shards of a global
mesh of four (make_mesh(2, device=...)). Each then checks, against host
ints, only what it holds:
  1. an all-reduce across the processes;
  2. the four-step sharded NTT of 16 elements (all_gather), its blocks;
  3. the relayout back to cyclic rows (all_to_all) and the inverse NTT,
     the input's blocks;
  4. a sharded G1 MSM of 8 points (the gather of the partials), the sum.
The parent prints each process's lines and `MULTIHOST OK` when both exit
0, and exits non-zero otherwise.

gloo moves CPU tensors only, so on a CUDA device the mesh stages its
exchanges through host memory (a line says so); the arithmetic stays on
the card. NCCL refuses two ranks on one card: with --backend nccl and a
CUDA device, rank r takes cuda:r, so it needs two cards.
"""

from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys

N_PROC = 2
LOCAL_SHARDS = 2
TIMEOUT_S = 300


def child(rank: int, port: int, device: str, backend: str) -> int:
    import torch
    torch.set_num_threads(1)
    from zkrollup_torch.dist.launch import init_distributed
    init_distributed(f"127.0.0.1:{port}", N_PROC, rank, backend=backend)
    import torch.distributed as dist
    from zkrollup_torch.curve.g1 import G1, pack_affine_host, to_affine_host
    from zkrollup_torch.dist.mesh import (blocked_to_cyclic, cyclic_shard,
                                          make_mesh, sharded_msm_g1,
                                          sharded_ntt)
    from zkrollup_torch.fields import limbs as L
    from zkrollup_torch.fields.mont import FR
    from zkrollup_torch.ntt.ntt import domain_root
    from zkrollup_torch.ref import bn254 as ref

    dev = torch.device(device)
    if backend == "nccl" and dev.type == "cuda":
        dev = torch.device("cuda", rank)
    mesh = make_mesh(LOCAL_SHARDS, device=dev)
    d = mesh.size
    assert d == N_PROC * LOCAL_SHARDS, mesh
    if mesh.staged:
        print(f"rank {rank}: {backend} moves CPU tensors only: the mesh's "
              "exchanges are staged through host memory", flush=True)

    # 1: all-reduce of the shard indices
    t = torch.tensor([sum(mesh.shard_ids())], dtype=torch.int64, device=dev)
    buf = t.cpu() if mesh.staged else t
    dist.all_reduce(buf)
    assert int(buf.item()) == sum(range(d)), int(buf.item())

    # 2: the sharded NTT across both processes; each checks its blocks
    log_n, n = 4, 16
    l = n // d
    vals = [(7 * i + 3) % 97 for i in range(n)]
    x = L.to_device(FR.to_mont_host(vals), dev)
    out = sharded_ntt(mesh, cyclic_shard(x, d), log_n)
    w = domain_root(log_n)
    want = [sum(v * pow(w, i * j, FR.p) for j, v in enumerate(vals)) % FR.p
            for i in range(n)]
    for g, blk in zip(mesh.shard_ids(), out):
        got = FR.from_mont_host(blk.cpu().numpy())
        assert got == want[g * l:(g + 1) * l], (rank, g, got)

    # 3: the relayout (all_to_all) and the inverse: the input's blocks
    back = sharded_ntt(mesh, blocked_to_cyclic(mesh, out), log_n,
                       inverse=True)
    for g, blk in zip(mesh.shard_ids(), back):
        got = FR.from_mont_host(blk.cpu().numpy())
        assert got == vals[g * l:(g + 1) * l], (rank, g, got)

    # 4: a sharded G1 MSM: the gather of the shards' window sums
    ks = [3 + 5 * i for i in range(2 * d)]
    ss = [11 + 13 * i for i in range(2 * d)]
    pts = [ref.g1_mul(ref.G1_GEN, k) for k in ks]
    res = sharded_msm_g1(mesh, pack_affine_host(pts), L.ints_to_limbs(ss),
                         c=4, n_bits=16)
    got = to_affine_host(G1.map(lambda a: a.reshape(1, L.N_LIMBS), res))[0]
    assert got == ref.g1_mul(ref.G1_GEN, sum(k * s for k, s in
                                             zip(ks, ss))), rank
    print(f"rank {rank}: all-reduce, sharded NTT blocks, relayout and "
          f"inverse, sharded MSM verified on {dev} ({backend}, shards "
          f"{list(mesh.shard_ids())} of {d})", flush=True)
    dist.destroy_process_group()
    return 0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def parent(device: str, backend: str) -> int:
    port = _free_port()
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [root] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "zkrollup_torch.tools.multihost_sim",
         "--rank", str(r), "--port", str(port), "--device", device,
         "--backend", backend],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env) for r in range(N_PROC)]
    rc = 0
    for r, p in enumerate(procs):
        try:
            out, _ = p.communicate(timeout=TIMEOUT_S)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
            out += f"\nrank {r}: killed after {TIMEOUT_S} s"
        print(out.rstrip(), flush=True)
        rc |= p.returncode != 0
    if rc == 0:
        print("MULTIHOST OK", flush=True)
    else:
        print(f"multihost sim failed (exit codes "
              f"{[p.returncode for p in procs]})", flush=True)
    return rc


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda:0",
                    help="the device of each process's shards (cpu, cuda:0)")
    ap.add_argument("--backend", default="nccl", choices=("gloo", "nccl"))
    ap.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.rank is not None:
        return child(a.rank, a.port, a.device, a.backend)
    return parent(a.device, a.backend)


if __name__ == "__main__":
    sys.exit(main())
