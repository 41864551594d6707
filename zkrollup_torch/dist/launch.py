"""Multi-process bring-up of the port's mesh (torch.distributed).

Counterpart of zkrollup/dist/launch.py, whose init_distributed wires
jax.distributed's controller. Here each process joins one
torch.distributed process group over TCP; dist/mesh.py's make_mesh then
spans every process of it:

    from zkrollup_torch.dist.launch import init_distributed
    init_distributed("127.0.0.1:29500", num_processes=N, process_id=r)
    from zkrollup_torch.dist.mesh import make_mesh
    mesh = make_mesh()        # this process's cards: its share of them

The coordinator's address, the process count and this process's rank
are the caller's to give: nothing is read from the environment. With
every process on one host, make_mesh() gives rank r the cards r x n ..
r x n + n - 1 (n: the visible cards over the processes); processes on
several hosts pass make_mesh(n, local_rank=...). A virtual mesh names its
device: make_mesh(2, device="cuda:0").
zkrollup_torch/tools/multihost_sim.py runs two processes over the loopback.
"""

from __future__ import annotations

from typing import Optional

import torch.distributed as dist

BACKENDS = ("nccl", "gloo")


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: str = "nccl") -> None:
    """Join the process group of `num_processes` processes whose rank 0
    listens at `coordinator` ("host:port"); no-op for one process.
    backend: "nccl" for meshes of CUDA devices, one card a process (the
    default), or "gloo" for CPU meshes and for CUDA meshes whose
    exchanges dist/mesh.py then stages through host memory (gloo moves
    CPU tensors only; NCCL refuses two ranks on one card)."""
    if backend not in BACKENDS:
        raise ValueError(f"backend={backend!r}: must be one of {BACKENDS}")
    if not num_processes or num_processes <= 1:
        return
    if coordinator is None or process_id is None:
        raise ValueError("init_distributed: a multi-process run needs the "
                         "coordinator's address and this process's id")
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id)
