"""Process bootstrap (counterpart of `otter_tpu/parallel/distributed.py`,
the reference's `pipeline/train/distributed.py:25-96`).

`world_info_from_env` reads the launcher conventions the JAX module reads,
in the same order (torchrun's LOCAL_RANK / RANK / WORLD_SIZE, then PMI,
SLURM and Open MPI). `init_distributed_device` starts
`torch.distributed` over them: NCCL with `cuda:<local rank>` unless the
caller asks for the CPU, gloo there. MASTER_ADDR / MASTER_PORT name the
rendezvous (the JAX module's coordinator address). A failed start raises;
nothing carries on at one rank.

    torchrun --nproc_per_node 4 -m otter_tpu_torch.train.sft --multi_host ...
"""

from __future__ import annotations

import datetime
import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from otter_tpu_torch.device import resolve_device


def world_info_from_env() -> Tuple[int, int, int]:
    """(local_rank, global_rank, world_size) from the environment."""
    local_rank = 0
    for v in ("LOCAL_RANK", "MPI_LOCALRANKID", "SLURM_LOCALID",
              "OMPI_COMM_WORLD_LOCAL_RANK"):
        if v in os.environ:
            local_rank = int(os.environ[v])
            break
    global_rank = 0
    for v in ("RANK", "PMI_RANK", "SLURM_PROCID", "OMPI_COMM_WORLD_RANK"):
        if v in os.environ:
            global_rank = int(os.environ[v])
            break
    world_size = 1
    for v in ("WORLD_SIZE", "PMI_SIZE", "SLURM_NTASKS",
              "OMPI_COMM_WORLD_SIZE"):
        if v in os.environ:
            world_size = int(os.environ[v])
            break
    return local_rank, global_rank, world_size


def distributed_device(device=None) -> torch.device:
    """This process's device: `cuda:<local rank>` unless the caller names
    the CPU (raises without CUDA, as `resolve_device` does)."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return torch.device("cuda", world_info_from_env()[0])
    return dev


def init_distributed_device(device=None, *,
                            timeout_s: Optional[float] = None
                            ) -> Tuple[int, int]:
    """Start the default process group (once) and return (rank, world).
    The rendezvous is MASTER_ADDR:MASTER_PORT; both must be set."""
    dev = distributed_device(device)
    _, rank, world = world_info_from_env()
    if not dist.is_initialized():
        missing = [v for v in ("MASTER_ADDR", "MASTER_PORT")
                   if v not in os.environ]
        if missing:
            raise RuntimeError(f"init_distributed_device: {missing} not set "
                               "(torchrun sets them; name the rendezvous "
                               "host and port otherwise)")
        kw = {}
        if timeout_s is not None:
            kw["timeout"] = datetime.timedelta(seconds=timeout_s)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
            kw["device_id"] = dev
        dist.init_process_group(
            "nccl" if dev.type == "cuda" else "gloo", init_method="env://",
            rank=rank, world_size=world, **kw)
    return dist.get_rank(), dist.get_world_size()


def mesh_from_args(args, device=None):
    """(mesh, device) of a trainer's --dp / --fsdp / --sp / --tp /
    --multi_host. With --multi_host, or WORLD_SIZE > 1, the process group
    starts and the mesh spans it (at one rank too); otherwise the mesh is
    None (one device) and any axis above 1 raises, as `create_mesh` does
    for a mesh that the ranks cannot fill."""
    from otter_tpu_torch.config import ParallelConfig
    from otter_tpu_torch.parallel.mesh import create_mesh, mesh_shape
    cfg = ParallelConfig(dp=args.dp, fsdp=args.fsdp,
                         sp=getattr(args, "sp", 1), tp=args.tp)
    if not (args.multi_host or world_info_from_env()[2] > 1):
        mesh_shape(cfg, 1)
        return None, resolve_device(device)
    init_distributed_device(device)
    dev = distributed_device(device)
    return create_mesh(cfg, device=dev), dev


def process_rank() -> int:
    """This process's rank (0 without a process group)."""
    return dist.get_rank() if dist.is_initialized() else 0
