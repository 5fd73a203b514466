"""The process mesh (counterpart of `otter_tpu/parallel/mesh.py`): axes
("data", "fsdp", "seq", "tensor") over `torch.distributed` ranks, one rank
a device.

  - DDP        -> dp > 1 (with fsdp > 1 too: HSDP)
  - ZeRO-3     -> fsdp > 1 (`fully_shard` over data x fsdp)
  - tensor     -> tp > 1 (column- and row-parallel projections)
  - sequence   -> sp > 1 (self-attention runs as the ring,
                  `ops/ring_attention.py`)

Ranks that share a (data, fsdp) coordinate train on the same rows: the
seq and tensor ranks of one data rank see one batch. `mesh_shape` holds
the shape rules in plain arithmetic, `batch_rows` the rows a data rank
takes.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch.distributed as dist

from otter_tpu_torch.config import ParallelConfig
from otter_tpu_torch.device import resolve_device

DATA_AXIS = "data"
FSDP_AXIS = "fsdp"
SEQ_AXIS = "seq"
TENSOR_AXIS = "tensor"
MESH_AXES = (DATA_AXIS, FSDP_AXIS, SEQ_AXIS, TENSOR_AXIS)


def mesh_shape(cfg: Optional[ParallelConfig], n: int
               ) -> Tuple[int, int, int, int]:
    """(dp, fsdp, sp, tp) for `n` ranks: fsdp == -1 takes every rank that
    dp x sp x tp leaves. Raises JAX's two ValueErrors."""
    cfg = cfg or ParallelConfig()
    dp, fsdp, sp, tp = cfg.dp, cfg.fsdp, cfg.sp, cfg.tp
    if fsdp == -1:
        if n % (dp * sp * tp) != 0:
            raise ValueError(
                f"device count {n} not divisible by dp*sp*tp={dp * sp * tp}")
        fsdp = n // (dp * sp * tp)
    if dp * fsdp * sp * tp != n:
        raise ValueError(
            f"dp*fsdp*sp*tp={dp * fsdp * sp * tp} != {n} devices")
    return dp, fsdp, sp, tp


def create_mesh(cfg: Optional[ParallelConfig] = None, *, device=None):
    """The ("data", "fsdp", "seq", "tensor") DeviceMesh over every rank of
    the started process group. CUDA unless the caller names the CPU."""
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        raise RuntimeError("create_mesh: start the process group first "
                           "(parallel.distributed.init_distributed_device)")
    dev = resolve_device(device)
    shape = mesh_shape(cfg, dist.get_world_size())
    return init_device_mesh(dev.type, shape, mesh_dim_names=MESH_AXES)


def axis_size(mesh, axis: str) -> int:
    return 1 if mesh is None else mesh.size(MESH_AXES.index(axis))


def axis_group(mesh, axis: str):
    """The process group of this rank along `axis`, or None at extent 1."""
    if axis_size(mesh, axis) == 1:
        return None
    return mesh.get_group(axis)


def batch_sharding(mesh) -> Tuple[int, int]:
    """(data rank, data world): this rank's place along data x fsdp."""
    if mesh is None:
        return 0, 1
    d, f, _, _ = mesh.get_coordinate()
    fs = axis_size(mesh, FSDP_AXIS)
    return d * fs + f, axis_size(mesh, DATA_AXIS) * fs


def data_group(mesh):
    """The process group along data x fsdp, or None at extent 1."""
    if mesh is None or batch_sharding(mesh)[1] == 1:
        return None
    return mesh[DATA_AXIS, FSDP_AXIS]._flatten().get_group()


def batch_rows(n: int, rank: int, world: int) -> slice:
    """The rows of an n-row batch that data rank `rank` of `world` takes:
    its 1/world where `world` divides n, else every row (JAX's
    `shard_batch` replicates such a batch)."""
    if world <= 1 or n % world:
        return slice(None)
    per = n // world
    return slice(rank * per, (rank + 1) * per)


def shard_batch(mesh, tree):
    """This rank's rows of a global batch {name: array or tensor}: leaves
    with a leading batch dim are cut along it by `batch_rows`; 0-d leaves
    pass through."""
    rank, world = batch_sharding(mesh)

    def put(x):
        if getattr(x, "ndim", 0) >= 1:
            return x[batch_rows(x.shape[0], rank, world)]
        return x

    return {k: put(v) for k, v in tree.items()}


def local_mesh_for_testing(n: int = 8):
    """An fsdp-only CPU mesh over a started group of n gloo ranks."""
    if not dist.is_initialized() or dist.get_world_size() != n:
        raise RuntimeError(f"need a started process group of {n} ranks")
    return create_mesh(ParallelConfig(fsdp=n), device="cpu")
