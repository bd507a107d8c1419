"""Process groups and the ('data', 'model') mesh (port of
flowerdiff/parallel/mesh.py).

The reference's mesh is one controller over every device, and GSPMD
inserts the collectives. Here every rank is a process (torchrun's), the
mesh is a `torch.distributed.device_mesh.DeviceMesh` with the dims
("data", "model") over the world, and the collectives are written out:

  - `local_rows`: this rank's rows of a global batch, contiguous blocks
    along "data" (the reference's `data_sharding`); ranks that differ only
    in their "model" coordinate take the same rows;
  - `broadcast_from_rank0`: the initial state, replicated from rank 0 (the
    reference's `replicated`);
  - `all_reduce_mean` / `all_reduce_sum`: a list of tensors over the "data"
    group, in place, through one flat buffer a dtype;
  - `all_gather_rows`: the rows of every "data" rank, in rank order.

`None` is the one-process 1x1 mesh: every helper is then the identity, which
is how the runner spells "single chip". A gloo group over CUDA tensors
(two ranks on one card, where NCCL refuses) stages each collective through
a host copy of its buffer.
"""
from __future__ import annotations

import os
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"
TORCHRUN = ("torchrun --nproc_per_node {n} -m flowerdiff_torch.cli --mesh_data {data} "
            "--mesh_model {model} ...")


def init_distributed(backend: Optional[str] = None) -> int:
    """Join the process group that torchrun's environment (RANK,
    WORLD_SIZE, LOCAL_RANK, MASTER_ADDR / MASTER_PORT) describes, and
    return the world size; without WORLD_SIZE nothing is joined (1). The
    backend is NCCL unless the caller names another (gloo for the CPU);
    under NCCL the rank's device is cuda:LOCAL_RANK. A group that is
    already up is kept as it is."""
    if dist.is_initialized():
        return dist.get_world_size()
    env = os.environ
    if "WORLD_SIZE" not in env:
        return 1
    backend = backend or "nccl"
    rank, world = int(env["RANK"]), int(env["WORLD_SIZE"])
    if backend == "nccl":
        torch.cuda.set_device(int(env.get("LOCAL_RANK", 0)))
    dist.init_process_group(backend, init_method="env://", rank=rank, world_size=world)
    return world


def create_mesh(data: Optional[int] = None, model: int = 1, device_type: Optional[str] = None):
    """A DeviceMesh of shape (data, model) over the world's ranks, dims
    ("data", "model"). `data=None` absorbs the ranks `model` leaves; a
    shape whose product is not the world size raises. Without a process
    group, 1x1 gives None (one process) and a larger shape raises, naming
    the torchrun command that runs it. device_type: the mesh's device
    (default: cuda under NCCL, else cpu)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if not dist.is_initialized() and (data or 1) * model > 1:
        n = (data or 1) * model
        raise ValueError(f"a mesh of {n} processes needs torchrun's processes, e.g. "
                         + TORCHRUN.format(n=n, data=data or 1, model=model))
    if data is None:
        if world % model:
            raise ValueError(f"{world} ranks are not divisible by model={model}")
        data = world // model
    if data * model != world:
        raise ValueError(f"mesh {data}x{model} != {world} ranks")
    if not dist.is_initialized():
        return None
    from torch.distributed.device_mesh import init_device_mesh

    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (data, model), mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


def mesh_size(mesh) -> int:
    """Every rank of the mesh (1 for None)."""
    return 1 if mesh is None else mesh.size()


def data_size(mesh) -> int:
    return 1 if mesh is None else mesh.size(0)


def data_rank(mesh) -> int:
    return 0 if mesh is None else mesh.get_local_rank(DATA_AXIS)


def is_writer() -> bool:
    """True on the rank that writes files and logs: rank 0, or the only
    process."""
    return not dist.is_initialized() or dist.get_rank() == 0


def barrier() -> None:
    """Wait for every rank of the world (nothing to wait for in one process)."""
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


def local_rows(mesh, x):
    """This rank's rows of `x`, a global batch along dim 0: the contiguous
    block of the rank's "data" coordinate. `x` may be None, or a tuple or
    list (a named tuple too) of such, e.g. one step's draws."""
    n = data_size(mesh)
    if x is None or n == 1:
        return x
    if isinstance(x, (tuple, list)):
        parts = [local_rows(mesh, v) for v in x]
        return type(x)(*parts) if hasattr(x, "_fields") else type(x)(parts)
    if x.shape[0] % n:
        raise ValueError(f"a batch of {x.shape[0]} rows does not split over {n} data ranks")
    b = x.shape[0] // n
    r = data_rank(mesh)
    return x[r * b:(r + 1) * b]


def _staged(group, t: torch.Tensor) -> torch.Tensor:
    """The tensor a collective of `group` runs on: a host copy where gloo
    meets a CUDA tensor, else `t` itself."""
    if t.is_cuda and dist.get_backend(group) == "gloo":
        return t.cpu()
    return t


def _flat_reduce(mesh, tensors: Sequence[torch.Tensor], mean: bool) -> List[torch.Tensor]:
    """The reduction runs on one flat buffer a dtype, and the results are
    copied back into the given tensors: views into the buffer would start
    at offsets that are not 16-byte aligned, where CUDA's foreach kernels
    (the optimizer's norm) take their unvectorised path and sum in another
    order, so world size 1 would part from no group at all."""
    tensors = list(tensors)
    if mesh is None:
        return tensors
    group, n = mesh.get_group(DATA_AXIS), data_size(mesh)
    for dtype in dict.fromkeys(t.dtype for t in tensors):
        picks = [t for t in tensors if t.dtype == dtype]
        flat = torch.cat([t.reshape(-1) for t in picks])
        buf = _staged(group, flat)
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
        if buf is not flat:
            flat.copy_(buf)
        if mean:
            flat /= n
        torch._foreach_copy_(picks, [p.view(t.shape) for p, t in
                                     zip(torch.split(flat, [t.numel() for t in picks]), picks)])
    return tensors


def all_reduce_sum(mesh, tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Each tensor, in place, the sum of its counterparts over the "data"
    group; returns them."""
    return _flat_reduce(mesh, tensors, mean=False)


def all_reduce_mean(mesh, tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Each tensor, in place, the mean of its counterparts over the "data"
    group (the sum over the group, divided by its size); returns them."""
    return _flat_reduce(mesh, tensors, mean=True)


def all_gather_rows(mesh, x: torch.Tensor) -> torch.Tensor:
    """Every "data" rank's `x` stacked along dim 0 in rank order: the
    global batch again."""
    if mesh is None or data_size(mesh) == 1:
        return x
    group = mesh.get_group(DATA_AXIS)
    buf = _staged(group, x.contiguous())
    parts = [torch.empty_like(buf) for _ in range(data_size(mesh))]
    dist.all_gather(parts, buf, group=group)
    return torch.cat(parts).to(x.device)


def broadcast_from_rank0(tensors: Sequence[torch.Tensor]) -> None:
    """Overwrite every tensor in place with rank 0's (the whole world);
    nothing to do in one process."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return
    tensors = list(tensors)
    for dtype in dict.fromkeys(t.dtype for t in tensors):
        picks = [t for t in tensors if t.dtype == dtype]
        flat = torch.cat([t.reshape(-1) for t in picks])
        buf = _staged(None, flat)
        dist.broadcast(buf, src=0)
        flat.copy_(buf)
        torch._foreach_copy_(picks, [p.view(t.shape) for p, t in
                                     zip(torch.split(flat, [t.numel() for t in picks]), picks)])
