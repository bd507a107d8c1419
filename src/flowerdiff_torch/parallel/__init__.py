"""Multi-process parallelism (port of flowerdiff/parallel): the ('data',
'model') mesh over a torch.distributed process group, data parallelism with
its collectives written out, and Megatron tensor parallelism of the latent
denoiser."""
from flowerdiff_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    all_gather_rows,
    all_reduce_mean,
    all_reduce_sum,
    barrier,
    broadcast_from_rank0,
    create_mesh,
    data_rank,
    data_size,
    init_distributed,
    is_writer,
    local_rows,
    mesh_size,
)
from flowerdiff_torch.parallel.sharding import latent_denoiser_rules, shard_params

__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "all_gather_rows",
    "all_reduce_mean",
    "all_reduce_sum",
    "barrier",
    "broadcast_from_rank0",
    "create_mesh",
    "data_rank",
    "data_size",
    "init_distributed",
    "is_writer",
    "local_rows",
    "mesh_size",
    "latent_denoiser_rules",
    "shard_params",
]
