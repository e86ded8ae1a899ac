"""Meshes, sharding and the train step (mirrors ``dmme_tpu.parallel``):
data, fsdp, expert, tensor and spatial parallelism over ``torch.distributed``."""

from dmme_tpu_torch.parallel.distributed import global_batch, initialize, shutdown
from dmme_tpu_torch.parallel.mesh import (
    batch_sharding,
    fsdp_param_spec,
    make_mesh,
    params_sharding,
    replicated,
    state_sharding,
)
from dmme_tpu_torch.parallel.spatial import SpatialGroup
from dmme_tpu_torch.parallel.train_step import (
    global_norm,
    make_eval_step,
    make_train_chunk,
    make_train_step,
    shard_batch,
    shard_state,
)

__all__ = [
    "make_mesh",
    "batch_sharding",
    "replicated",
    "params_sharding",
    "state_sharding",
    "fsdp_param_spec",
    "make_train_step",
    "make_train_chunk",
    "make_eval_step",
    "shard_state",
    "shard_batch",
    "global_norm",
    "initialize",
    "global_batch",
    "shutdown",
    "SpatialGroup",
]
