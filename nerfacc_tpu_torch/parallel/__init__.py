"""Data-parallel training and rendering over ``torch.distributed`` ranks.

Port of ``nerfacc_tpu/parallel/``: the same 13 public names.  One process
drives one device; rays shard over the ranks, parameters, optimizer state
and the occupancy grid are replicated, and the ranks meet only in
``all_reduce`` and ``broadcast`` (NCCL on cards, gloo on the CPU).
"""

from .mesh import (
    data_sharding,
    make_mesh,
    replicate,
    replicated_sharding,
    shard_rays,
)
from .multihost import (
    host_local_rays_to_global,
    initialize_distributed,
    make_hybrid_mesh,
    process_local_batch_size,
)
from .train import (
    make_parallel_occ_update,
    make_parallel_propnet_train_step,
    make_parallel_test_renderer,
    make_parallel_train_step,
)

__all__ = [
    "make_parallel_propnet_train_step",
    "make_parallel_test_renderer",
    "make_mesh",
    "shard_rays",
    "replicate",
    "data_sharding",
    "replicated_sharding",
    "make_parallel_train_step",
    "make_parallel_occ_update",
    "initialize_distributed",
    "make_hybrid_mesh",
    "host_local_rays_to_global",
    "process_local_batch_size",
]
