"""Data parallelism on ``torch.distributed`` (counterpart of
``ab_opt_tpu/parallel``): the train step over ranks, the sharded sampling
fan-out and the multi-process wiring."""
from .mesh import (
    make_mesh,
    auto_mesh_for_batch,
    shard_batch,
    replicate,
    replicate_batch,
    sharded_sample_fn,
    sharded_train_step,
)
from .distributed import (
    Mesh,
    assert_replicated_params_equal,
    init_distributed,
    global_mesh,
    world_mesh,
    host_batch_slice,
    global_batch_from_host_shards,
)

__all__ = [k for k in dir() if not k.startswith('_')]
