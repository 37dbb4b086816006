"""The dp x fsdp x tp mesh over torch.distributed (JAX counterpart:
sd3_tpu/parallel/). `MeshConfig` and `make_mesh` keep their names; the JAX
`param_sharding_rules` / `shard_params` are `ShardPlan` (the spec of each
leaf) and `TrainMesh` (the trainer's shards and collectives); a batch's
rows are `multihost.host_batch_slice` / `TrainMesh.rows` (no
`batch_sharding`, and no `replicated_sharding`: a leaf without a split is a
whole tensor on every rank)."""

from sd3_torch.parallel.mesh import MeshConfig, make_mesh
from sd3_torch.parallel.multihost import (host_batch_slice, initialize,
                                          is_main_process)
from sd3_torch.parallel.sharding import ShardPlan, TrainMesh, leaf_spec

__all__ = ["make_mesh", "MeshConfig", "ShardPlan", "TrainMesh", "leaf_spec",
           "initialize", "is_main_process", "host_batch_slice"]
