"""Sharded batched solves over ``torch.distributed`` (``rbdtpu.distrib``):
the process mesh, sharding helpers, the sharded rollouts, DDP solves and
population-sharded MPPI update, and the launcher
(``python -m rbdtpu_torch.distrib.launch``)."""
from .mesh import Mesh, make_mesh, replicate, shard_batch
from .sharded import sharded_ddp_solve, sharded_mppi_step, sharded_rollouts

__all__ = [
    "Mesh", "make_mesh", "shard_batch", "replicate",
    "sharded_rollouts", "sharded_ddp_solve", "sharded_mppi_step",
]
