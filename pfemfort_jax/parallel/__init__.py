from pfemfort_jax.parallel.partition import rcb_partition, greedy_graph_partition
from pfemfort_jax.parallel.shard import ShardedSystem, build_sharded_system
from pfemfort_jax.parallel.shard_cg import distributed_cg_solve

__all__ = [
    "rcb_partition",
    "greedy_graph_partition",
    "ShardedSystem",
    "build_sharded_system",
    "distributed_cg_solve",
]
