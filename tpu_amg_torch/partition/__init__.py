"""Graph partitioning for aggregation-based coarsening.

Host-side setup algorithms (reference src/partitioners/*): the Partition
node↔aggregate map, the affinity strength-of-connection graph, the
modularity-maximizing greedy partitioner and its multilevel (staged)
form.
"""

from tpu_amg_torch.partition.modularity import (
    ModularityPartitioner,
    PartitionerConfig,
    build_partition,
)
from tpu_amg_torch.partition.multilevel import MultilevelPartitionerConfig
from tpu_amg_torch.partition.partition import Partition, PartitionStats
from tpu_amg_torch.partition.strength import Graph, strength_graph

__all__ = [
    "Partition",
    "PartitionStats",
    "strength_graph",
    "Graph",
    "ModularityPartitioner",
    "PartitionerConfig",
    "build_partition",
    "MultilevelPartitionerConfig",
]
