"""Graph partitioning for aggregation-based coarsening.

Host-side setup algorithms (reference src/partitioners/*): the Partition
node↔aggregate map, the affinity strength-of-connection graph, and the
modularity-maximizing greedy partitioner.
"""

from tpu_amg_torch.partition.modularity import (
    ModularityPartitioner,
    PartitionerConfig,
)
from tpu_amg_torch.partition.partition import Partition, PartitionStats
from tpu_amg_torch.partition.strength import Graph, strength_graph

__all__ = [
    "Partition",
    "PartitionStats",
    "strength_graph",
    "Graph",
    "ModularityPartitioner",
    "PartitionerConfig",
]
