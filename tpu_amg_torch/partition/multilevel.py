"""Multilevel (recursive) partitioner for large coarsening factors.

The port of the JAX package's ``tpu_amg/partition/multilevel.py``.  The
reference declares this capability but never finished it
(partitioners/multilevel.rs is entirely commented out; dead references in
multigrid.rs:68-78 and the aggregation example show the intent): for a
large target coarsening factor (e.g. the 128-256 block-smoother
aggregates), run the modularity partitioner in stages — each stage
partitions the contracted graph of the previous one with a moderate
per-stage factor — and compose the stage partitions.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from tpu_amg_torch.partition.modularity import (
    ModularityPartitioner,
    PartitionerConfig,
)
from tpu_amg_torch.partition.partition import Partition
from tpu_amg_torch.partition.strength import strength_graph


@dataclasses.dataclass
class MultilevelPartitionerConfig:
    """Stage configs applied in sequence; the total coarsening factor is
    the product of the per-stage factors (reference multilevel.rs
    intent)."""

    partitioner_configs: List[PartitionerConfig]

    @staticmethod
    def even_stages(
        total_cf: float, n_stages: int = 2, **kwargs
    ) -> "MultilevelPartitionerConfig":
        """Split ``total_cf`` into n equal geometric stages (the
        commented-out reference scheme, multigrid.rs:68-78)."""
        per_stage = total_cf ** (1.0 / n_stages)
        return MultilevelPartitionerConfig(
            partitioner_configs=[
                PartitionerConfig(coarsening_factor=per_stage, **kwargs)
                for _ in range(n_stages)
            ]
        )

    def build_partition(
        self, a, near_null, nn_weights, callback=None
    ) -> Partition:
        """The composed fine-node → aggregate partition (over block nodes
        when a.block_size > 1); ``callback(stage, composed)``, when given,
        is called after each stage with the partition composed so far."""
        near_null = np.asarray(near_null, dtype=np.float64)
        if near_null.ndim == 1:
            near_null = near_null[:, None]
        graph = strength_graph(
            a, near_null, nn_weights, self.partitioner_configs[0].max_depth
        )
        bs = a.block_size
        if bs > 1:
            node_to_block = np.arange(a.nrows) // bs
            graph = graph.contract(node_to_block, a.nrows // bs)

        composed: Optional[Partition] = None
        for stage, cfg in enumerate(self.partitioner_configs):
            if graph.n <= 1:
                break
            part = ModularityPartitioner(graph, cfg)
            part.initialize_partition()
            part.improve_partition()
            stage_partition = part.partition
            composed = (
                stage_partition
                if composed is None
                else composed.compose(stage_partition)
            )
            if callback is not None:
                callback(stage, composed)
            graph = graph.contract(
                stage_partition.node_to_agg, stage_partition.num_aggs
            )
        composed.validate()
        return composed
