"""Node ↔ aggregate bidirectional map.

Reference ``Partition`` (partitioners/mod.rs:24-216): stores
``node_to_agg`` and per-aggregate node sets, with singleton construction,
bijection validation, and summary stats.  Here the canonical storage is a single ``node_to_agg`` numpy array
(aggregate node lists are derived on demand) — simpler and faster for the
array-style algorithms downstream.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np


@dataclasses.dataclass(frozen=True)
class PartitionStats:
    """reference ``PartitionStats`` (partitioners/mod.rs:160-199)."""

    num_aggs: int
    num_nodes: int
    coarsening_factor: float
    min_agg_size: int
    max_agg_size: int
    avg_agg_size: float

    def __str__(self):
        return (
            f"aggs={self.num_aggs} nodes={self.num_nodes} "
            f"cf={self.coarsening_factor:.2f} "
            f"size(min/avg/max)={self.min_agg_size}/"
            f"{self.avg_agg_size:.1f}/{self.max_agg_size}"
        )


class Partition:
    """Immutable partition of n nodes into contiguous aggregate ids 0..k-1."""

    def __init__(self, node_to_agg):
        node_to_agg = np.asarray(node_to_agg, dtype=np.int64)
        # renumber aggregates to be contiguous 0..k-1, ordered by first
        # appearance of each aggregate id (stable)
        _, first_idx, inverse = np.unique(
            node_to_agg, return_index=True, return_inverse=True
        )
        rank = np.argsort(np.argsort(first_idx))
        self.node_to_agg = rank[inverse].astype(np.int64)
        self.num_aggs = int(inverse.max(initial=-1)) + 1
        self.num_nodes = len(node_to_agg)

    @staticmethod
    def singleton(n: int) -> "Partition":
        """Every node its own aggregate (reference mod.rs:60)."""
        return Partition(np.arange(n))

    def agg_sizes(self) -> np.ndarray:
        return np.bincount(self.node_to_agg, minlength=self.num_aggs)

    def agg_lists(self) -> List[np.ndarray]:
        """Nodes per aggregate, each sorted ascending."""
        order = np.argsort(self.node_to_agg, kind="stable")
        sizes = self.agg_sizes()
        return np.split(order, np.cumsum(sizes)[:-1])

    def validate(self) -> None:
        """Bijection sanity check (reference mod.rs:144-158)."""
        if self.num_nodes == 0:
            return
        sizes = self.agg_sizes()
        if (sizes == 0).any():
            raise ValueError("empty aggregate after renumbering (bug)")
        if sizes.sum() != self.num_nodes:
            raise ValueError("partition does not cover all nodes")

    def expand_blocks(self, block_size: int) -> "Partition":
        """Lift a partition of block-nodes to a partition of scalar dofs
        (reference builds partitions on block-contracted graphs,
        partitioners/mod.rs:294-301, then aggregates carry whole blocks)."""
        if block_size == 1:
            return self
        return Partition(np.repeat(self.node_to_agg, block_size))

    def info(self) -> PartitionStats:
        sizes = self.agg_sizes()
        empty = len(sizes) == 0
        return PartitionStats(
            num_aggs=self.num_aggs,
            num_nodes=self.num_nodes,
            coarsening_factor=self.num_nodes / max(self.num_aggs, 1),
            min_agg_size=0 if empty else int(sizes.min()),
            max_agg_size=0 if empty else int(sizes.max()),
            avg_agg_size=0.0 if empty else float(sizes.mean()),
        )

    def __repr__(self):
        return f"Partition({self.info()})"
