"""Greedy modularity-maximizing graph partitioner.

Reference ``Partitioner`` (partitioners/modularity.rs): graph coarsening
as greedy modularity clustering with an aggregate-size penalty.

Phase 1 — ``initialize_partition`` (modularity.rs:179-192): repeat
heaviest-first greedy pairwise matching until the target coarsening
factor; match score for edge (i,j) is

    strength(i,j) − rowsumᵢ·rowsumⱼ/T  ±  agg_pen·(newsize − cf)²

(+ when newsize ≤ cf, − when above; modularity.rs:305-337).  After each
round the strength graph is contracted (duplicate edges summed) and
rowsums/sizes merged.

Phase 2 — ``improve_partition`` (modularity.rs:437-510): ≤ max passes;
each pass computes the best positive-Δq move per node over the *fine*
strength graph,

    Δq = (out_degree − in_degree)
         + agg_pen·(size_cost(old src)+size_cost(old dst)
                    − size_cost(new src) − size_cost(new dst)),
    size_cost(s) = (4·|s−cf|/cf)⁴ · agg_size_penalty      (modularity.rs:385-389)

(the penalty deliberately enters twice, matching the reference), then
applies moves greedily by gain with node/aggregate conflict freezing
including 1-hop neighbors (modularity.rs:477-504).  Singleton aggregates
cannot be vacated (modularity.rs:448-452).

Matching, move scoring and the conflict-resolving move application run
in the native C++ kernels (:mod:`tpu_amg_torch.ops.native`).
"""

from __future__ import annotations

import dataclasses
import logging

import numpy as np
import scipy.sparse as sps

from tpu_amg_torch.ops import native
from tpu_amg_torch.partition.partition import Partition
from tpu_amg_torch.partition.strength import Graph, strength_graph

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class PartitionerConfig:
    """Reference ``PartitionerConfig`` defaults (partitioners/mod.rs:257-265)."""

    coarsening_factor: float = 8.0
    agg_size_penalty: float = 1.0
    max_improvement_iters: int = 100
    max_depth: int = 3  # strength-graph BFS depth (mod.rs:290)
    # split disconnected aggregates after improvement (the reference
    # knowingly leaves them — modularity.rs:440 "This can break
    # aggregates into disconnected components... not great"; scattered
    # aggregates widen P and densify the Galerkin coarse operators)
    split_disconnected: bool = True
    # hard floor on aggregate size: aggregates below it are merged into
    # their strongest-connected neighbor.  SA sets this to the candidate
    # dimension (the per-aggregate SVD needs agg_size*block_size >= cd;
    # the reference instead panics on too-small aggregates,
    # interpolation/mod.rs:756-761)
    min_agg_size: int = 0
    # stop the local-move improvement once a pass's total modularity
    # gain drops below this fraction of the FIRST pass's gain: the tail
    # of the loop finds ever-tinier rearrangements (262k Delaunay:
    # ~87 passes x 46 ms of native move-scoring = 16 s of the 58 s
    # setup) with no measurable effect on aggregate quality or solve
    # iterations.  0 restores the reference's fixed-iteration behavior.
    improvement_tol: float = 1e-3

    def build(self, a, near_null, nn_weights) -> "ModularityPartitioner":
        """Reference PartitionerConfig::build (mod.rs:273-309).

        Builds the strength graph on the scalar matrix, contracts by
        dense block if ``a.block_size > 1`` (so aggregates carry whole
        blocks), then runs greedy init + improvement.  The resulting
        partition is over *block nodes*; use
        ``Partition.expand_blocks(a.block_size)`` for scalar dofs.
        """
        graph = strength_graph(a, near_null, nn_weights, self.max_depth)
        bs = a.block_size
        if bs > 1:
            node_to_block = np.arange(a.nrows) // bs
            graph = graph.contract(node_to_block, a.nrows // bs)
        part = ModularityPartitioner(graph, self)
        part.initialize_partition()
        part.improve_partition()
        return part

    def build_partition(self, a, near_null, nn_weights) -> Partition:
        """Reference build_partition (mod.rs:320-328)."""
        return self.build(a, near_null, nn_weights).partition


class ModularityPartitioner:
    """Stateful two-phase partitioner (host-side setup algorithm)."""

    def __init__(self, graph: Graph, config: PartitionerConfig):
        n = graph.n
        self.config = config
        self.base_graph = graph  # fine graph (for improvement)
        self.graph = graph  # coarsened during matching
        self.base_row_sums = graph.row_sums()
        self.inverse_total = 1.0 / max(self.base_row_sums.sum(), 1e-300)
        self.node_weights = np.ones(n, dtype=np.int64)
        self.partition = Partition.singleton(n)
        self.row_sums = self.base_row_sums.copy()
        self.agg_sizes = self.node_weights.copy()

    # ------------------------------------------------------------------
    # Phase 1: greedy matching until target coarsening factor
    # ------------------------------------------------------------------
    def initialize_partition(self):
        cf = self.config.coarsening_factor
        while self.partition.num_nodes / self.partition.num_aggs < cf:
            pairs, unmatched = self._greedy_matching(cf)
            if len(pairs) == 0:
                achieved = self.partition.num_nodes / self.partition.num_aggs
                logger.warning(
                    "greedy partitioner stalled: target cf %.2f achieved %.2f",
                    cf,
                    achieved,
                )
                break
            self._apply_matching(pairs, unmatched)

    def _match_scores(self):
        """Modularity match score per current-graph edge with i > j
        (reference generate_modularity_triplets, modularity.rs:305-337)."""
        rows, cols, w = self.graph.edges()
        mask = rows > cols
        rows, cols, w = rows[mask], cols[mask], w[mask]
        expected = self.inverse_total * self.row_sums[rows] * self.row_sums[cols]
        score = w - expected
        cf = self.config.coarsening_factor
        new_size = (self.agg_sizes[rows] + self.agg_sizes[cols]).astype(np.float64)
        sq = (new_size - cf) ** 2
        pen = self.config.agg_size_penalty
        score = np.where(new_size > cf, score - pen * sq, score + pen * sq)
        return rows, cols, score

    def _greedy_matching(self, step_cf: float):
        """Serial heaviest-first matching (modularity.rs:339-383)."""
        vertex_count = self.partition.num_aggs
        target = (
            int(np.ceil(vertex_count - self.partition.num_nodes / step_cf)) + 1
        )
        rows, cols, score = self._match_scores()
        if len(rows) == 0:
            return [], np.arange(vertex_count)
        order = np.argsort(-score, kind="stable")
        pairs = native.greedy_match(
            rows[order], cols[order], vertex_count, target
        )
        alive = np.ones(vertex_count, dtype=bool)
        alive[pairs.reshape(-1)] = False
        return pairs, np.flatnonzero(alive)

    def _apply_matching(self, pairs, unmatched):
        vertex_count = self.partition.num_aggs
        old_to_new = np.empty(vertex_count, dtype=np.int64)
        pairs = np.asarray(pairs, dtype=np.int64)
        npairs = len(pairs)
        old_to_new[pairs[:, 0]] = np.arange(npairs)
        old_to_new[pairs[:, 1]] = np.arange(npairs)
        old_to_new[unmatched] = npairs + np.arange(len(unmatched))
        n_new = npairs + len(unmatched)

        # contract graph (sums duplicate edges; keeps self-loops out of
        # matching because _match_scores filters i > j only off-diagonal —
        # mirror reference merge, which keeps self-loops but never matches
        # them). NOTE: contract() drops self-loops entirely, which is
        # equivalent for matching and rowsums are tracked separately.
        rows, cols, w = self.graph.edges()
        new_adj = sps.coo_matrix(
            (w, (old_to_new[rows], old_to_new[cols])), shape=(n_new, n_new)
        ).tocsr()
        new_adj.sum_duplicates()
        new_adj.setdiag(0.0)
        new_adj.eliminate_zeros()
        self.graph = Graph(adj=new_adj)

        # merge rowsums (pairwise_merge_rowsums, modularity.rs:293-303)
        new_row_sums = np.empty(n_new)
        new_row_sums[:npairs] = (
            self.row_sums[pairs[:, 0]] + self.row_sums[pairs[:, 1]]
        )
        new_row_sums[npairs:] = self.row_sums[unmatched]
        self.row_sums = new_row_sums

        # merge partition (fine nodes → new agg ids)
        self.partition = Partition(old_to_new[self.partition.node_to_agg])
        self.agg_sizes = np.bincount(
            self.partition.node_to_agg,
            weights=self.node_weights,
            minlength=self.partition.num_aggs,
        ).astype(np.int64)

    # ------------------------------------------------------------------
    # Phase 2: local-move refinement
    # ------------------------------------------------------------------
    def _best_moves(self):
        """Best positive-Δq move per node (modularity.rs:391-467), one
        native O(E) pass."""
        adj = self.base_graph.adj
        return native.best_moves(
            adj.indptr, adj.indices, adj.data,
            self.partition.node_to_agg, self.agg_sizes,
            self.node_weights, self.config.coarsening_factor,
            self.config.agg_size_penalty,
        )

    def _apply_move_batch(self, nodes, dests, indptr, indices, node_to_agg):
        """Apply gain-sorted moves with node/aggregate conflict freezing
        incl. 1-hop neighbours (modularity.rs:477-504). Mutates
        ``node_to_agg`` and ``self.agg_sizes``; returns swap count."""
        agg_sizes = np.ascontiguousarray(self.agg_sizes, np.int64)
        swaps = native.apply_moves(
            nodes, dests, indptr, indices, self.node_weights,
            node_to_agg, agg_sizes,
        )
        self.agg_sizes = agg_sizes
        return swaps

    def improve_partition(self):
        indptr = self.base_graph.adj.indptr
        indices = self.base_graph.adj.indices
        node_to_agg = self.partition.node_to_agg.copy()
        dq_first = None
        for it in range(self.config.max_improvement_iters):
            self.partition = Partition(node_to_agg)
            node_to_agg = self.partition.node_to_agg.copy()
            self.agg_sizes = np.bincount(
                node_to_agg, weights=self.node_weights,
                minlength=self.partition.num_aggs,
            ).astype(np.int64)
            mi, mt, dq = self._best_moves()
            if len(mi) == 0:
                break
            order = np.argsort(-dq, kind="stable")
            swaps = self._apply_move_batch(
                mi[order], mt[order], indptr, indices, node_to_agg
            )
            logger.debug("improvement pass %d: %d swaps", it, swaps)
            dq_total = float(dq.sum())
            if dq_first is None:
                dq_first = max(dq_total, 1e-300)
            elif dq_total < self.config.improvement_tol * dq_first:
                logger.debug(
                    "improvement converged after %d passes "
                    "(gain %.2e < %.0e of first pass)",
                    it + 1, dq_total, self.config.improvement_tol,
                )
                break
        self.partition = Partition(node_to_agg)
        if self.config.split_disconnected:
            self.partition = self._split_disconnected(self.partition)
        if self.config.min_agg_size > 1:
            self.partition = self._enforce_min_size(
                self.partition, int(self.config.min_agg_size)
            )
        if self.config.split_disconnected or self.config.min_agg_size > 1:
            self.agg_sizes = np.bincount(
                self.partition.node_to_agg, weights=self.node_weights,
                minlength=self.partition.num_aggs,
            ).astype(np.int64)

    def _split_disconnected(self, partition: Partition) -> Partition:
        """Repair disconnected aggregates with guaranteed connectivity:

        1. split every aggregate into its connected components over the
           intra-aggregate strength subgraph (each component is
           connected by construction);
        2. merge undersized components into the neighboring component
           they connect to most strongly, via union-find over real graph
           edges (a union of two connected components joined along an
           existing edge stays connected — so the invariant holds).
        """
        from scipy.sparse.csgraph import connected_components

        rows, cols, w = self.base_graph.edges()
        agg = partition.node_to_agg
        intra = agg[rows] == agg[cols]
        n = partition.num_nodes
        sub = sps.coo_matrix(
            (np.ones(int(intra.sum())), (rows[intra], cols[intra])),
            shape=(n, n),
        )
        n_comp, labels = connected_components(sub, directed=False)
        if n_comp == partition.num_aggs:
            return partition
        logger.debug(
            "splitting %d disconnected aggregate components",
            n_comp - partition.num_aggs,
        )

        min_size = max(2, int(np.ceil(self.config.coarsening_factor / 2.0)))
        return Partition(
            self._merge_small_labels(labels, rows, cols, w, min_size)
        )

    def _merge_small_labels(self, labels, rows, cols, w, min_size):
        """Merge every label-group smaller than ``min_size`` into the
        neighboring group it connects to most strongly (union-find over
        real graph edges, so merged groups stay connected)."""
        n_comp = int(labels.max(initial=-1)) + 1
        comp_sizes = np.bincount(labels, minlength=n_comp)
        small = comp_sizes < min_size
        if not small.any():
            return labels

        # strongest-connected neighboring component per small component
        lr, lc = labels[rows], labels[cols]
        mask = small[lr] & (lr != lc)
        key = lr[mask].astype(np.int64) * n_comp + lc[mask]
        uniq, inv = np.unique(key, return_inverse=True)
        acc = np.bincount(inv, weights=w[mask])
        src_c = uniq // n_comp
        dst_c = uniq % n_comp
        order = np.lexsort((-acc, src_c))
        first = np.ones(len(order), dtype=bool)
        so = src_c[order]
        first[1:] = so[1:] != so[:-1]
        merge_src = so[first]
        merge_dst = dst_c[order][first]

        # union-find along the chosen (existing-edge) merges
        parent = np.arange(n_comp)

        def find(x):
            while parent[x] != x:
                parent[x] = parent[parent[x]]
                x = parent[x]
            return x

        for s, d in zip(merge_src, merge_dst):
            rs, rd = find(int(s)), find(int(d))
            if rs != rd:
                parent[rs] = rd
        roots = np.array([find(int(c)) for c in range(n_comp)])
        return roots[labels]

    def _enforce_min_size(
        self, partition: Partition, min_size: int
    ) -> Partition:
        """Merge every aggregate below ``min_size`` nodes into its
        strongest-connected neighbor (iterated: merging two small
        aggregates can still be small).  Guarantees SA's per-aggregate
        SVD is well-posed without the reference's panic
        (interpolation/mod.rs:756-761)."""
        rows, cols, w = self.base_graph.edges()
        for _ in range(10):
            labels = partition.node_to_agg
            sizes = np.bincount(labels, minlength=partition.num_aggs)
            if (sizes >= min_size).all() or partition.num_aggs <= 1:
                return partition
            merged = Partition(
                self._merge_small_labels(labels, rows, cols, w, min_size)
            )
            if merged.num_aggs == partition.num_aggs:
                break  # isolated small aggregates with no outside edges
            partition = merged
        return partition
