"""Least-squares (affinity) strength-of-connection graph.

Reference ``AdjacencyList::new_ls_strength_graph``
(partitioners/mod.rs:337-393), as array passes over native kernels:

1. Neighbourhood: all pairs (i, j) within graph distance ≤ ``max_depth``
   of each other (depth default 3, mod.rs:290), by bounded BFS.
2. Affinity over the near-null candidates V (n×k) with diagonal weights
   W = diag(w):  ρ²ᵢⱼ = (vᵢᵀWvⱼ)² / ((vᵢᵀWvᵢ)(vⱼᵀWvⱼ)),
   distance dᵢⱼ = 2·√(max(0, 1−ρ²)) (mod.rs:352-359).
3. Per-node filter: keep the strongest (smallest-d) ⌊θ·len⌋ (≥1)
   neighbours, θ = 0.5 (mod.rs:345, 369-372).
4. Per-node contrast rescale: w = ((d_max−d)/(d_max−d_min+1e-12))^α with
   α = 4; all-equal rows get weight 1 (mod.rs:364-388).

The result is a *directed* weighted graph (each node keeps its own
filtered list, exactly like the reference's per-node adjacency lists).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sps

from tpu_amg_torch.ops import native
from tpu_amg_torch.sparse.csr import CSR

THETA = 0.5  # keep fraction (reference mod.rs:345)
ALPHA = 4.0  # contrast exponent (reference mod.rs:365)


@dataclasses.dataclass
class Graph:
    """Directed weighted adjacency in scipy CSR form; ``adj[i]`` holds
    node i's kept neighbour list (weights: larger = stronger)."""

    adj: sps.csr_matrix

    @property
    def n(self) -> int:
        return self.adj.shape[0]

    def row_sums(self) -> np.ndarray:
        """Strength degree per node, negatives clamped to 0 with the same
        semantics as the reference (modularity.rs:52-74)."""
        sums = np.asarray(self.adj.sum(axis=1)).ravel()
        return np.maximum(sums, 0.0)

    def edges(self):
        """(rows, cols, weights) of the directed edge list."""
        coo = self.adj.tocoo()
        return coo.row.astype(np.int64), coo.col.astype(np.int64), coo.data

    def contract(self, node_to_agg: np.ndarray, n_aggs: int) -> "Graph":
        """Aggregate nodes (reference AdjacencyList::aggregate,
        mod.rs:464-491): map endpoints, sum duplicate edges, normalize by
        the global max weight (self-loops included — the reference does
        this, with an author note; mod.rs:471-480), then drop self-loops
        (filter_diag, mod.rs:493-497)."""
        rows, cols, w = self.edges()
        new = sps.coo_matrix(
            (w, (node_to_agg[rows], node_to_agg[cols])), shape=(n_aggs, n_aggs)
        ).tocsr()
        new.sum_duplicates()
        gmax = new.data.max() if new.nnz else 1.0
        new.data /= gmax
        new.setdiag(0.0)
        new.eliminate_zeros()
        return Graph(adj=new)

    def maximal_independent_set(self, f_points: np.ndarray) -> np.ndarray:
        """Greedy MIS by descending strength-degree over current F-points
        (reference mod.rs:395-423, used by compatible relaxation).

        Mutates ``f_points`` to all-False and returns the new C-points.

        Independence is enforced over the SYMMETRIZED adjacency: the
        θ-filter keeps each node's own top-θ list, so i may retain j
        while j drops i.  The reference removes only out-neighbours of
        each pick (mod.rs:414-417), which on a strongly one-sided graph
        (e.g. a constant near-null candidate makes every affinity tie)
        lets runs of mutually-adjacent nodes all enter the "independent"
        set.  Removing in-neighbours too restores true independence and
        is a no-op when the kept lists are symmetric.
        """
        idx = np.flatnonzero(f_points)
        sub = self.adj[idx][:, idx]
        degrees = np.asarray(sub.sum(axis=1)).ravel()
        order = idx[np.argsort(-degrees, kind="stable")]
        sym = self._sym()
        indptr, indices = sym.indptr, sym.indices
        new_c = []
        for i in order:
            if f_points[i]:
                f_points[i] = False
                new_c.append(i)
                f_points[indices[indptr[i] : indptr[i + 1]]] = False
        return np.array(new_c, dtype=np.int64)

    def _sym(self) -> sps.csr_matrix:
        """Symmetrized pattern (cached) for independence checks."""
        cached = getattr(self, "_sym_adj", None)
        if cached is None:
            cached = (self.adj + self.adj.T).tocsr()
            object.__setattr__(self, "_sym_adj", cached)
        return cached


def _effective_depth(
    a: CSR, max_depth: int, reach_budget: int = 800, samples: int = 32
) -> int:
    """Largest depth ≤ max_depth whose median BFS neighbourhood stays
    below ``reach_budget`` nodes.

    The reference always uses depth 3 (mod.rs:290), which is fine for
    fine-grid stencils but explodes on Galerkin coarse operators (~230
    nnz/row → tens of thousands of depth-3 neighbours) at scale.
    Estimated on a node sample — behaviour is unchanged whenever the
    budget is not exceeded.
    """
    if max_depth <= 1 or a.nrows <= reach_budget:
        return max_depth
    sp = a.to_scipy().tocsr()
    rng = np.random.default_rng(0)
    nodes = rng.choice(a.nrows, size=min(samples, a.nrows), replace=False)
    depth = 1
    frontier_sets = [set([int(v)]) for v in nodes]
    visited = [set([int(v)]) for v in nodes]
    for d in range(1, max_depth + 1):
        sizes = []
        for t in range(len(nodes)):
            new = set()
            for u in frontier_sets[t]:
                new.update(sp.indices[sp.indptr[u] : sp.indptr[u + 1]].tolist())
            new -= visited[t]
            visited[t].update(new)
            frontier_sets[t] = new
            sizes.append(len(visited[t]))
        if np.median(sizes) > reach_budget and d > 1:
            return d - 1
        depth = d
        if np.median(sizes) > reach_budget:
            return d
    return depth


def strength_graph(
    a: CSR,
    near_null: np.ndarray,
    nn_weights: np.ndarray,
    max_depth: int = 3,
) -> Graph:
    """Build the filtered affinity strength graph of A."""
    near_null = np.asarray(near_null, dtype=np.float64)
    if near_null.ndim == 1:
        near_null = near_null[:, None]
    w = np.asarray(nn_weights, dtype=np.float64)[: near_null.shape[1]]

    max_depth = _effective_depth(a, max_depth)
    indptr, indices = native.bfs_reach(a.indptr, a.indices, a.nrows, max_depth)
    wv = near_null * w  # (n, k)
    norms = np.maximum(np.einsum("ik,ik->i", near_null, wv), 1e-30)
    dist = native.affinity_dist(indptr, indices, near_null, wv, norms)

    # per-node filter + contrast rescale; the reach pattern is row-sorted
    # and duplicate-free, so the kept edges already are too
    n = a.nrows
    keep_mask, weights_all = native.strength_filter(indptr, dist, THETA, ALPHA)
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    kept_per_row = np.bincount(rows[keep_mask], minlength=n)
    out_indptr = np.zeros(n + 1, dtype=indptr.dtype)
    np.cumsum(kept_per_row, out=out_indptr[1:])
    adj = sps.csr_matrix(
        (weights_all[keep_mask], indices[keep_mask].astype(np.int64),
         out_indptr),
        shape=(n, n),
    )
    return Graph(adj=adj)
