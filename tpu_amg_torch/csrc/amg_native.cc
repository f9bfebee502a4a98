// Native host kernels for tpu-amg setup-time sparse algebra.
//
// The reference implements its entire setup path in compiled Rust; these
// C++ kernels fill the same role for the host-side pieces that are
// serial or irregular (and therefore not a fit for XLA): two-pass CSR
// SpGEMM, the greedy-matching pop loop, the local-move application loop
// of the modularity partitioner (reference modularity.rs:339-383,
// 477-504), and per-node BFS neighborhood expansion for the strength
// graph (reference partitioners/mod.rs:695-718).
//
// Exposed as a plain C ABI consumed via ctypes (no pybind11 dependency).
// Built by tpu_amg_torch/ops/native.py at first use (g++ -O3 -shared -fPIC).

#include <algorithm>
#include <cstdint>
#include <cmath>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------
// Two-pass CSR SpGEMM: C = A(n_rows_a × k) * B(k × n_cols_b)
// Pass 1 counts nnz per row (returns total nnz), pass 2 fills
// indices/data with columns sorted ascending per row.
// ---------------------------------------------------------------------
int64_t spgemm_symbolic(
    int64_t n_rows_a, const int64_t* indptr_a, const int32_t* indices_a,
    const int64_t* indptr_b, const int32_t* indices_b, int64_t n_cols_b,
    int64_t* out_indptr) {
  std::vector<int64_t> marker(n_cols_b, -1);
  out_indptr[0] = 0;
  for (int64_t i = 0; i < n_rows_a; ++i) {
    int64_t count = 0;
    for (int64_t jj = indptr_a[i]; jj < indptr_a[i + 1]; ++jj) {
      int32_t j = indices_a[jj];
      for (int64_t kk = indptr_b[j]; kk < indptr_b[j + 1]; ++kk) {
        int32_t col = indices_b[kk];
        if (marker[col] != i) {
          marker[col] = i;
          ++count;
        }
      }
    }
    out_indptr[i + 1] = out_indptr[i] + count;
  }
  return out_indptr[n_rows_a];
}

void spgemm_numeric(
    int64_t n_rows_a, const int64_t* indptr_a, const int32_t* indices_a,
    const double* data_a, const int64_t* indptr_b, const int32_t* indices_b,
    const double* data_b, int64_t n_cols_b, const int64_t* out_indptr,
    int32_t* out_indices, double* out_data) {
  std::vector<int64_t> next(n_cols_b, -1);
  std::vector<double> sums(n_cols_b, 0.0);
  for (int64_t i = 0; i < n_rows_a; ++i) {
    int64_t head = -2;
    int64_t length = 0;
    for (int64_t jj = indptr_a[i]; jj < indptr_a[i + 1]; ++jj) {
      int32_t j = indices_a[jj];
      double v = data_a[jj];
      for (int64_t kk = indptr_b[j]; kk < indptr_b[j + 1]; ++kk) {
        int32_t col = indices_b[kk];
        sums[col] += v * data_b[kk];
        if (next[col] == -1) {
          next[col] = head;
          head = col;
          ++length;
        }
      }
    }
    // collect and sort columns ascending (insertion into a temp vector)
    int64_t offset = out_indptr[i];
    std::vector<int32_t> cols_tmp;
    cols_tmp.reserve(length);
    for (int64_t cnt = 0; cnt < length; ++cnt) {
      cols_tmp.push_back((int32_t)head);
      int64_t tmp = head;
      head = next[head];
      next[tmp] = -1;
    }
    // head-insertion yields descending discovery order; sort ascending
    std::sort(cols_tmp.begin(), cols_tmp.end());
    for (int64_t t = 0; t < length; ++t) {
      int32_t col = cols_tmp[t];
      out_indices[offset + t] = col;
      out_data[offset + t] = sums[col];
      sums[col] = 0.0;
    }
  }
}

// ---------------------------------------------------------------------
// Greedy heaviest-first matching (reference modularity.rs:339-383).
// Edges must be pre-sorted descending by score. Returns pair count;
// matched pairs are written to out_pairs (2*npairs entries).
// ---------------------------------------------------------------------
int64_t greedy_match(
    int64_t n_edges, const int64_t* rows, const int64_t* cols,
    int64_t n_vertices, int64_t target, int64_t* out_pairs) {
  std::vector<uint8_t> alive(n_vertices, 1);
  int64_t npairs = 0;
  for (int64_t e = 0; e < n_edges; ++e) {
    int64_t i = rows[e], j = cols[e];
    if (alive[i] && alive[j]) {
      alive[i] = 0;
      alive[j] = 0;
      out_pairs[2 * npairs] = i;
      out_pairs[2 * npairs + 1] = j;
      ++npairs;
      if (npairs > target) break;
    }
  }
  return npairs;
}

// ---------------------------------------------------------------------
// Conflict-frozen application of local moves
// (reference modularity.rs:477-504).  Moves are pre-sorted descending
// by gain. Freezes the moved node, both aggregates, the node's 1-hop
// neighbors and their aggregates. Mutates node_to_agg/agg_sizes in
// place; returns number of applied swaps.
// ---------------------------------------------------------------------
int64_t apply_moves(
    int64_t n_moves, const int64_t* nodes, const int64_t* dest_aggs,
    int64_t n_nodes, int64_t n_aggs, const int64_t* indptr,
    const int32_t* indices, const int64_t* node_weights,
    int64_t* node_to_agg, int64_t* agg_sizes) {
  std::vector<uint8_t> alive_nodes(n_nodes, 1);
  std::vector<uint8_t> alive_aggs(n_aggs, 1);
  int64_t swaps = 0;
  for (int64_t m = 0; m < n_moves; ++m) {
    int64_t node = nodes[m];
    int64_t new_agg = dest_aggs[m];
    int64_t old_agg = node_to_agg[node];
    if (alive_nodes[node] && alive_aggs[new_agg] && alive_aggs[old_agg]) {
      node_to_agg[node] = new_agg;
      agg_sizes[old_agg] -= node_weights[node];
      agg_sizes[new_agg] += node_weights[node];
      ++swaps;
      alive_aggs[new_agg] = 0;
      alive_aggs[old_agg] = 0;
      alive_nodes[node] = 0;
      for (int64_t jj = indptr[node]; jj < indptr[node + 1]; ++jj) {
        int32_t nb = indices[jj];
        alive_nodes[nb] = 0;
        alive_aggs[node_to_agg[nb]] = 0;
      }
    }
  }
  return swaps;
}

// ---------------------------------------------------------------------
// Per-node BFS neighborhood expansion within max_depth hops
// (reference extract_local_subgraph, partitioners/mod.rs:695-718),
// batched over all nodes. Two-pass: count then fill.  Output lists
// exclude the center node.
// ---------------------------------------------------------------------
int64_t bfs_reach_symbolic(
    int64_t n, const int64_t* indptr, const int32_t* indices,
    int64_t max_depth, int64_t* out_counts) {
  std::vector<int64_t> visited(n, -1);
  std::vector<int32_t> frontier, next_frontier;
  int64_t total = 0;
  for (int64_t c = 0; c < n; ++c) {
    visited[c] = c;
    frontier.clear();
    frontier.push_back((int32_t)c);
    int64_t count = 0;
    for (int64_t depth = 0; depth < max_depth; ++depth) {
      next_frontier.clear();
      for (int32_t u : frontier) {
        for (int64_t jj = indptr[u]; jj < indptr[u + 1]; ++jj) {
          int32_t v = indices[jj];
          if (visited[v] != c) {
            visited[v] = c;
            next_frontier.push_back(v);
            ++count;
          }
        }
      }
      frontier.swap(next_frontier);
    }
    out_counts[c] = count;
    total += count;
  }
  return total;
}

void bfs_reach_numeric(
    int64_t n, const int64_t* indptr, const int32_t* indices,
    int64_t max_depth, const int64_t* out_indptr, int32_t* out_indices) {
  std::vector<int64_t> visited(n, -1);
  std::vector<int32_t> frontier, next_frontier;
  for (int64_t c = 0; c < n; ++c) {
    visited[c] = c;
    frontier.clear();
    frontier.push_back((int32_t)c);
    int64_t offset = out_indptr[c];
    for (int64_t depth = 0; depth < max_depth; ++depth) {
      next_frontier.clear();
      for (int32_t u : frontier) {
        for (int64_t jj = indptr[u]; jj < indptr[u + 1]; ++jj) {
          int32_t v = indices[jj];
          if (visited[v] != c) {
            visited[v] = c;
            next_frontier.push_back(v);
            out_indices[offset++] = v;
          }
        }
      }
      frontier.swap(next_frontier);
    }
    std::sort(out_indices + out_indptr[c], out_indices + offset);
  }
}

// ---------------------------------------------------------------------
// Strength-graph per-row filter + contrast rescale
// (reference partitioners/mod.rs:364-390): keep the smallest-distance
// ⌊θ·len⌋ (≥1) entries of each row, then per-row contrast weights
// w = ((d_max−d)/(d_max−d_min+1e-12))^α; all-equal rows get weight 1.
// Replaces a global lexsort over all edges with tiny per-row sorts.
// ---------------------------------------------------------------------
void strength_filter(
    int64_t n, const int64_t* indptr, const double* dist, double theta,
    double alpha, uint8_t* keep, double* weight) {
  std::vector<int64_t> order;
  for (int64_t i = 0; i < n; ++i) {
    int64_t lo = indptr[i], hi = indptr[i + 1];
    int64_t len = hi - lo;
    if (len == 0) continue;
    int64_t kcount = (int64_t)(len * theta);
    if (kcount < 1) kcount = 1;
    order.resize(len);
    for (int64_t t = 0; t < len; ++t) order[t] = lo + t;
    std::stable_sort(order.begin(), order.end(), [&](int64_t a, int64_t b) {
      return dist[a] < dist[b];
    });
    double d_min = dist[order[0]];
    double d_max = dist[order[kcount - 1]];
    bool flat = std::abs(d_max - d_min) < 1e-12;
    for (int64_t t = 0; t < kcount; ++t) {
      int64_t e = order[t];
      keep[e] = 1;
      if (flat) {
        weight[e] = 1.0;
      } else {
        double u = (d_max - dist[e]) / (d_max - d_min + 1e-12);
        weight[e] = std::pow(u, alpha);
      }
    }
  }
}

// ---------------------------------------------------------------------
// Best positive-Δq move per node (reference delta_q + swap generation,
// modularity.rs:391-467): for each node, accumulate connection strength
// per neighboring aggregate, score moves with the size-cost term, and
// emit the best strictly-positive move.  O(E) with a small per-node
// scratch; replaces a scipy matrix build + 15M-entry sort per pass.
// ---------------------------------------------------------------------
static inline double size_cost(double s, double cf, double pen) {
  double rel = std::abs(s - cf) / cf;
  double r4 = 4.0 * rel;
  r4 = r4 * r4 * r4 * r4;
  return r4 * pen;
}

int64_t best_moves(
    int64_t n, const int64_t* indptr, const int32_t* indices,
    const double* weights, const int64_t* node_to_agg,
    const int64_t* agg_sizes, const int64_t* node_weights, double cf,
    double agg_pen, int64_t* out_nodes, int64_t* out_dest,
    double* out_dq) {
  std::vector<int64_t> cand_aggs;
  std::vector<double> cand_sums;
  int64_t count = 0;
  for (int64_t i = 0; i < n; ++i) {
    int64_t src = node_to_agg[i];
    if (agg_sizes[src] == node_weights[i]) continue;  // singleton source
    cand_aggs.clear();
    cand_sums.clear();
    double in_degree = 0.0;
    for (int64_t jj = indptr[i]; jj < indptr[i + 1]; ++jj) {
      int64_t agg_j = node_to_agg[indices[jj]];
      double w = weights[jj];
      if (agg_j == src) {
        in_degree += w;
        continue;
      }
      bool found = false;
      for (size_t t = 0; t < cand_aggs.size(); ++t) {
        if (cand_aggs[t] == agg_j) {
          cand_sums[t] += w;
          found = true;
          break;
        }
      }
      if (!found) {
        cand_aggs.push_back(agg_j);
        cand_sums.push_back(w);
      }
    }
    double wi = (double)node_weights[i];
    double old_src_cost = size_cost((double)agg_sizes[src], cf, agg_pen);
    double new_src_cost = size_cost((double)agg_sizes[src] - wi, cf, agg_pen);
    double best_dq = 0.0;
    int64_t best_agg = -1;
    for (size_t t = 0; t < cand_aggs.size(); ++t) {
      int64_t dst = cand_aggs[t];
      double old_cost =
          old_src_cost + size_cost((double)agg_sizes[dst], cf, agg_pen);
      double new_cost =
          new_src_cost + size_cost((double)agg_sizes[dst] + wi, cf, agg_pen);
      double dq = (cand_sums[t] - in_degree) + agg_pen * (old_cost - new_cost);
      if (dq > best_dq) {
        best_dq = dq;
        best_agg = dst;
      }
    }
    if (best_agg >= 0 && best_dq > 0.0) {
      out_nodes[count] = i;
      out_dest[count] = best_agg;
      out_dq[count] = best_dq;
      ++count;
    }
  }
  return count;
}

// Affinity distances over a precomputed neighborhood pattern: for each
// edge (i, j) of the reach CSR, rho2 = (v_i . wv_j)^2 / (norm_i norm_j),
// dist = 2 sqrt(max(0, 1 - rho2)).  V/WV are (n, k) row-major; norms are
// the precomputed diagonal dots v_i . wv_i.  Threaded over row ranges
// (disjoint output slices).
void affinity_dist(int64_t n, const int64_t* reach_indptr,
                   const int32_t* reach_indices, const double* v,
                   const double* wv, const double* norms, int64_t k,
                   double* dist) {
  int nthreads = (int)std::thread::hardware_concurrency();
  if (nthreads < 1) nthreads = 1;
  if (n < 4096) nthreads = 1;
  auto worker = [=](int64_t row_lo, int64_t row_hi) {
    for (int64_t i = row_lo; i < row_hi; ++i) {
      const double* vi = v + i * k;
      double ni = norms[i];
      for (int64_t e = reach_indptr[i]; e < reach_indptr[i + 1]; ++e) {
        int64_t j = reach_indices[e];
        const double* wvj = wv + j * k;
        double dot = 0.0;
        for (int64_t c = 0; c < k; ++c) dot += vi[c] * wvj[c];
        double rho2 = dot * dot / (ni * norms[j]);
        double rest = 1.0 - rho2;
        dist[e] = 2.0 * std::sqrt(rest > 0.0 ? rest : 0.0);
      }
    }
  };
  if (nthreads == 1) {
    worker(0, n);
    return;
  }
  std::vector<std::thread> threads;
  int64_t step = (n + nthreads - 1) / nthreads;
  for (int t = 0; t < nthreads; ++t) {
    int64_t lo = t * step, hi = std::min(n, lo + step);
    if (lo >= hi) break;
    threads.emplace_back(worker, lo, hi);
  }
  for (auto& th : threads) th.join();
}

}  // extern "C"
