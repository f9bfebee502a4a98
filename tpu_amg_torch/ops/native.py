"""Native (C++) host kernels for setup-time sparse algebra.

The two-pass CSR SpGEMM, the greedy-matching pop loop, the
conflict-frozen local-move application, batched BFS neighbourhood
expansion, the affinity distances and the strength filter are C++
(``tpu_amg/ops/native_src/amg_native.cc``, one source shared with the
JAX package).  It is compiled with g++ into
``build/tpu_amg_torch/libamg_native.so`` at first use and loaded with
ctypes.  A failed build raises: the setup has no numpy fallback.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np

from tpu_amg_torch.ops._build import REPO_ROOT, build_library

SOURCE = REPO_ROOT / "tpu_amg" / "ops" / "native_src" / "amg_native.cc"
CXX_FLAGS = [
    "g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
    "-pthread",
]

_i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
_u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")


@functools.cache
def lib() -> ctypes.CDLL:
    """The loaded native library, built on first call."""
    dll = ctypes.CDLL(str(build_library("libamg_native.so", SOURCE, CXX_FLAGS)))
    i64, f64 = ctypes.c_int64, ctypes.c_double
    signatures = {
        "spgemm_symbolic": (i64, [i64, _i64p, _i32p, _i64p, _i32p, i64, _i64p]),
        "spgemm_numeric": (None, [
            i64, _i64p, _i32p, _f64p, _i64p, _i32p, _f64p, i64, _i64p,
            _i32p, _f64p,
        ]),
        "greedy_match": (i64, [i64, _i64p, _i64p, i64, i64, _i64p]),
        "apply_moves": (i64, [
            i64, _i64p, _i64p, i64, i64, _i64p, _i32p, _i64p, _i64p, _i64p,
        ]),
        "bfs_reach_symbolic": (i64, [i64, _i64p, _i32p, i64, _i64p]),
        "bfs_reach_numeric": (None, [i64, _i64p, _i32p, i64, _i64p, _i32p]),
        "strength_filter": (None, [i64, _i64p, _f64p, f64, f64, _u8p, _f64p]),
        "affinity_dist": (None, [
            i64, _i64p, _i32p, _f64p, _f64p, _f64p, i64, _f64p,
        ]),
        "best_moves": (i64, [
            i64, _i64p, _i32p, _f64p, _i64p, _i64p, _i64p, f64, f64, _i64p,
            _i64p, _f64p,
        ]),
    }
    for name, (restype, argtypes) in signatures.items():
        fn = getattr(dll, name)
        fn.restype = restype
        fn.argtypes = argtypes
    return dll


def _c(a, dtype):
    return np.ascontiguousarray(a, dtype)


def spgemm(a, b):
    """C = A @ B on host CSR containers (two-pass native kernel)."""
    from tpu_amg_torch.sparse.csr import CSR

    n = a.nrows
    indptr_a, indices_a = _c(a.indptr, np.int64), _c(a.indices, np.int32)
    indptr_b, indices_b = _c(b.indptr, np.int64), _c(b.indices, np.int32)
    data_a, data_b = _c(a.data, np.float64), _c(b.data, np.float64)
    out_indptr = np.zeros(n + 1, dtype=np.int64)
    nnz = lib().spgemm_symbolic(
        n, indptr_a, indices_a, indptr_b, indices_b, b.ncols, out_indptr
    )
    out_indices = np.zeros(nnz, dtype=np.int32)
    out_data = np.zeros(nnz, dtype=np.float64)
    lib().spgemm_numeric(
        n, indptr_a, indices_a, data_a, indptr_b, indices_b, data_b,
        b.ncols, out_indptr, out_indices, out_data,
    )
    return CSR(
        data=out_data,
        indices=out_indices,
        indptr=out_indptr,
        shape=(a.nrows, b.ncols),
        block_size=a.block_size,
    )


def greedy_match(rows, cols, n_vertices, target):
    """Serial heaviest-first matching; edges pre-sorted descending."""
    rows, cols = _c(rows, np.int64), _c(cols, np.int64)
    out = np.zeros(2 * min(len(rows), n_vertices // 2 + 1), dtype=np.int64)
    npairs = lib().greedy_match(len(rows), rows, cols, n_vertices, target, out)
    return out[: 2 * npairs].reshape(-1, 2)


def apply_moves(nodes, dest_aggs, indptr, indices, node_weights,
                node_to_agg, agg_sizes):
    """Conflict-frozen move application (mutates node_to_agg/agg_sizes)."""
    for arr in (node_to_agg, agg_sizes):
        if arr.dtype != np.int64 or not arr.flags.c_contiguous:
            raise ValueError("node_to_agg and agg_sizes must be C int64")
    return lib().apply_moves(
        len(nodes), _c(nodes, np.int64), _c(dest_aggs, np.int64),
        len(node_to_agg), len(agg_sizes), _c(indptr, np.int64),
        _c(indices, np.int32), _c(node_weights, np.int64), node_to_agg,
        agg_sizes,
    )


def bfs_reach(indptr, indices, n, max_depth):
    """All-pairs bounded-depth BFS neighbourhoods as CSR (excl. centre)."""
    indptr, indices = _c(indptr, np.int64), _c(indices, np.int32)
    counts = np.zeros(n, dtype=np.int64)
    total = lib().bfs_reach_symbolic(n, indptr, indices, max_depth, counts)
    out_indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=out_indptr[1:])
    out_indices = np.zeros(total, dtype=np.int32)
    lib().bfs_reach_numeric(n, indptr, indices, max_depth, out_indptr,
                            out_indices)
    return out_indptr, out_indices


def affinity_dist(reach_indptr, reach_indices, v, wv, norms):
    """Affinity distances over the reach pattern (threaded single pass)."""
    reach_indptr = _c(reach_indptr, np.int64)
    v, wv = _c(v, np.float64), _c(wv, np.float64)
    dist = np.zeros(len(reach_indices), dtype=np.float64)
    lib().affinity_dist(
        len(reach_indptr) - 1, reach_indptr, _c(reach_indices, np.int32), v,
        wv, _c(norms, np.float64), v.shape[1], dist,
    )
    return dist


def strength_filter(indptr, dist, theta, alpha):
    """Per-row keep mask + contrast weights for the strength graph."""
    dist = _c(dist, np.float64)
    keep = np.zeros(len(dist), dtype=np.uint8)
    weight = np.zeros(len(dist), dtype=np.float64)
    lib().strength_filter(
        len(indptr) - 1, _c(indptr, np.int64), dist, float(theta),
        float(alpha), keep, weight,
    )
    return keep.astype(bool), weight


def best_moves(indptr, indices, weights, node_to_agg, agg_sizes,
               node_weights, cf, agg_pen):
    """Best positive-gain move per node (one O(E) pass)."""
    n = len(indptr) - 1
    out_nodes = np.zeros(n, dtype=np.int64)
    out_dest = np.zeros(n, dtype=np.int64)
    out_dq = np.zeros(n, dtype=np.float64)
    count = lib().best_moves(
        n, _c(indptr, np.int64), _c(indices, np.int32),
        _c(weights, np.float64), _c(node_to_agg, np.int64),
        _c(agg_sizes, np.int64), _c(node_weights, np.int64), float(cf),
        float(agg_pen), out_nodes, out_dest, out_dq,
    )
    return out_nodes[:count], out_dest[:count], out_dq[:count]
