// Sparse matrix-vector / matrix-multivector kernels for Hopper (sm_90a).
//
// Two kernels carry every sparse apply of the solve (A, P and R of each
// sparse multigrid level) and of the setup bootstrap (A times a block of
// near-null candidates):
//
//   K1 csr_spmv_capped  Y = A_cap X, over the first `cap` entries of each
//                       CSR row.  Replaces the WELL SpMV Pallas kernel
//                       tpu_amg/ops/well_pallas.py `_kernel` (:77),
//                       launched by `_well_spmv_call` (:312).
//   K2 coo_patch        Y[r, :] += sum of v X[c, :] over the entries of
//                       row r past `cap` (the tail), for every row that
//                       spills.  Replaces the stray-patch Pallas kernel
//                       tpu_amg/ops/well_pallas.py `_stray_kernel` (:457),
//                       launched by `_stray_patch_call` (:485).
//
// They keep the TPU kernels' contract (y = A x, and Y = A X for a
// row-major (n, k) X, square or rectangular A, a row-length capped main
// kernel plus a patch for the spill) and drop their layout: the (8,128)
// dedup tables and 0/1 selector matmuls existed because Mosaic cannot
// gather freely, and Hopper can.
//
// Both are bound by bytes, not operations: per entry they read a value,
// a column index and a gathered X row, for 2k flops.  K1 on the SA
// path's A0 in float64 must move 57.8 MB (values, indices, row pointers,
// x and y once each): 17.25 us at the data sheet's 3,350 GB/s.  A group
// of lanes per row waits on a chain of dependent loads (row pointer, then
// value and index, then x) with about one entry a lane, too few bytes in
// flight to stream.  So K1 is the row-block streaming design of
// csr_rowblock.cuh: each thread block streams a fixed range of up to
// 256 entries in coalesced loads that depend on no row pointer, stages
// products (k = 1) or (value, column) pairs (k > 1) in shared memory, and
// reduces rows from there; k = 1 has no column loop, and k > 1 reads each
// value and index once, with X rows read contiguously across lanes.
//
// K2 must move the tail's values and columns, its row table (row id and
// start of each spilling row), the X rows it gathers and the Y rows it
// reads and writes.  Its first design, one atomic add per (entry,
// column), carried a row id per entry and serialised the ~89 adds a row
// of the structured path's level 2 on one address.  The tail is in CSR
// order, so K2 is a segmented row reduction on the host's row table: a
// team of L lanes owns a spilling row (a block of 8 warps a row of more
// than kLongTailRow entries, the hub rows of a smoothed-SA R).  The
// team's lanes form groups of G (the power of two at or above k, at most
// 32), a group takes entries g, g + groups, ... (4 entries' value,
// column and X loads in flight a lane), and lane c of a group sums
// columns c and c + G of X, so values and columns are read once a row
// and each X row contiguously.  The host picks L: a warp (L = 32), or
// at k = 1, where the tail has more rows than the card holds warps at
// once, 16 or 8 lanes, so that every row is in flight (the structured
// path's level 2: 15,569 rows).  Fewer lanes on a tail that fits (the
// SA path's short A1 tail) measured slower (PERF.md): a team's longest
// row then takes more steps of dependent loads.  A short tail is bound
// by that chain (row table, then entries, then X), one load longer than
// the first design's (entries with their row ids, then X).  The
// groups are summed by a shuffle tree, the warps of a long row in shared
// memory, in a fixed order; one lane adds the row's sum into Y with a
// plain load-add-store.  One writer a row: no atomics, and the same Y on
// every call.
//
// Both stream their values in the stored type V and multiply and sum in
// T, the type of X and Y, V widened exactly first (widen.cuh): entry
// points `{kernel}_f64` and `_f32` for V = T, `_f32f64`, `_bf16f32` and
// `_bf16f64` for a narrower V.  The TPU's K1 reads a bf16 value stream
// under f32 vectors the same way (well_pallas.py:112, `cdt =
// x_ref.dtype`).  A bf16 stream moves 2 bytes an entry for the value
// where f64 moves 8, beside the 4-byte column.  In a cycle whose vectors
// are bf16 the host runs the (bf16, f32) kernels on X widened to f32 and
// rounds Y to bf16 once, after K2 has added the tail
// (tpu_amg_torch/precision.py).
//
// The host side (tpu_amg_torch/ops/spmv.py) builds the row-block table and
// the tail row table, allocates every output, passes PyTorch's current
// stream, and checks the returned cudaGetLastError().

#include "csr_rowblock.cuh"

namespace {

constexpr int kPatchThreads = 256;  // a block of K2
constexpr int kPatchUnroll = 4;
constexpr int kMaxColumns = 64;
// a tail row of more entries than a warp's step of loads at k = 1 takes a
// block of its own (the host lists such rows, tail_long)
constexpr int kLongTailRow = kPatchUnroll * 32;

// Tail row [e0, e1) of `row`, owned by a team of W warps of L lanes each
// (W > 1: the whole block, L = 32).  Every lane of a warp calls it, so the
// shuffles see the whole warp; a lane whose team owns no row passes
// owns = false and e0 = e1.
template <typename V, typename T, int L, int W>
__device__ __forceinline__ void patch_row(bool owns, int row, int e0, int e1,
                                          int k, int G,
                                          const int32_t* __restrict__ cols,
                                          const V* __restrict__ vals,
                                          const T* __restrict__ x,
                                          T* __restrict__ y) {
  const int tid = threadIdx.x % (L * W);  // in the team
  const int lane = tid % L;               // in the team's part of a warp
  const int c0 = lane % G;  // this lane's columns: c0 and c0 + G
  const int groups = L * W / G;
  T acc0 = T(0), acc1 = T(0);
  for (int j = e0 + tid / G; j < e1; j += kPatchUnroll * groups) {
    T v[kPatchUnroll];
    int c[kPatchUnroll];
#pragma unroll
    for (int u = 0; u < kPatchUnroll; ++u) {
      const int ju = j + u * groups;
      v[u] = ju < e1 ? widen<T>(__ldg(vals + ju)) : T(0);
      c[u] = ju < e1 ? __ldg(cols + ju) : 0;
    }
#pragma unroll
    for (int u = 0; u < kPatchUnroll; ++u) {
      if (j + u * groups < e1) {
        const T* xr = x + c[u] * k;
        if (c0 < k) acc0 += v[u] * __ldg(xr + c0);
        if (c0 + G < k) acc1 += v[u] * __ldg(xr + c0 + G);
      }
    }
  }
  // the team's groups, by a fixed shuffle tree within L lanes: lanes
  // 0 .. G - 1 of the team hold them
#pragma unroll
  for (int o = L / 2; o >= 1; o >>= 1) {
    if (o >= G) {
      acc0 += __shfl_down_sync(0xffffffffu, acc0, o, L);
      acc1 += __shfl_down_sync(0xffffffffu, acc1, o, L);
    }
  }
  T* yr = y + row * k;
  if constexpr (W == 1) {
    if (owns && lane < G) {
      if (c0 < k) yr[c0] += acc0;
      if (c0 + G < k) yr[c0 + G] += acc1;
    }
  } else {
    // the warps' sums, added in warp order
    __shared__ T red[W][kMaxColumns];
    const int warp = tid / 32;
    if (lane < G) {
      if (c0 < k) red[warp][c0] = acc0;
      if (c0 + G < k) red[warp][c0 + G] = acc1;
    }
    __syncthreads();
    if (tid < k) {
      T s = red[0][tid];
#pragma unroll
      for (int w = 1; w < W; ++w) s += red[w][tid];
      yr[tid] += s;
    }
  }
}

// Blocks [0, n_long): one long tail row each, listed in `long_rows`;
// then blocks of teams of L lanes, team q of block b owning table row
// (b - n_long) kPatchThreads / L + q unless that row is long.
template <typename V, typename T, int L>
__global__ void __launch_bounds__(kPatchThreads)
coo_patch_kernel(int n_rows, int n_long, int k, int G,
                 const int32_t* __restrict__ row_ids,
                 const int32_t* __restrict__ ptr,
                 const int32_t* __restrict__ long_rows,
                 const int32_t* __restrict__ cols, const V* __restrict__ vals,
                 const T* __restrict__ x, T* __restrict__ y) {
  if (static_cast<int>(blockIdx.x) < n_long) {
    const int i = __ldg(long_rows + blockIdx.x);
    patch_row<V, T, 32, kPatchThreads / 32>(true, __ldg(row_ids + i),
                                         __ldg(ptr + i), __ldg(ptr + i + 1),
                                         k, G, cols, vals, x, y);
    return;
  }
  const int i = (static_cast<int>(blockIdx.x) - n_long) * (kPatchThreads / L) +
                static_cast<int>(threadIdx.x) / L;
  int row = 0, e0 = 0, e1 = 0;
  if (i < n_rows) {
    row = __ldg(row_ids + i);
    e0 = __ldg(ptr + i);
    e1 = __ldg(ptr + i + 1);
  }
  // a long row's block takes it
  const bool owns = i < n_rows && e1 - e0 <= kLongTailRow;
  patch_row<V, T, L, 1>(owns, row, e0, owns ? e1 : e0, k, G, cols, vals, x, y);
}

template <typename V, typename T, int L>
void launch_patch(unsigned blocks, cudaStream_t stream, int n_rows,
                  int n_long, int k, int G, const void* row_ids,
                  const void* ptr, const void* long_rows, const void* cols,
                  const void* vals, const void* x, void* y) {
  coo_patch_kernel<V, T, L><<<blocks, kPatchThreads, 0, stream>>>(
      n_rows, n_long, k, G, static_cast<const int32_t*>(row_ids),
      static_cast<const int32_t*>(ptr), static_cast<const int32_t*>(long_rows),
      static_cast<const int32_t*>(cols), static_cast<const V*>(vals),
      static_cast<const T*>(x), static_cast<T*>(y));
}

template <typename V, typename T>
int csr_spmv_capped(int n_blocks, int k, const void* block_rows,
                    const void* block_ptr, const void* indptr,
                    const void* indices, const void* vals, const void* x,
                    void* y, void* stream) {
  const int code = rowblock::launch<V, T, rowblock::kFull>(
      n_blocks, k, static_cast<const int*>(block_rows),
      static_cast<const int*>(block_ptr), static_cast<const int64_t*>(indptr),
      static_cast<const int32_t*>(indices), static_cast<const V*>(vals),
      static_cast<const T*>(x), T(0), static_cast<T*>(y),
      static_cast<cudaStream_t>(stream));
  if (code != 0) return code;
  return static_cast<int>(cudaGetLastError());
}

template <typename V, typename T>
int coo_patch(int n_rows, int n_long, int k, int lanes, const void* row_ids,
              const void* ptr, const void* long_rows, const void* cols,
              const void* vals, const void* x, void* y, void* stream) {
  int G = 1;
  while (G < k && G < 32) G *= 2;
  if (k < 1 || k > kMaxColumns || n_long > n_rows || lanes < G ||
      (lanes != 8 && lanes != 16 && lanes != 32)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_rows > 0) {
    const int teams = kPatchThreads / lanes;
    const unsigned blocks =
        static_cast<unsigned>(n_long + (n_rows + teams - 1) / teams);
    auto st = static_cast<cudaStream_t>(stream);
    switch (lanes) {
#define K2_LANES(L)                                                         \
  case L:                                                                   \
    launch_patch<V, T, L>(blocks, st, n_rows, n_long, k, G, row_ids, ptr,      \
                       long_rows, cols, vals, x, y);                        \
    break;
      K2_LANES(8) K2_LANES(16) K2_LANES(32)
#undef K2_LANES
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The S this library was compiled for: the host cuts its tables to it.
int row_block_entries() { return rowblock::kEntries; }

// K2's long-row length: the host lists the rows past it (tail_long).
int long_tail_row() { return kLongTailRow; }

// Entry points: `_f64`, `_f32` (V = T) and `_{V}{T}` for a narrower V.
#define SPMV_ENTRIES(SUFFIX, V, T)                                          \
  int csr_spmv_capped_##SUFFIX(int n_blocks, int k, const void* block_rows, \
                               const void* block_ptr, const void* indptr,  \
                               const void* indices, const void* vals,      \
                               const void* x, void* y, void* stream) {     \
    return csr_spmv_capped<V, T>(n_blocks, k, block_rows, block_ptr,       \
                                 indptr, indices, vals, x, y, stream);     \
  }                                                                         \
  int coo_patch_##SUFFIX(int n_rows, int n_long, int k, int lanes,          \
                         const void* row_ids, const void* ptr,              \
                         const void* long_rows, const void* cols,           \
                         const void* vals, const void* x, void* y,          \
                         void* stream) {                                    \
    return coo_patch<V, T>(n_rows, n_long, k, lanes, row_ids, ptr,          \
                           long_rows, cols, vals, x, y, stream);            \
  }

SPMV_ENTRIES(f64, double, double)
SPMV_ENTRIES(f32, float, float)
SPMV_ENTRIES(f32f64, float, double)
SPMV_ENTRIES(bf16f32, __nv_bfloat16, float)
SPMV_ENTRIES(bf16f64, __nv_bfloat16, double)
#undef SPMV_ENTRIES

}  // extern "C"
