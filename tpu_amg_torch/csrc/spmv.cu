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
// At k > 1 each kernel has a second design.  K2 runs its piece design
// (`pieces` below) at every k > 1: it cuts the tail rows into pieces of
// up to 64 entries, a warp each, 16-byte column vectors and the next
// step's loads issued beside this step's, so that long rows are spread
// over a block's warps and short ones take one dependent load less a
// step; the first K2 design (a warp a tail row, 4 entries' loads in
// flight, two scalar columns a lane) stays the reference.  K1 is routed
// by the bytes of an X row and the matrix's mean capped row length
// (ops/spmv.py `k1_design`, from both designs timed on the paths' own
// matrices, PERF.md): the staged SpMM (csr_spmm.cuh) copies each row
// block's distinct X rows into shared memory where X rows are at most
// 64 bytes and the matrix's rows short, or reads X rows through L1 from
// 256-byte rows, 16 bytes a lane in one pass; else the first design
// (csr_rowblock.cuh), which gathers a whole X row an entry, 8 bytes a
// lane and a pass a 32 columns.  Both are bound by the bytes each once
// (the values and indices, X and Y) and, past that, by the X rows
// gathered.  At k = 1 both kernels are as they were.
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
#include "csr_spmm.cuh"

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

// K2 at k > 1, the piece design.  The host (ops/spmv.py `k2_pieces`)
// cuts every tail row into pieces of up to kPiece entries (a row past
// kBucket pieces into kBucket longer ones) and the rows into blocks: the
// rows whose first piece falls in one bucket of kBucket pieces, so a
// block holds fewer than kSlots pieces and every piece of its rows.
// Warp w of a block owns pieces w, w + 8, ...; its lanes form groups of
// `team` lanes (16 bytes of adjacent columns a lane, as K1's staged
// design), group q summing entries q, q + groups, ... of the piece in
// turn, kUnroll entries a step: a step's X loads are issued together
// with the next step's value and column loads, so 2 kUnroll entries'
// loads are in flight a group.  The groups meet by a shuffle tree (o =
// 16, 8, ..., team).  A row of one piece is added into Y by its warp
// (piece_row holds its row); the pieces of a longer row go to shared
// memory, and after the block's barrier each (row, column) sums them in
// piece order and adds that into Y.  Each Y element has one writer and a
// plain load-add-store: no atomics, the same bits on every call.  The
// order differs from the rows design's (a team of lanes a row), so the
// two agree to rounding, not bitwise.
namespace pieces {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPiece = 64;   // tail entries a piece
constexpr int kBucket = 8;   // pieces a bucket of the block cut
constexpr int kSlots = 2 * kBucket;
constexpr int kUnroll = 4;

template <typename V, typename T>
__global__ void __launch_bounds__(kThreads, 4)
pieces_kernel(int k, int team, int aligned, const int32_t* __restrict__ blk,
              const int32_t* __restrict__ row_piece,
              const int32_t* __restrict__ piece_ptr,
              const int32_t* __restrict__ piece_row,
              const int32_t* __restrict__ row_ids,
              const int32_t* __restrict__ cols, const V* __restrict__ vals,
              const T* __restrict__ x, T* __restrict__ y) {
  constexpr int VEC = spmm::Vec<T>::n;
  using VT = typename spmm::Vec<T>::type;
  __shared__ __align__(16) T part[kSlots][kMaxColumns];
  const int tid = threadIdx.x;
  // blk: [first tail row, first piece] a block, and one more pair
  const int r0 = __ldg(blk + 2 * blockIdx.x);
  const int p0 = __ldg(blk + 2 * blockIdx.x + 1);
  const int r1 = __ldg(blk + 2 * blockIdx.x + 2);
  const int p1 = __ldg(blk + 2 * blockIdx.x + 3);
  const int lane = tid % 32;
  const int groups = 32 / team;
  const int g = lane / team;
  const int col0 = (lane % team) * VEC;
  for (int p = p0 + tid / 32; p < p1; p += kWarps) {  // warp-uniform
    const int e1 = __ldg(piece_ptr + p + 1);
    const int row = __ldg(piece_row + p);  // -1: a row of several pieces
    T acc[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] = T(0);
    T v[kUnroll];
    int c[kUnroll];
    int j = __ldg(piece_ptr + p) + g;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int ju = j + u * groups;
      v[u] = ju < e1 ? widen<T>(__ldg(vals + ju)) : T(0);
      c[u] = ju < e1 ? __ldg(cols + ju) : 0;
    }
    for (; j < e1; j += kUnroll * groups) {
      T xv[kUnroll][VEC];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const T* xr = x + c[u] * k + col0;
        if (aligned && col0 < k) {
          spmm::Vec<T>::split(__ldg(reinterpret_cast<const VT*>(xr)), xv[u]);
        } else {
#pragma unroll
          for (int i = 0; i < VEC; ++i) {
            xv[u][i] = col0 + i < k ? __ldg(xr + i) : T(0);
          }
        }
      }
      T vn[kUnroll];
      int cn[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {  // the next step's entries
        const int ju = j + (kUnroll + u) * groups;
        vn[u] = ju < e1 ? widen<T>(__ldg(vals + ju)) : T(0);
        cn[u] = ju < e1 ? __ldg(cols + ju) : 0;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (j + u * groups < e1) {
#pragma unroll
          for (int i = 0; i < VEC; ++i) acc[i] = fma(v[u], xv[u][i], acc[i]);
        }
        v[u] = vn[u];
        c[u] = cn[u];
      }
    }
    for (int o = 16; o >= team; o >>= 1) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        acc[i] += __shfl_down_sync(0xffffffffu, acc[i], o);
      }
    }
    if (g == 0) {
      T* out = row >= 0 ? y + row * k : part[p - p0];
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        if (col0 + i < k) {
          if (row >= 0) {
            out[col0 + i] += acc[i];
          } else {
            out[col0 + i] = acc[i];
          }
        }
      }
    }
  }
  if (p1 - p0 == r1 - r0) return;  // every row one piece: no barrier
  __syncthreads();
  for (int idx = tid; idx < (r1 - r0) * k; idx += kThreads) {
    const int i = idx / k;
    const int c = idx - i * k;
    const int q0 = __ldg(row_piece + r0 + i) - p0;
    const int q1 = __ldg(row_piece + r0 + i + 1) - p0;
    if (q1 - q0 < 2) continue;  // added by its warp
    T s = part[q0][c];
    for (int q = q0 + 1; q < q1; ++q) s += part[q][c];
    y[__ldg(row_ids + r0 + i) * k + c] += s;
  }
}

}  // namespace pieces

// 16-byte vectors of X (and Y) at k columns of T.
template <typename T>
bool vector_aligned(int k, const void* x, const void* y) {
  return (k * sizeof(T)) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(y) % 16 == 0;
}

template <typename V, typename T>
int csr_spmm_staged(int n_blocks, int k, int width, int stage,
                    const void* blk_rows, const void* blk_cols,
                    const void* cols, const void* slots, const void* indices,
                    const void* indptr, const void* vals, const void* x,
                    void* y, void* stream) {
  const int code = spmm::launch_staged<V, T>(
      n_blocks, k, width, stage, vector_aligned<T>(k, x, y) ? 1 : 0,
      static_cast<const int*>(blk_rows), static_cast<const int*>(blk_cols),
      static_cast<const int*>(cols), static_cast<const int16_t*>(slots),
      static_cast<const int32_t*>(indices),
      static_cast<const int64_t*>(indptr), static_cast<const V*>(vals),
      static_cast<const T*>(x), static_cast<T*>(y),
      static_cast<cudaStream_t>(stream));
  if (code != 0) return code;
  return static_cast<int>(cudaGetLastError());
}

template <typename V, typename T>
int coo_patch_pieces(int n_blocks, int k, const void* blk,
                     const void* row_piece, const void* piece_ptr,
                     const void* piece_row, const void* row_ids,
                     const void* cols, const void* vals, const void* x,
                     void* y, void* stream) {
  if (k < 1 || k > kMaxColumns) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_blocks > 0) {
    pieces::pieces_kernel<V, T><<<n_blocks, pieces::kThreads, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
        k, spmm::team_lanes<T>(k), vector_aligned<T>(k, x, y) ? 1 : 0,
        static_cast<const int32_t*>(blk),
        static_cast<const int32_t*>(row_piece),
        static_cast<const int32_t*>(piece_ptr),
        static_cast<const int32_t*>(piece_row),
        static_cast<const int32_t*>(row_ids),
        static_cast<const int32_t*>(cols), static_cast<const V*>(vals),
        static_cast<const T*>(x), static_cast<T*>(y));
  }
  return static_cast<int>(cudaGetLastError());
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

// The many-column designs' table constants, by index: K1's staged row
// block (entries, rows, distinct columns), K2's piece and bucket.  The
// host cuts its tables to them and refuses a library that differs.
int spmm_design(int what) {
  switch (what) {
    case 0: return spmm::kEntries;
    case 1: return spmm::kRows;
    case 2: return spmm::kColumns;
    case 3: return pieces::kPiece;
    case 4: return pieces::kBucket;
    default: return -1;
  }
}

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
  }                                                                         \
  int csr_spmm_staged_##SUFFIX(int n_blocks, int k, int width, int stage,   \
                               const void* blk_rows, const void* blk_cols,  \
                               const void* cols, const void* slots,         \
                               const void* indices, const void* indptr,     \
                               const void* vals, const void* x, void* y,    \
                               void* stream) {                              \
    return csr_spmm_staged<V, T>(n_blocks, k, width, stage,                 \
                                 blk_rows, blk_cols, cols, slots, indices,  \
                                 indptr, vals, x, y, stream);               \
  }                                                                         \
  int coo_patch_pieces_##SUFFIX(int n_blocks, int k, const void* blk,       \
                                const void* row_piece,                      \
                                const void* piece_ptr,                      \
                                const void* piece_row, const void* row_ids, \
                                const void* cols, const void* vals,         \
                                const void* x, void* y, void* stream) {     \
    return coo_patch_pieces<V, T>(n_blocks, k, blk, row_piece, piece_ptr,   \
                                  piece_row, row_ids, cols, vals, x, y,     \
                                  stream);                                  \
  }

SPMV_ENTRIES(f64, double, double)
SPMV_ENTRIES(f32, float, float)
SPMV_ENTRIES(f32f64, float, double)
SPMV_ENTRIES(bf16f32, __nv_bfloat16, float)
SPMV_ENTRIES(bf16f64, __nv_bfloat16, double)
#undef SPMV_ENTRIES

}  // extern "C"
