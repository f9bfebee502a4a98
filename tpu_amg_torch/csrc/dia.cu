// DIA (diagonal-format) sparse matrix-vector / matrix-multivector kernel
// for Hopper (sm_90a).
//
//   K3 dia_spmv  Y[i, :] = sum_d data[d, i] * X[i + off_d, :]
//                Replaces the DIA SpMV Pallas kernel
//                (tpu_amg/ops/dia_pallas.py `_kernel`), and with it the
//                XLA slice-FMA apply of tpu_amg/sparse/dia.py that the JAX
//                package runs on its solve path.
//
// It keeps the contract (y = A x, and Y = A X for a row-major (n, k) X
// with 1 <= k <= 64; square A, any n) and drops the TPU layout: the tile
// multiple of n, the VMEM cap on x, the 128-lane aligned slabs and
// static rotates existed only for Mosaic.  There is no padded copy of x
// either: a read i + off_d outside [0, n) is skipped, since its data
// entry is a structural zero.  Every output is one accumulator in the
// type of X, summed over the diagonals in offset order (the JAX
// package's order) with one fused multiply-add each.
//
// Bound by bytes: per diagonal a value and an x element for 2 flops, no
// index stream (the 4-byte column index of CSR is what DIA saves).  Three
// designs, one library; the wrapper (tpu_amg_torch/ops/dia.py) routes by
// k alone, the row-chunk design below k = 8 and the band tiles from it up:
//
// * The first design (`first_kernel`): one thread per (row, column),
//   walking the diagonals, the offsets read from a device table.  No
//   longer routed: it is the other two designs' reference on the card
//   (`dia_spmv_first_*` at any k), and all three give the same bits.
//   Its loop over a runtime count with a bounds branch and the offset's
//   load in each iteration serialises the loads, one L2 round trip a
//   diagonal; at k > 1 every value is read k times (once a column); at
//   large k each thread re-reads X[i + off_d] for every diagonal and
//   pays an int64 division per element.
// * The row-chunk design (`row_kernel`), for k <= 7: a thread owns R
//   consecutive rows (R = 1 or 2 at k = 1) and C of their columns: all k
//   (acc[R][k] in registers, each value read once), or at k > 1 one
//   (thread t: row t / k, column t % k), which the host plan takes where
//   an X row passes 32 bytes on a stencil of at most 8 diagonals, since a
//   warp's X loads at all k columns stride a whole row.  The offsets ride
//   in the launch (`RowPlan`, by value), so a CUDA graph captures them
//   and no thread loads them.  The diagonals go in chunks of U
//   (`row_chunk`: a power of two, at most 32 loads a thread in flight),
//   the last ones in chunks of U / 2, ..., 1: all of a chunk's value and
//   X loads are issued first, X from a clamped row, then its fmas run in
//   offset order, each taken only where the read was in range (a select:
//   a skipped X that is Inf or NaN does not reach the sum).  Where R = 2
//   the host plan has n even and the data 16-byte aligned, so a
//   diagonal's two values are one vector load.  Row indices are 32-bit;
//   each diagonal's row pointer is formed once in 64 bits.  The host
//   plan (ops/dia.py `row_plan`) picks R, C and the block for two blocks
//   an SM where n allows.
// * The band-tile design (`tiled_kernel`), for k >= 8: a block owns T
//   consecutive rows and all k columns.  The host's plan
//   (ops/dia.py `dia_plan`, passed by value) groups the sorted offsets
//   into bands, runs whose gaps are at most T rows; for each band the
//   block stages the band's X window, rows [i0 + lo, i0 + T + hi) clipped
//   to [0, n), which is contiguous in a row-major X, and the band's
//   data[d, i0:i0 + T] in shared memory with cp.async, double-buffered
//   (band b + 1 loads while band b computes).  Each X row then crosses L2
//   about (T + span) / T times a band instead of once a diagonal.  Lanes
//   own columns of a row (a 16-byte vector each where X is 16-byte
//   aligned and k a multiple of the vector, else one element, coalesced),
//   a thread up to 4 rows; indices inside a tile are 32-bit and no
//   division is left in the sum.  The plan shrinks T (down to 32 / lanes
//   rows) until the grid has two blocks an SM where n allows.
//
// Values stream in their stored type V (the data rows) and X and Y are of
// type T, V no wider than T: (f64, f64), (f32, f32), (f32, f64), (bf16,
// f32), (bf16, f64).  Each value is widened exactly to T before its fma
// (widen.cuh), so the sums are T's and the three designs give the same
// bits; a (T, T) instantiation is the kernel as it was before V.  The
// band tiles stage the X window in T and the data rows in V: 2-byte data
// rows go in 4-byte copies (cp.async copies 4, 8 or 16 bytes), each row
// placed at its address's phase against 4 bytes in a slot of an even
// number of elements (`data_stride`).  The reference's Pallas kernel
// writes Y in the data's dtype (dia_pallas.py:92); the port follows the
// XLA apply the JAX package runs on the CPU (sparse/dia.py:89,
// `result_type`): Y is T.
//
// The host side allocates the output, passes PyTorch's current stream and
// checks the returned cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

#include "widen.cuh"

namespace {

constexpr int kThreads = 256;           // the first design's block
constexpr int kMaxDiags = 160;          // the plans' tables (ops/dia.py MAX_DIAGS)
constexpr int kMaxRowsPerThread = 4;    // ops/dia.py ROWS_PER_THREAD
constexpr int kMaxThreads = 256;        // ops/dia.py BLOCK_THREADS
constexpr int kRowMaxK = 7;             // the row-chunk design's k (ops/dia.py ROW_MAX_K)
constexpr int kRowLoads = 32;           // its loads in flight a thread, at most (ROW_LOADS)
constexpr int kRowMaxChunk = 16;        // its diagonals a chunk at most (ROW_MAX_CHUNK)

__device__ __forceinline__ double fma_rn(double a, double b, double c) {
  return __fma_rn(a, b, c);
}
__device__ __forceinline__ float fma_rn(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}

// ---- the first design: one thread per (row, column)

template <typename V, typename T>
__global__ void first_kernel(int64_t n, int n_diags, int k,
                             const int64_t* __restrict__ offsets,
                             const V* __restrict__ data,
                             const T* __restrict__ x, T* __restrict__ y) {
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (tid >= n * k) return;
  const int64_t i = k == 1 ? tid : tid / k;
  const int64_t c = k == 1 ? 0 : tid - i * k;
  T acc = T(0);
  for (int d = 0; d < n_diags; ++d) {
    const int64_t j = i + __ldg(&offsets[d]);
    if (j >= 0 && j < n) {
      acc = fma_rn(widen<T>(data[static_cast<int64_t>(d) * n + i]), x[j * k + c],
                   acc);
    }
  }
  y[tid] = acc;
}

template <typename V, typename T>
int first_design(int64_t n, int n_diags, int k, const void* offsets,
                 const void* data, const void* x, void* y, void* stream) {
  if (n > 0) {
    const int64_t threads = n * k;
    const unsigned blocks = static_cast<unsigned>((threads + kThreads - 1) / kThreads);
    first_kernel<V, T><<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        n, n_diags, k, static_cast<const int64_t*>(offsets),
        static_cast<const V*>(data), static_cast<const T*>(x), static_cast<T*>(y));
  }
  return static_cast<int>(cudaGetLastError());
}

// ---- the row-chunk design

// The host's table (ops/dia.py `_RowStruct`): the offsets in order.
struct RowPlan {
  int n_diags;
  int offsets[kMaxDiags];
};

// Diagonals a chunk for a thread of R rows and C columns: the largest
// power of two that keeps at most kRowLoads loads (R values and R·C X
// elements a diagonal) in flight, 1 to kRowMaxChunk (ops/dia.py
// `row_chunk`).
__host__ __device__ constexpr int row_chunk(int c, int r) {
  int u = 1;
  while (2 * u <= kRowMaxChunk && 2 * u * r * (c + 1) <= kRowLoads) u *= 2;
  return u;
}

// The R values (1 or 2) of one diagonal at R consecutive rows; two from
// an address aligned to their size, in one vector load.
template <int R>
__device__ __forceinline__ void load_run(const double* __restrict__ p, double (&v)[R]) {
  if constexpr (R == 1) {
    v[0] = __ldg(p);
  } else {
    const double2 w = __ldg(reinterpret_cast<const double2*>(p));
    v[0] = w.x;
    v[1] = w.y;
  }
}

template <int R>
__device__ __forceinline__ void load_run(const float* __restrict__ p, float (&v)[R]) {
  if constexpr (R == 1) {
    v[0] = __ldg(p);
  } else {
    const float2 w = __ldg(reinterpret_cast<const float2*>(p));
    v[0] = w.x;
    v[1] = w.y;
  }
}

template <int R>
__device__ __forceinline__ void load_run(const __nv_bfloat16* __restrict__ p,
                                         __nv_bfloat16 (&v)[R]) {
  if constexpr (R == 1) {
    v[0] = p[0];
  } else {
    const unsigned w = __ldg(reinterpret_cast<const unsigned*>(p));
    v[0] = __ushort_as_bfloat16(static_cast<unsigned short>(w));
    v[1] = __ushort_as_bfloat16(static_cast<unsigned short>(w >> 16));
  }
}

// Diagonals [d0, d0 + U) of a thread's R rows and C columns from c0:
// all the chunk's value and X loads first (X from a clamped row), then
// its U fmas in offset order, each kept only where the read was in
// range.  Straight-line code, so that no branch splits the loads.
template <typename V, typename T, int K, int R, int C, int U>
__device__ __forceinline__ void row_chunk_sum(const RowPlan& p, int d0, int n, int i0,
                                              int c0, const V* __restrict__ data,
                                              const T* __restrict__ x,
                                              T (&acc)[R][C]) {
  V a[U][R];
  T xs[U][R][C];
  bool in[U][R];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int d = d0 + u;
    const int off = p.offsets[d];
    load_run<R>(data + static_cast<int64_t>(d) * n + i0, a[u]);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int j = i0 + r + off;
      in[u][r] = j >= 0 && j < n;
      const T* xr = x + static_cast<int64_t>(min(max(j, 0), n - 1)) * K + c0;
#pragma unroll
      for (int c = 0; c < C; ++c) xs[u][r][c] = xr[c];
    }
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const T w = widen<T>(a[u][r]);
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const T s = fma_rn(w, xs[u][r][c], acc[r][c]);
        acc[r][c] = in[u][r] ? s : acc[r][c];
      }
    }
  }
}

// The diagonals left after the full chunks, fewer than 2·U: a chunk of U
// where they reach U, then of U / 2, ..., 1 (ops/dia.py `row_chunks`).
template <typename V, typename T, int K, int R, int C, int U>
__device__ __forceinline__ void row_tail_sum(const RowPlan& p, int d0, int n, int i0,
                                             int c0, const V* __restrict__ data,
                                             const T* __restrict__ x,
                                             T (&acc)[R][C]) {
  if (p.n_diags - d0 >= U) {
    row_chunk_sum<V, T, K, R, C, U>(p, d0, n, i0, c0, data, x, acc);
    d0 += U;
  }
  if constexpr (U > 1) {
    row_tail_sum<V, T, K, R, C, U / 2>(p, d0, n, i0, c0, data, x, acc);
  }
}

// A thread owns R rows and C of their K columns: at C = K thread t owns
// rows [t·R, t·R + R) and every column; at C = 1 (R = 1) it owns row
// t / K, column t % K, the K threads of a row reading its values at one
// address and its X rows' K columns side by side.
template <typename V, typename T, int K, int R, int C>
__global__ void __launch_bounds__(kMaxThreads)
row_kernel(const __grid_constant__ RowPlan p, int n, const V* __restrict__ data,
           const T* __restrict__ x, T* __restrict__ y) {
  static_assert(C == K || (C == 1 && R == 1), "a thread owns 1 or K columns");
  constexpr int U = row_chunk(C, R);
  const unsigned t = blockIdx.x * blockDim.x + threadIdx.x;
  int i0, c0;
  if constexpr (C == K) {
    i0 = static_cast<int>(t) * R;
    c0 = 0;
    if (i0 >= n) return;  // n is a multiple of R where R > 1
  } else {
    if (t >= static_cast<unsigned>(n) * K) return;  // n·K < 2^31 (the plan)
    i0 = static_cast<int>(t / K);
    c0 = static_cast<int>(t - static_cast<unsigned>(i0) * K);
  }
  T acc[R][C];
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int c = 0; c < C; ++c) acc[r][c] = T(0);
  }
  int d0 = 0;
  for (; d0 + U <= p.n_diags; d0 += U) {
    row_chunk_sum<V, T, K, R, C, U>(p, d0, n, i0, c0, data, x, acc);
  }
  if constexpr (U > 1) {
    row_tail_sum<V, T, K, R, C, U / 2>(p, d0, n, i0, c0, data, x, acc);
  }
  T* yr = y + static_cast<int64_t>(i0) * K + c0;
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int c = 0; c < C; ++c) yr[r * K + c] = acc[r][c];
  }
}

// Launch row_kernel<V, T, k, r, c>; false where (k, r, c) has no
// instance: r = 1 and c = k or 1 for k in 1..kRowMaxK, and r = 2 at k =
// 1 (ops/dia.py `row_shapes`).
template <typename V, typename T, int K = 1>
bool row_launch(int k, int r, int c, int n, int threads, int blocks, const RowPlan& p,
                const V* data, const T* x, T* y, cudaStream_t s) {
  if (k != K) {
    if constexpr (K < kRowMaxK) {
      return row_launch<V, T, K + 1>(k, r, c, n, threads, blocks, p, data, x, y, s);
    } else {
      return false;
    }
  }
  if (r == 1 && c == K) {
    row_kernel<V, T, K, 1, K><<<blocks, threads, 0, s>>>(p, n, data, x, y);
  } else if constexpr (K == 1) {
    if (r != 2 || c != 1) return false;
    row_kernel<V, T, 1, 2, 1><<<blocks, threads, 0, s>>>(p, n, data, x, y);
  } else {
    if (r != 1 || c != 1) return false;
    row_kernel<V, T, K, 1, 1><<<blocks, threads, 0, s>>>(p, n, data, x, y);
  }
  return true;
}

constexpr bool row_instance(int k, int r, int c) {
  return k >= 1 && k <= kRowMaxK &&
         ((r == 1 && (c == k || c == 1)) || (k == 1 && r == 2 && c == 1));
}

template <typename V, typename T>
int row_design(int n, int k, int r, int c, int threads, int blocks, const void* plan,
               const void* data, const void* x, void* y, void* stream) {
  if (n > 0) {
    if (!row_launch<V, T>(k, r, c, n, threads, blocks, *static_cast<const RowPlan*>(plan),
                          static_cast<const V*>(data), static_cast<const T*>(x),
                          static_cast<T*>(y), static_cast<cudaStream_t>(stream))) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// ---- the band-tile design

// The host's plan (ops/dia.py `_PlanStruct`, field for field).  Band b
// holds the diagonals [band_start[b], band_start[b + 1]).  A buffer is
// xs_cap elements of X window (T; 16-byte aligned, with room for the
// window's phase against 16 bytes) then ds_cap elements of data rows (V),
// a row of the band every data_stride<V>(tile) elements.
struct Plan {
  int n_bands;
  int tile;             // T: rows a block
  int lanes_log2;       // lanes a row: 1 << lanes_log2
  int rows_per_thread;  // 1, 2 or 4
  int xs_cap;
  int ds_cap;
  int offsets[kMaxDiags];
  int band_start[kMaxDiags + 1];
};

// A lane's 16-byte piece of an X row: its multiply-adds into V
// accumulators, and the V sums stored to Y.
template <typename T> struct Vec;
template <> struct Vec<double> {
  using type = double2;
  static __device__ __forceinline__ void fma(double a, const double2& v, double* acc) {
    acc[0] = fma_rn(a, v.x, acc[0]);
    acc[1] = fma_rn(a, v.y, acc[1]);
  }
  static __device__ __forceinline__ double2 pack(const double* acc) {
    return make_double2(acc[0], acc[1]);
  }
};
template <> struct Vec<float> {
  using type = float4;
  static __device__ __forceinline__ void fma(float a, const float4& v, float* acc) {
    acc[0] = fma_rn(a, v.x, acc[0]);
    acc[1] = fma_rn(a, v.y, acc[1]);
    acc[2] = fma_rn(a, v.z, acc[2]);
    acc[3] = fma_rn(a, v.w, acc[3]);
  }
  static __device__ __forceinline__ float4 pack(const float* acc) {
    return make_float4(acc[0], acc[1], acc[2], acc[3]);
  }
};

template <typename T>
constexpr int kVec = 16 / static_cast<int>(sizeof(T));  // elements in 16 bytes

// A data row's slot in a buffer, in elements (ops/dia.py `data_stride`):
// the tile, or for 2-byte values an even number with room for the row's
// phase against 4 bytes.
template <typename V>
__device__ __forceinline__ int data_stride(int tile) {
  return sizeof(V) == 2 ? (tile + 3) & ~1 : tile;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void copy16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)),
               "l"(src)
               : "memory");
}

template <typename T>
__device__ __forceinline__ void copy1(T* dst, const T* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "n"(static_cast<int>(sizeof(T)))
               : "memory");
}

// 4 bytes, of which `bytes` are read and the rest zero-filled.
__device__ __forceinline__ void copy4(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wait_groups() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The rows [r0, r1) of band b's X window for the block's rows
// [i0, i0 + rows), clipped to [0, n).
__device__ __forceinline__ void band_window(const Plan& p, int b, int n, int i0,
                                            int rows, int& r0, int& r1) {
  const int64_t lo = static_cast<int64_t>(i0) + p.offsets[p.band_start[b]];
  const int64_t hi = static_cast<int64_t>(i0) + rows + p.offsets[p.band_start[b + 1] - 1];
  r0 = static_cast<int>(lo < 0 ? 0 : lo);
  r1 = static_cast<int>(hi > n ? n : hi);
}

// The window's first element's place in a buffer: its address's phase
// against 16 bytes, so that the 16-byte pieces land aligned.
template <typename T>
__device__ __forceinline__ int window_pad(const T* x, int r0, int k) {
  const T* src = x + static_cast<int64_t>(r0) * k;
  return static_cast<int>((reinterpret_cast<uintptr_t>(src) & 15) / sizeof(T));
}

// Issue the copies of band b's X window and data rows into `buf`.
template <typename V, typename T>
__device__ __forceinline__ void stage(const Plan& p, int b, int n, int k, int i0,
                                      int rows, const V* __restrict__ data,
                                      const T* __restrict__ x, T* buf) {
  const int tid = threadIdx.x, nt = blockDim.x;
  int r0, r1;
  band_window(p, b, n, i0, rows, r0, r1);
  if (r0 < r1) {
    const T* src = x + static_cast<int64_t>(r0) * k;
    const int pad = window_pad(x, r0, k);
    const int len = (r1 - r0) * k;
    const int head = min(len, (kVec<T> - pad) % kVec<T>);
    const int body = (len - head) / kVec<T>;
    T* dst = buf + pad;  // dst[e] = src[e], e in [0, len)
    for (int q = tid; q < body; q += nt) {
      copy16(dst + head + q * kVec<T>, src + head + q * kVec<T>);
    }
    if (tid < head) copy1(dst + tid, src + tid);
    for (int e = head + body * kVec<T> + tid; e < len; e += nt) copy1(dst + e, src + e);
  }
  const int d0 = p.band_start[b];
  const int nd = p.band_start[b + 1] - d0;
  V* ds = reinterpret_cast<V*>(buf + p.xs_cap);
  if constexpr (sizeof(V) == 2) {
    // unit u of a row whose first element lies at phase ph against 4
    // bytes: elements 2u - ph and 2u - ph + 1 of the row (the first is
    // the element before the row when u = 0 and ph = 1, the second is not
    // read past the row's end) into places 2u and 2u + 1 of its slot
    const int stride = data_stride<V>(p.tile);
    const int units = (rows + 2) / 2;
    for (int e = tid; e < nd * units; e += nt) {
      const int dd = e / units, u = e - dd * units;
      const int64_t at = static_cast<int64_t>(d0 + dd) * n + i0;
      const int first = 2 * u - static_cast<int>(at & 1);
      if (first < rows) {
        copy4(ds + dd * stride + 2 * u, data + at + first, first + 1 < rows ? 4 : 2);
      }
    }
  } else {
    for (int e = tid; e < nd * rows; e += nt) {
      const int dd = e / rows, r = e - dd * rows;
      copy1(ds + dd * p.tile + r, data + static_cast<int64_t>(d0 + dd) * n + i0 + r);
    }
  }
}

// D: the data's (value) type; V: elements of X a lane reads at once
// (kVec<T>, or 1); G: column groups a lane (a lane's columns are (lane + g
// * lanes) * V + [0, V)).
template <typename D, typename T, int V, int G>
__global__ void __launch_bounds__(kMaxThreads)
tiled_kernel(const __grid_constant__ Plan p, int n, int k,
             const D* __restrict__ data, const T* __restrict__ x,
             T* __restrict__ y) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // a buffer's bytes: a multiple of 16 (xs_cap and ds_cap are whole
  // 16-byte pieces of their types)
  const int buf_bytes = p.xs_cap * static_cast<int>(sizeof(T)) +
                        p.ds_cap * static_cast<int>(sizeof(D));
  const int tid = threadIdx.x;
  const int lanes = 1 << p.lanes_log2;
  const int lane = tid & (lanes - 1);
  const int slot = tid >> p.lanes_log2;
  const int slots = blockDim.x >> p.lanes_log2;
  const int i0 = blockIdx.x * p.tile;
  const int rows = min(p.tile, n - i0);

  T acc[kMaxRowsPerThread][G * V];
#pragma unroll
  for (int j = 0; j < kMaxRowsPerThread; ++j) {
#pragma unroll
    for (int e = 0; e < G * V; ++e) acc[j][e] = T(0);
  }

  if (p.n_bands > 0) {
    stage(p, 0, n, k, i0, rows, data, x, reinterpret_cast<T*>(smem_raw));
    commit();
  }
  const int dstride = data_stride<D>(p.tile);
  for (int b = 0; b < p.n_bands; ++b) {
    const T* buf = reinterpret_cast<const T*>(smem_raw + (b & 1) * buf_bytes);
    if (b + 1 < p.n_bands) {
      stage(p, b + 1, n, k, i0, rows, data, x,
            reinterpret_cast<T*>(smem_raw + ((b + 1) & 1) * buf_bytes));
      commit();
      wait_groups<1>();
    } else {
      wait_groups<0>();
    }
    __syncthreads();
    int r0, r1;
    band_window(p, b, n, i0, rows, r0, r1);
    const T* xs = buf + window_pad(x, r0, k);  // X row r0 of the window
    const int d0 = p.band_start[b], d1 = p.band_start[b + 1];
    for (int d = d0; d < d1; ++d) {
      const int off = p.offsets[d];
      // the data row's slot; a 2-byte row sits at its phase in it
      const D* dcol = reinterpret_cast<const D*>(buf + p.xs_cap) + (d - d0) * dstride +
                      (sizeof(D) == 2 ? static_cast<int>((static_cast<int64_t>(d) * n + i0) & 1)
                                      : 0);
#pragma unroll
      for (int j = 0; j < kMaxRowsPerThread; ++j) {
        const int row = slot + j * slots;
        const int src = i0 + row + off;  // the X row; in [r0, r1) if in [0, n)
        if (j < p.rows_per_thread && row < rows && src >= 0 && src < n) {
          const T a = widen<T>(dcol[row]);
          const T* xr = xs + (src - r0) * k;
          if constexpr (V == 1) {
#pragma unroll
            for (int g = 0; g < G; ++g) {
              const int c = lane + (g << p.lanes_log2);
              if (c < k) acc[j][g] = fma_rn(a, xr[c], acc[j][g]);
            }
          } else {
            const int c = lane * V;
            if (c < k) {
              Vec<T>::fma(a, *reinterpret_cast<const typename Vec<T>::type*>(xr + c),
                          acc[j]);
            }
          }
        }
      }
    }
    __syncthreads();  // before band b + 2 is staged into this buffer
  }

#pragma unroll
  for (int j = 0; j < kMaxRowsPerThread; ++j) {
    const int row = slot + j * slots;
    if (j < p.rows_per_thread && row < rows) {
      T* yr = y + static_cast<int64_t>(i0 + row) * k;
      if constexpr (V == 1) {
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const int c = lane + (g << p.lanes_log2);
          if (c < k) yr[c] = acc[j][g];
        }
      } else {
        const int c = lane * V;
        if (c < k) *reinterpret_cast<typename Vec<T>::type*>(yr + c) = Vec<T>::pack(acc[j]);
      }
    }
  }
}

template <typename D, typename T>
int tiled(int n, int k, int vector, int threads, int blocks, int smem_bytes,
          const void* plan, const void* data, const void* x, void* y,
          void* stream) {
  if (n > 0) {
    const Plan& p = *static_cast<const Plan*>(plan);
    const auto s = static_cast<cudaStream_t>(stream);
    const auto* d = static_cast<const D*>(data);
    const auto* xx = static_cast<const T*>(x);
    auto* yy = static_cast<T*>(y);
    if (vector == 1) {
      tiled_kernel<D, T, 1, 2><<<blocks, threads, smem_bytes, s>>>(p, n, k, d, xx, yy);
    } else if (vector == kVec<T>) {
      tiled_kernel<D, T, kVec<T>, 1><<<blocks, threads, smem_bytes, s>>>(p, n, k, d, xx,
                                                                        yy);
    } else {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename D, typename T>
cudaError_t allow_smem(int bytes) {
  cudaError_t e = cudaFuncSetAttribute(tiled_kernel<D, T, 1, 2>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(tiled_kernel<D, T, kVec<T>, 1>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace

extern "C" {

const char* dia_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The plan's layout and limits, checked by the host when it loads the
// library: sizeof(Plan), kMaxDiags, kMaxRowsPerThread, kMaxThreads.
int dia_plan_bytes() { return static_cast<int>(sizeof(Plan)); }
int dia_max_diags() { return kMaxDiags; }
int dia_max_rows_per_thread() { return kMaxRowsPerThread; }
int dia_max_threads() { return kMaxThreads; }

// The row-chunk design's layout and instances: sizeof(RowPlan), and the
// diagonals a chunk of row_kernel<., ., k, r, c> (0 where it has no
// instance).
int dia_row_plan_bytes() { return static_cast<int>(sizeof(RowPlan)); }
int dia_row_chunk(int k, int r, int c) {
  return row_instance(k, r, c) ? row_chunk(c, r) : 0;
}

// Let the tiled kernels take as much dynamic shared memory as a block of
// the current device may (above 48 KB a kernel must opt in); once.
int dia_allow_smem() {
  int device = 0, bytes = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (e == cudaSuccess) e = allow_smem<double, double>(bytes);
  if (e == cudaSuccess) e = allow_smem<float, float>(bytes);
  if (e == cudaSuccess) e = allow_smem<float, double>(bytes);
  if (e == cudaSuccess) e = allow_smem<__nv_bfloat16, float>(bytes);
  if (e == cudaSuccess) e = allow_smem<__nv_bfloat16, double>(bytes);
  return static_cast<int>(e);
}

// Entry points: `_f64`, `_f32` (values of X's type) and `_{V}{T}` for
// values of a narrower type V.
#define DIA_ENTRIES(SUFFIX, V, T)                                              \
  int dia_spmv_first_##SUFFIX(int64_t n, int n_diags, int k, const void* offsets, \
                              const void* data, const void* x, void* y,        \
                              void* stream) {                                  \
    return first_design<V, T>(n, n_diags, k, offsets, data, x, y, stream);    \
  }                                                                            \
  int dia_spmv_row_##SUFFIX(int n, int k, int rows_per_thread, int cols,     \
                            int threads, int blocks, const void* plan,        \
                            const void* data, const void* x, void* y,         \
                            void* stream) {                                    \
    return row_design<V, T>(n, k, rows_per_thread, cols, threads, blocks, plan, \
                            data, x, y, stream);                               \
  }                                                                            \
  int dia_spmv_tiled_##SUFFIX(int n, int k, int vector, int threads, int blocks, \
                              int smem_bytes, const void* plan, const void* data, \
                              const void* x, void* y, void* stream) {          \
    return tiled<V, T>(n, k, vector, threads, blocks, smem_bytes, plan, data, x, \
                       y, stream);                                             \
  }

DIA_ENTRIES(f64, double, double)
DIA_ENTRIES(f32, float, float)
DIA_ENTRIES(f32f64, float, double)
DIA_ENTRIES(bf16f32, __nv_bfloat16, float)
DIA_ENTRIES(bf16f64, __nv_bfloat16, double)
#undef DIA_ENTRIES

}  // extern "C"
