// K1's many-column design for Hopper (sm_90a), the staged SpMM: Y = A_cap X
// for a row-major X (m, k) and Y (n, k), k <= 64, over a CappedCSR's own
// SpMM table.  Instantiated by csrc/spmv.cu (`csr_spmm_staged_*`).  The
// wrapper (tpu_amg_torch/ops/spmv.py `csr_spmv_capped`, `k1_design`)
// routes here where X rows are short (at most kStageRow = 64 bytes) and
// the matrix's capped rows average at most SPMM_SHORT_ROWS entries (the
// staged mode), or where X rows are at least SPMM_GATHER_ROW = 256 bytes
// (the gather mode); k = 1 goes to csr_rowblock.cuh's spmv_kernel and
// every other k > 1 to its spmm_kernel, the first SpMM design, kept as
// the reference on the card: the designs give the same bits.
//
// What bounds it.  Each input once: the capped values and their 2-byte
// slots, the row pointers, X (m, k) and Y (n, k); at k = 64 in f64 X and
// Y are most of it.  The first design gathers a whole X row for every
// entry, nnz·k·itemsize bytes from L1/L2 (43 times an entry's own 12
// bytes at f64 k = 64), in 8-byte loads, one column a lane and a pass a
// 32 columns, 64 threads a block, 4 entries' loads in flight.  This
// design:
//
//   (a) staged mode (64 threads a block): stages, once a row block, the
//       distinct X rows the block's entries read, into shared memory
//       with cp.async (16-byte copies where an X row is a whole number
//       of 16-byte vectors, else one a value).  The host (ops/spmv.py
//       `spmm_blocks`) lists each block's distinct columns and gives
//       every entry its slot in that list, and cuts a block whose X rows
//       would pass kColumns rows of shared memory (the rule of the
//       table, not a reaction to a launch that failed): at most 8 KB of
//       X rows and 13.3 KB in all a block, under the 48 KB a launch gets
//       without an attribute.  A block's copies overlap the arithmetic
//       of the other blocks resident on the SM.  It pays on short rows:
//       a block's rows then need a few passes over shared memory where
//       the first design's 64 threads make many dependent passes over
//       L1 (the classical path's matrices at k = 5); on rows of 16
//       entries and more the first design's L1 already keeps the reuse
//       and its blocks fill the SM better;
//   (b) gather mode (128 threads a block): the same blocks and order, no
//       X row staged, each lane reading its 16 bytes of an entry's X row
//       through L1; from 256-byte X rows one pass of 16-byte vectors
//       beats the first design's passes of 8-byte columns;
//   (c) both: each lane owns 16 bytes of adjacent columns (2 f64 or 4
//       f32), read and written as one vector each; a team of the power
//       of two at or above k / VEC lanes a row; the values are widened
//       to T once, as they are staged;
//   (d) both keep the first design's order: each output (row, column) is
//       one thread's sum over the row's entries in entry order, one fma
//       each from +0, so the designs give the same bits.  A chunk of
//       kUnroll entries' reads is issued before their fmas.
//
// Offsets are 32-bit (the host checks that nnz, m·k and n·k fit).

#pragma once

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

#include "widen.cuh"

namespace spmm {

constexpr int kEntries = 512;  // entries a row block, at most
constexpr int kRows = 64;      // rows a row block, at most
constexpr int kColumns = 128;  // distinct columns (staged X rows) a block
constexpr int kUnroll = 4;     // entries' reads issued before their fmas
constexpr int kStageRow = 64;  // bytes of an X row the staged mode takes
constexpr int kStagedThreads = 64;
constexpr int kGatherThreads = 128;

// 16 bytes of T: VEC adjacent columns, loaded and stored as one vector.
template <typename T>
struct Vec;
template <>
struct Vec<double> {
  static constexpr int n = 2;
  using type = double2;
  __device__ __forceinline__ static void split(const type& v, double* o) {
    o[0] = v.x;
    o[1] = v.y;
  }
  __device__ __forceinline__ static type join(const double* o) {
    return make_double2(o[0], o[1]);
  }
};
template <>
struct Vec<float> {
  static constexpr int n = 4;
  using type = float4;
  __device__ __forceinline__ static void split(const type& v, float* o) {
    o[0] = v.x;
    o[1] = v.y;
    o[2] = v.z;
    o[3] = v.w;
  }
  __device__ __forceinline__ static type join(const float* o) {
    return make_float4(o[0], o[1], o[2], o[3]);
  }
};

// kpad: k rounded up to a whole vector, the stride of a staged X row.
template <typename T>
__host__ __device__ constexpr int padded(int k) {
  return (k + Vec<T>::n - 1) / Vec<T>::n * Vec<T>::n;
}

// Lanes a row: the power of two at or above the vectors of a row, at
// most 32.
template <typename T>
inline int team_lanes(int k) {
  int team = 1;
  while (team * Vec<T>::n < k && team < 32) team *= 2;
  return team;
}

// A block's dynamic shared memory for k columns and `width` staged X
// rows at most (the table's widest block); without staging, the entries'
// columns in place of their slots and no X rows.
template <typename T>
inline int smem_bytes(int k, int width, bool stage) {
  return (stage ? width * padded<T>(k) * static_cast<int>(sizeof(T)) : 0) +
         kEntries * static_cast<int>(sizeof(T) + (stage ? 2 : 4)) +
         (kRows + 1) * static_cast<int>(sizeof(int));
}

__device__ __forceinline__ void copy_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

// One value of 8 or 4 bytes.
template <int B>
__device__ __forceinline__ void copy_async(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s),
               "l"(src), "n"(B)
               : "memory");
}

// One thread block a row block of the SpMM table: rows [r0, r0 + rows),
// distinct columns cols[c0 .. c0 + nc), each entry's slot among them.
// `aligned`: k·itemsize a multiple of 16 and X, Y 16-byte aligned.
// kStage false is the gather mode: no X row is staged, each lane reads
// its 16 bytes of an entry's X row from global memory (through L1), the
// entries' columns staged beside their values in place of the slots;
// the same order of sums, so the same bits.
template <typename V, typename T, int NT, bool kStage>
__global__ void __launch_bounds__(NT, 1024 / NT)
staged_kernel(int k, int team, int width, int aligned,
              const int* __restrict__ blk_rows,
              const int* __restrict__ blk_cols,
              const int* __restrict__ cols,
              const int16_t* __restrict__ slots,
              const int32_t* __restrict__ indices,
              const int64_t* __restrict__ indptr, const V* __restrict__ vals,
              const T* __restrict__ x, T* __restrict__ y) {
  constexpr int VEC = Vec<T>::n;
  using VT = typename Vec<T>::type;
  using I = typename std::conditional<kStage, int16_t, int32_t>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  const int kpad = padded<T>(k);
  T* xs = reinterpret_cast<T*>(smem);  // [width][kpad]
  T* sv = xs + (kStage ? width * kpad : 0);  // [kEntries] values, widened
  int* off = reinterpret_cast<int*>(sv + kEntries);  // [kRows + 1]
  I* ss = reinterpret_cast<I*>(off + kRows + 1);  // [kEntries] slots, or columns

  const int tid = threadIdx.x;
  const int r0 = __ldg(blk_rows + blockIdx.x);
  const int rows = __ldg(blk_rows + blockIdx.x + 1) - r0;
  const int c0 = kStage ? __ldg(blk_cols + blockIdx.x) : 0;
  const int nc = kStage ? __ldg(blk_cols + blockIdx.x + 1) - c0 : 0;

  // (a) the block's distinct X rows, into shared memory
  if (!kStage) {
  } else if (aligned) {
    const int per = k / VEC;  // 16-byte copies a row
    for (int i = tid; i < nc * per; i += NT) {
      const int slot = i / per;
      const int part = i - slot * per;
      const int col = __ldg(cols + c0 + slot);
      copy_async16(xs + slot * kpad + part * VEC, x + col * k + part * VEC);
    }
  } else {
    for (int i = tid; i < nc * k; i += NT) {
      const int slot = i / k;
      const int c = i - slot * k;
      const int col = __ldg(cols + c0 + slot);
      copy_async<static_cast<int>(sizeof(T))>(xs + slot * kpad + c,
                                              x + col * k + c);
    }
  }
  // the entries (values widened to T once) and row pointers, meanwhile
  const int e0 = static_cast<int>(__ldg(indptr + r0));
  const int ne = static_cast<int>(__ldg(indptr + r0 + rows)) - e0;
  for (int j = tid; j < ne; j += NT) {
    sv[j] = widen<T>(__ldg(vals + e0 + j));
    if constexpr (kStage) {
      ss[j] = __ldg(slots + e0 + j);
    } else {
      ss[j] = __ldg(indices + e0 + j);
    }
  }
  for (int i = tid; i <= rows; i += NT) {
    off[i] = static_cast<int>(__ldg(indptr + r0 + i)) - e0;
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // (b), (c): a team of lanes a row, VEC adjacent columns a lane
  const int lane = tid % team;
  const int col0 = lane * VEC;
  if (col0 >= k) return;  // no barrier follows
  for (int r = tid / team; r < rows; r += NT / team) {
    const int start = off[r];
    const int end = off[r + 1];
    T acc[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] = T(0);
    for (int j = start; j < end; j += kUnroll) {
      T v[kUnroll];
      T xv[kUnroll][VEC];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (j + u < end) {
          v[u] = sv[j + u];
          if constexpr (kStage) {
            Vec<T>::split(*reinterpret_cast<const VT*>(
                              xs + static_cast<int>(ss[j + u]) * kpad + col0),
                          xv[u]);
          } else if (aligned) {
            Vec<T>::split(__ldg(reinterpret_cast<const VT*>(
                              x + ss[j + u] * k + col0)),
                          xv[u]);
          } else {
#pragma unroll
            for (int i = 0; i < VEC; ++i) {
              xv[u][i] = col0 + i < k ? __ldg(x + ss[j + u] * k + col0 + i)
                                      : T(0);
            }
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (j + u < end) {
#pragma unroll
          for (int i = 0; i < VEC; ++i) acc[i] = fma(v[u], xv[u][i], acc[i]);
        }
      }
    }
    T* yr = y + (r0 + r) * k + col0;
    if (aligned) {
      *reinterpret_cast<VT*>(yr) = Vec<T>::join(acc);
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        if (col0 + i < k) yr[i] = acc[i];
      }
    }
  }
}

// Launch on a table of n_blocks row blocks whose widest block stages
// `width` X rows: the staged mode (`stage`, X rows of at most kStageRow
// bytes) or the gather mode.  A refused launch is left in
// cudaGetLastError().
template <typename V, typename T>
int launch_staged(int n_blocks, int k, int width, int stage, int aligned,
                  const int* blk_rows, const int* blk_cols, const int* cols,
                  const int16_t* slots, const int32_t* indices,
                  const int64_t* indptr, const V* vals, const T* x, T* y,
                  cudaStream_t s) {
  if (k < 1 || k > 64 || width < 0 || width > kColumns ||
      (stage && k * static_cast<int>(sizeof(T)) > kStageRow)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_blocks <= 0) return 0;
  const int team = team_lanes<T>(k);
  if (stage) {
    staged_kernel<V, T, kStagedThreads, true>
        <<<n_blocks, kStagedThreads, smem_bytes<T>(k, width, true), s>>>(
            k, team, width, aligned, blk_rows, blk_cols, cols, slots,
            indices, indptr, vals, x, y);
  } else {
    staged_kernel<V, T, kGatherThreads, false>
        <<<n_blocks, kGatherThreads, smem_bytes<T>(k, width, false), s>>>(
            k, team, width, aligned, blk_rows, blk_cols, cols, slots,
            indices, indptr, vals, x, y);
  }
  return 0;
}

}  // namespace spmm
