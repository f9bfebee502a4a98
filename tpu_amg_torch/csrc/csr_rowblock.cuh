// Row-block streaming CSR SpMV / SpMM for Hopper (sm_90a): the body of K1
// `csr_spmv_capped` (csrc/spmv.cu) and of its stage ablation
// `csr_spmv_stages` (csrc/spmv_stages.cu), which instantiate it.  At k = 1
// it is K1.  At k > 1 it is K1's first SpMM design, the reference on the
// card (`launch_first_spmm`): the wrapper (ops/spmv.py `k1_design`)
// routes it where an X row is more than 64 and fewer than 256 bytes, and
// where it is shorter on a matrix whose capped rows average more than
// SPMM_SHORT_ROWS entries;
// elsewhere the staged SpMM of csr_spmm.cuh runs, which gives its bits.
// What bounds it at k > 1: each entry gathers its whole X row,
// nnz·k·itemsize bytes from L1/L2, one 8-byte column a lane, 64 threads
// a block, 4 entries' loads in flight, after the block's copies are all
// in; the staged design reads 16 bytes a lane in one pass, each X row
// once a block where it stages them.
//
// The design is the CSR-Stream kernel of CSR-Adaptive (Greathouse & Daga,
// SC'14) on K1's capped CSR.  The host (tpu_amg_torch/ops/spmv.py
// `row_blocks`) cuts the rows once into row blocks of consecutive rows
// whose entry range [indptr[r0], indptr[r1]) spans at most S / 4 aligned
// 4-entry chunks (so at most S entries, S = ROWBLOCK_ENTRIES, fixed when
// the library is compiled) and at most S / 2 rows; the cap
// (64) guarantees that a row fits.  Beside each block's first row the
// table holds its first entry, so a block's bounds are loads of the table
// alone.  One thread block of NT = S / 4 threads a row block, 4 entries a
// thread:
//
//   1. streams the block's whole entry range, values and indices, into
//      registers: entries t, t + NT, t + 2 NT, t + 3 NT of thread t, so
//      that every warp load reads 32 consecutive entries; all loads are
//      issued at once, with the row pointers beside them: no load waits
//      on a per-row pointer;
//   2. k = 1: gathers x[c] for its entries as soon as their indices are
//      in and writes the products to shared memory, in entry order;
//      k > 1: the entries go through 16-byte cp.async copies into shared
//      memory as (value, column) pairs instead;
//   3. k = 1: reduces each row from shared memory with L lanes, L the
//      most (a power of two, 1..32) with which the block's rows take its
//      threads once (for a full block, about the mean row length / 4),
//      each lane summing entries lane, lane + L, ... in order, then a
//      shuffle tree;
//      k > 1: a team of lanes per row, one lane per column of X, so the
//      X[c, 0..k-1] reads of a team are contiguous; each lane sums its
//      row's entries in order, one fma each (several rows share a warp
//      when k <= 16);
//   4. writes y, consecutive rows by consecutive teams.
// Values stream in their stored type V and are widened exactly to T, the
// type of X and Y, before the product (widen.cuh): (V, T) is (f64, f64),
// (f32, f32), (f32, f64), (bf16, f32) or (bf16, f64).  Products and sums
// are in T, in an order fixed by the table: the same result on every run,
// no atomics.  A (T, T) instantiation is the kernel as it was before V.
// Offsets are 32-bit (the host checks that nnz, m·k and n·k fit).
//
// The ablation modes take one stage out of the k = 1 kernel (see
// ops/spmv_stages.py): kFull is K1 itself, so `full` is bitwise K1 by
// construction.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "widen.cuh"

// S, the row block's entries: the host's table (ops/spmv.py
// BLOCK_ENTRIES) must be cut for the same S.  Only the row-block probe
// (tools/rowblocks.py) builds other sizes, with -DROWBLOCK_ENTRIES=S.
// S = 256 (64 threads): the least time over the SA path's K1 launches in
// that probe, on the path's own matrices (PERF.md).
#ifndef ROWBLOCK_ENTRIES
#define ROWBLOCK_ENTRIES 256
#endif

namespace rowblock {

constexpr int kEntries = ROWBLOCK_ENTRIES;
constexpr int kThreads = kEntries / 4;  // 4 entries a thread
static_assert(kEntries % 128 == 0 && kEntries >= 128 && kEntries <= 2048,
              "S: whole warps of 4-entry threads, at most 512 threads");

enum Mode : int {
  kFull = 0,
  kNoGather = 1,
  kNoRed = 2,
  kNoGatherNoRed = 3,
  kStreamOnly = 4,
  kDataOnly = 5,
};

// The SpMM's row block in shared memory: values [S] as stored (V),
// columns [S], row pointers [kRows + 1]; S = 4 NT entries and kRows = 2 NT
// rows at most.  The columns start 16-byte aligned for every V: S V's are
// a multiple of 16 bytes.
template <typename V, int NT>
struct Smem {
  static constexpr int kS = 4 * NT;
  static constexpr int kRows = 2 * NT;
  static constexpr int kBytes =
      kS * static_cast<int>(sizeof(V) + sizeof(int)) +
      (kRows + 1) * static_cast<int>(sizeof(int64_t));
  V* sv;
  int* sc;
  int64_t* off;
  __device__ explicit Smem(unsigned char* smem) {
    sv = reinterpret_cast<V*>(smem);
    sc = reinterpret_cast<int*>(sv + kS);
    off = reinterpret_cast<int64_t*>(sc + kS);
  }
};

// 16 bytes from global to shared memory, of which `bytes` are read and
// the rest zero-filled.
__device__ __forceinline__ void copy16(void* dst, const void* src, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes)
               : "memory");
}

// 8 bytes, of which `bytes` are read and the rest zero-filled: a 4-entry
// chunk of 2-byte values.
__device__ __forceinline__ void copy8(void* dst, const void* src, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void copy8(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(src)
               : "memory");
}

// Wait for this thread's copies; they are then visible to it.
__device__ __forceinline__ void copies_done() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// A row block's rows [r0, r0 + rows) and entries [e0, e1); a0 is e0
// rounded down to a chunk, the origin of the shared arrays.
struct Bounds {
  int r0, rows, e0, e1, a0, chunks;
};

__device__ __forceinline__ Bounds block_bounds(const int* block_rows,
                                               const int* block_ptr, int blk) {
  Bounds b;
  b.r0 = __ldg(block_rows + blk);
  b.rows = __ldg(block_rows + blk + 1) - b.r0;
  b.e0 = __ldg(block_ptr + blk);
  b.e1 = __ldg(block_ptr + blk + 1);
  b.a0 = b.e0 & ~3;
  b.chunks = ((b.e1 + 3) >> 2) - (b.e0 >> 2);
  return b;
}

// Start the SpMM's copies of a row block into shared memory: this
// thread's chunk (entries j0..j0+3; those at or past e1 are not read) of
// the columns and values, and the row pointers.  A chunk of 8- or 4-byte
// values is 2 or 1 copies of 16 bytes; of 2-byte values, one of 8 bytes
// (8-byte aligned: j0 is a multiple of 4 and the values 16-byte aligned).
template <typename V, int NT>
__device__ __forceinline__ void stage(const Bounds& b, const Smem<V, NT>& s,
                                      const int64_t* indptr,
                                      const int32_t* indices, const V* vals) {
  constexpr int kVal = static_cast<int>(sizeof(V));
  const int ch = threadIdx.x;
  if (ch < b.chunks) {
    const int j0 = b.a0 + 4 * ch;
    const int valid = min(4, b.e1 - j0);  // >= 1 for a chunk of the block
    copy16(s.sc + 4 * ch, indices + j0, 4 * valid);
    if constexpr (kVal == 2) {
      copy8(s.sv + 4 * ch, vals + j0, valid * kVal);
    } else {
      constexpr int kPer = 16 / kVal;  // values a copy
#pragma unroll
      for (int h = 0; h < 4 / kPer; ++h) {
        const int n = min(kPer, valid - h * kPer);
        if (n > 0) {
          copy16(s.sv + 4 * ch + h * kPer, vals + j0 + h * kPer, n * kVal);
        }
      }
    }
  }
#pragma unroll
  for (int t = 0; t < (Smem<V, NT>::kRows + NT) / NT; ++t) {
    const int i = threadIdx.x + t * NT;
    if (i <= b.rows) copy8(s.off + i, indptr + b.r0 + i);
  }
}

// Lanes a row in the k = 1 reduce: the most (a power of two, at most 32)
// with which the block's rows take its NT threads once; for a full block
// of S entries that is about the mean row length times NT / S.
template <int NT>
__device__ __forceinline__ int lanes_per_row(int rows) {
  int lanes = 1;
  while (lanes < 32 && 2 * lanes * rows <= NT) lanes *= 2;
  return lanes;
}

// This thread's 4 entries of a row block, at positions pos[t] = t' + t NT
// from a0 (t' the thread): each warp load is 32 consecutive entries, 128
// or 256 contiguous bytes, and so is each warp gather's set of columns (a
// few rows', so few sectors).  Values (widened to T) and columns; those
// outside [e0, e1) zero and not read.
template <typename V, typename T, int NT, bool kColumns>
__device__ __forceinline__ void load_entries(
    const Bounds& b, const int32_t* __restrict__ indices,
    const V* __restrict__ vals, T (&v)[4], int (&c)[4], bool (&in)[4],
    int (&pos)[4]) {
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    pos[t] = static_cast<int>(threadIdx.x) + t * NT;
    const int j = b.a0 + pos[t];
    in[t] = j >= b.e0 && j < b.e1;
    v[t] = in[t] ? widen<T>(__ldg(vals + j)) : T(0);
    c[t] = kColumns && in[t] ? __ldg(indices + j) : 0;
  }
}

// k = 1: one thread block a row block.  Every thread loads its 4 entries
// and the block its row pointers, all at once and waiting on no row
// pointer; each thread gathers x for its entries and writes the products
// to shared memory; then rows are reduced from there.  Reducing modes
// write y (n,); kNoRed / kNoGatherNoRed write the per-entry terms P
// (capped nnz,) with no shared memory, row pointers or reduce.
template <typename V, typename T, int M, int NT>
__global__ void __launch_bounds__(NT, 2048 / NT)
spmv_kernel(const int* __restrict__ block_rows,
            const int* __restrict__ block_ptr,
            const int64_t* __restrict__ indptr,
            const int32_t* __restrict__ indices, const V* __restrict__ vals,
            const T* __restrict__ x, T zero, T* __restrict__ y) {
  constexpr bool kReduce = M != kNoRed && M != kNoGatherNoRed;
  constexpr bool kColumns = M != kDataOnly;
  __shared__ T sv[4 * NT];             // products, in entry order
  __shared__ int64_t off[2 * NT + 1];  // row pointers
  const Bounds b = block_bounds(block_rows, block_ptr, blockIdx.x);
  T v[4], term[4];
  int c[4], pos[4];
  bool in[4];
  load_entries<V, T, NT, kColumns>(b, indices, vals, v, c, in, pos);
  if constexpr (kReduce) {
    for (int i = threadIdx.x; i <= b.rows; i += NT) {
      off[i] = __ldg(indptr + b.r0 + i);
    }
  }
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    if constexpr (M == kFull || M == kNoRed) {
      term[t] = in[t] ? v[t] * __ldg(x + c[t]) : T(0);
    } else if constexpr (M == kDataOnly) {
      term[t] = v[t];
    } else {
      term[t] = v[t] + zero * static_cast<T>(c[t]);
    }
  }
  if constexpr (!kReduce) {
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      if (in[t]) y[b.a0 + pos[t]] = term[t];
    }
  } else {
#pragma unroll
    for (int t = 0; t < 4; ++t) sv[pos[t]] = term[t];
    __syncthreads();  // every product and row pointer is in
    const int lanes = lanes_per_row<NT>(b.rows);
    const int team = threadIdx.x / lanes;
    const int lane = threadIdx.x % lanes;
    const int teams = NT / lanes;
    // the bound is the same for every thread: all reach each shuffle
    for (int base = 0; base < b.rows; base += teams) {
      const int r = base + team;
      T acc = T(0);
      if (r < b.rows) {
        const int end = static_cast<int>(off[r + 1]) - b.a0;
#pragma unroll 4
        for (int j = static_cast<int>(off[r]) - b.a0 + lane; j < end;
             j += lanes) {
          acc += sv[j];
        }
      }
      for (int o = lanes / 2; o > 0; o >>= 1) {
        acc += __shfl_down_sync(0xffffffffu, acc, o, lanes);
      }
      if (r < b.rows && lane == 0) {
        if constexpr (M == kNoGather) acc *= __ldg(x + b.r0 + r);
        y[b.r0 + r] = acc;
      }
    }
  }
}

// k > 1, one row block in shared memory: Y = A X for a row-major X (m, k),
// Y (n, k).  `team` lanes a row (the power of two at or above k, at most
// 32); lane l sums columns l, l + team, ... of its row.
template <typename V, typename T, int NT>
__device__ __forceinline__ void spmm_block(const Bounds& b,
                                           const Smem<V, NT>& s, int k,
                                           int team, const T* __restrict__ x,
                                           T* __restrict__ y) {
  __syncthreads();  // every pair and row pointer is in
  const int lane = threadIdx.x % team;
  const int teams = NT / team;
  for (int r = threadIdx.x / team; r < b.rows; r += teams) {
    const int start = static_cast<int>(s.off[r]) - b.a0;
    const int end = static_cast<int>(s.off[r + 1]) - b.a0;
    T* yr = y + (b.r0 + r) * k;
    for (int col = lane; col < k; col += team) {
      T acc = T(0);
#pragma unroll 4
      for (int j = start; j < end; ++j) {
        acc = fma(widen<T>(s.sv[j]), __ldg(x + s.sc[j] * k + col), acc);
      }
      yr[col] = acc;
    }
  }
}

template <typename V, typename T, int NT>
__global__ void __launch_bounds__(NT)
spmm_kernel(int k, int team, const int* __restrict__ block_rows,
            const int* __restrict__ block_ptr,
            const int64_t* __restrict__ indptr,
            const int32_t* __restrict__ indices, const V* __restrict__ vals,
            const T* __restrict__ x, T* __restrict__ y) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Smem<V, NT> sm(smem);
  const Bounds b = block_bounds(block_rows, block_ptr, blockIdx.x);
  stage<V, NT>(b, sm, indptr, indices, vals);
  copies_done();
  spmm_block<V, T, NT>(b, sm, k, team, x, y);
}

// A thread block of kThreads a row block: k = 1 is y = A x in mode M,
// k > 1 the SpMM (M = kFull); values of type V, X and Y of type T.
template <typename V, typename T, int M>
int launch(int n_blocks, int k, const int* block_rows, const int* block_ptr,
           const int64_t* indptr, const int32_t* indices, const V* vals,
           const T* x, T zero, T* y, cudaStream_t s) {
  if (n_blocks <= 0) return 0;
  if (k == 1) {
    spmv_kernel<V, T, M, kThreads><<<n_blocks, kThreads, 0, s>>>(
        block_rows, block_ptr, indptr, indices, vals, x, zero, y);
  } else {
    int team = 1;
    while (team < k && team < 32) team *= 2;
    spmm_kernel<V, T, kThreads><<<n_blocks, kThreads,
                                  Smem<V, kThreads>::kBytes, s>>>(
        k, team, block_rows, block_ptr, indptr, indices, vals, x, y);
  }
  return 0;
}

}  // namespace rowblock
