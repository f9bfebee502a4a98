// Stage ablations of the capped CSR SpMV (K1) for Hopper (sm_90a).
//
//   KW csr_spmv_stages  K1 with one of its stages taken out, on K1's own
//                       capped CSR and row-block table.  Replaces the WELL
//                       prototype and ablation Pallas kernels of tools/:
//                       well2proto.py `make_v3_kernel` (W1),
//                       `dataonly_call` (W2), `make_v2_kernel` (W3),
//                       wellablate.py `make_kernel` (W4) and
//                       wellablate2.py `make_kernel` (W5).
//
// K1 (csr_rowblock.cuh) spends its time in five stages: the block's
// bounds and row pointers, the value and index stream, the gather of
// x[c_j], the reduce of each row from shared memory, and the write of y.
// The modes take stages out one at a time so that each mode's time, held
// against the bytes it must move, attributes K1's time to a stage
// (j over the capped entries of row r):
//
//   full            y[r] = sum_j v_j x[c_j]             (K1 itself, bitwise:
//                                                       the same template)
//   nogather        y[r] = x[r] sum_j (v_j + zero c_j)  (indices read, x[r]
//                                                       read contiguously)
//   nored           P[j] = v_j x[c_j]                   (no shared memory, no
//                                                       reduce, no row pointers)
//   nogather_nored  P[j] = v_j + zero c_j               (the two combined)
//   streamonly      y[r] = sum_j (v_j + zero c_j)       (no x read at all)
//   dataonly        y[r] = sum_j v_j                    (no index read)
//   rowgroup        y[r] = sum_j v_j x[c_j]             (the first K1: a
//                                                       group of G lanes a
//                                                       row, a shuffle)
//
// `zero` is a runtime 0 so that the compiler keeps the index loads.
// Every mode is bound by bytes, never by operations.  The modes other
// than rowgroup share K1's launch shape (a thread block of S / 4 threads
// per row block, the same table, the same loads), so that a difference in time is
// the stage's and not the layout's; rowgroup keeps the design K1 had
// before, so that one run prints the old design, the new one and the
// library side by side.  The TPU harnesses' window tables, passes and
// MXU merges have no counterpart: the CSR kernel has no such layout.
//
// The host side (tpu_amg_torch/ops/spmv_stages.py) allocates the output,
// passes PyTorch's current stream and checks the returned
// cudaGetLastError().

#include "csr_rowblock.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRowGroup = 6;

// The first K1 at k = 1: one group of G lanes (a power of two, <= 32) per
// row, lanes on consecutive entries, a shuffle reduce.  Every lane of a
// warp reaches each shuffle: rows past the end run empty loops.
template <typename T, int G>
__global__ void rowgroup_kernel(int64_t n_rows,
                                const int64_t* __restrict__ indptr,
                                const int32_t* __restrict__ indices,
                                const T* __restrict__ vals,
                                const T* __restrict__ x, T* __restrict__ y) {
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t row = tid / G;
  const int lane = static_cast<int>(tid % G);
  const bool active = row < n_rows;
  const int64_t start = active ? indptr[row] : 0;
  const int64_t end = active ? indptr[row + 1] : 0;
  T acc = T(0);
  for (int64_t j = start + lane; j < end; j += G) {
    acc += vals[j] * x[static_cast<int64_t>(indices[j])];
  }
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) {
    acc += __shfl_down_sync(0xffffffffu, acc, off, G);
  }
  if (active && lane == 0) y[row] = acc;
}

template <typename T, int G>
void launch_rowgroup(int64_t n_rows, const int64_t* ip, const int32_t* ix,
                     const T* v, const T* x, T* y, cudaStream_t s) {
  const int64_t threads = n_rows * G;
  const unsigned blocks = static_cast<unsigned>((threads + kThreads - 1) / kThreads);
  rowgroup_kernel<T, G><<<blocks, kThreads, 0, s>>>(n_rows, ip, ix, v, x, y);
}

template <typename T>
int rowgroup(int64_t n_rows, int group, const int64_t* ip, const int32_t* ix,
             const T* v, const T* x, T* y, cudaStream_t s) {
  if (n_rows <= 0) return 0;
  switch (group) {
    case 2: launch_rowgroup<T, 2>(n_rows, ip, ix, v, x, y, s); break;
    case 4: launch_rowgroup<T, 4>(n_rows, ip, ix, v, x, y, s); break;
    case 8: launch_rowgroup<T, 8>(n_rows, ip, ix, v, x, y, s); break;
    case 16: launch_rowgroup<T, 16>(n_rows, ip, ix, v, x, y, s); break;
    case 32: launch_rowgroup<T, 32>(n_rows, ip, ix, v, x, y, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}

template <typename T>
int csr_spmv_stages(int64_t n_rows, int n_blocks, int group, int mode,
                    const void* block_rows, const void* block_ptr,
                    const void* indptr, const void* indices, const void* vals,
                    const void* x, T zero, void* y, void* stream) {
  using namespace rowblock;
  auto br = static_cast<const int*>(block_rows);
  auto bp = static_cast<const int*>(block_ptr);
  auto ip = static_cast<const int64_t*>(indptr);
  auto ix = static_cast<const int32_t*>(indices);
  auto v = static_cast<const T*>(vals);
  auto xx = static_cast<const T*>(x);
  auto yy = static_cast<T*>(y);
  auto s = static_cast<cudaStream_t>(stream);
  int code = 0;
#define STAGES_CASE(m)                                                  \
  case m:                                                               \
    code = launch<T, T, m>(n_blocks, 1, br, bp, ip, ix, v, xx, zero, yy, s); \
    break;
  switch (mode) {
    STAGES_CASE(kFull)
    STAGES_CASE(kNoGather)
    STAGES_CASE(kNoRed)
    STAGES_CASE(kNoGatherNoRed)
    STAGES_CASE(kStreamOnly)
    STAGES_CASE(kDataOnly)
    case kRowGroup: code = rowgroup<T>(n_rows, group, ip, ix, v, xx, yy, s); break;
    default: code = static_cast<int>(cudaErrorInvalidValue);
  }
#undef STAGES_CASE
  if (code != 0) return code;
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* stages_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The S this library was compiled for: K1's, so that `full` is K1.
int row_block_entries() { return rowblock::kEntries; }

int csr_spmv_stages_f64(int64_t n_rows, int n_blocks, int group,
                        int mode, const void* block_rows, const void* block_ptr,
                        const void* indptr, const void* indices,
                        const void* vals, const void* x, double zero, void* y,
                        void* stream) {
  return csr_spmv_stages<double>(n_rows, n_blocks, group, mode,
                                 block_rows, block_ptr, indptr, indices, vals,
                                 x, zero, y, stream);
}

int csr_spmv_stages_f32(int64_t n_rows, int n_blocks, int group,
                        int mode, const void* block_rows, const void* block_ptr,
                        const void* indptr, const void* indices,
                        const void* vals, const void* x, float zero, void* y,
                        void* stream) {
  return csr_spmv_stages<float>(n_rows, n_blocks, group, mode,
                                block_rows, block_ptr, indptr, indices, vals, x,
                                zero, y, stream);
}

}  // extern "C"
