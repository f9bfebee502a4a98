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
//   K2 coo_patch        Y[r_t, :] += v_t X[c_t, :] for the entries of rows
//                       longer than `cap`.  Replaces the stray-patch Pallas
//                       kernel (tpu_amg/ops/well_pallas.py `_stray_kernel`).
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
// value and index once, with X rows read contiguously across lanes.  K2
// is one atomic add per (tail entry, column).  Sums accumulate in the
// value type.
//
// The host side (tpu_amg_torch/ops/spmv.py) builds the row-block table,
// allocates every output, passes PyTorch's current stream, and checks the
// returned cudaGetLastError().

#include "csr_rowblock.cuh"

namespace {

constexpr int kThreads = 256;

// One thread per (tail entry, column); rows repeat across entries, so the
// adds are atomic (native for double on sm_60 and later).
template <typename T>
__global__ void coo_patch_kernel(int64_t n_entries, int k,
                                 const int32_t* __restrict__ rows,
                                 const int32_t* __restrict__ cols,
                                 const T* __restrict__ vals,
                                 const T* __restrict__ x,
                                 T* __restrict__ y) {
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (tid >= n_entries * k) return;
  const int64_t t = tid / k;
  const int c = static_cast<int>(tid % k);
  atomicAdd(&y[static_cast<int64_t>(rows[t]) * k + c],
            vals[t] * x[static_cast<int64_t>(cols[t]) * k + c]);
}

template <typename T>
int csr_spmv_capped(int n_blocks, int k, const void* block_rows,
                    const void* block_ptr, const void* indptr,
                    const void* indices, const void* vals, const void* x,
                    void* y, void* stream) {
  const int code = rowblock::launch<T, rowblock::kFull>(
      n_blocks, k, static_cast<const int*>(block_rows),
      static_cast<const int*>(block_ptr), static_cast<const int64_t*>(indptr),
      static_cast<const int32_t*>(indices), static_cast<const T*>(vals),
      static_cast<const T*>(x), T(0), static_cast<T*>(y),
      static_cast<cudaStream_t>(stream));
  if (code != 0) return code;
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int coo_patch(int64_t n_entries, int k, const void* rows, const void* cols,
              const void* vals, const void* x, void* y, void* stream) {
  if (n_entries > 0) {
    const int64_t threads = n_entries * k;
    const unsigned blocks = static_cast<unsigned>((threads + kThreads - 1) / kThreads);
    coo_patch_kernel<T><<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        n_entries, k, static_cast<const int32_t*>(rows),
        static_cast<const int32_t*>(cols), static_cast<const T*>(vals),
        static_cast<const T*>(x), static_cast<T*>(y));
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

int csr_spmv_capped_f64(int n_blocks, int k, const void* block_rows,
                        const void* block_ptr, const void* indptr,
                        const void* indices, const void* vals, const void* x,
                        void* y, void* stream) {
  return csr_spmv_capped<double>(n_blocks, k, block_rows, block_ptr, indptr,
                                 indices, vals, x, y, stream);
}

int csr_spmv_capped_f32(int n_blocks, int k, const void* block_rows,
                        const void* block_ptr, const void* indptr,
                        const void* indices, const void* vals, const void* x,
                        void* y, void* stream) {
  return csr_spmv_capped<float>(n_blocks, k, block_rows, block_ptr, indptr,
                                indices, vals, x, y, stream);
}

int coo_patch_f64(int64_t n_entries, int k, const void* rows, const void* cols,
                  const void* vals, const void* x, void* y, void* stream) {
  return coo_patch<double>(n_entries, k, rows, cols, vals, x, y, stream);
}

int coo_patch_f32(int64_t n_entries, int k, const void* rows, const void* cols,
                  const void* vals, const void* x, void* y, void* stream) {
  return coo_patch<float>(n_entries, k, rows, cols, vals, x, y, stream);
}

}  // extern "C"
