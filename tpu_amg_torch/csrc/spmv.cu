// Sparse matrix-vector / matrix-multivector kernels for Hopper (sm_90a).
//
// Two kernels carry every sparse apply of the solve (A, P and R of each
// sparse multigrid level) and of the setup bootstrap (A times a block of
// near-null candidates):
//
//   K1 csr_spmv_capped  Y = A_cap X, over the first `cap` entries of each
//                       CSR row.  Replaces the WELL SpMV Pallas kernel
//                       (tpu_amg/ops/well_pallas.py `_kernel`).
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
// a column index and a gathered X row, for 2k flops.  This first version
// is deliberately simple (vector CSR: a group of G lanes per row, lanes
// take consecutive entries, a shuffle reduce within the group); speed is
// the work of later changes.  Sums accumulate in the value type.
//
// The host side (tpu_amg_torch/ops/spmv.py) allocates every output,
// passes PyTorch's current stream, and checks the returned
// cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// One group of G lanes (G a power of two, <= 32) per row.  Every lane of
// a warp reaches each shuffle: rows past the end run empty loops instead
// of returning early.
template <typename T, int G>
__global__ void csr_capped_kernel(int64_t n_rows, int k,
                                  const int64_t* __restrict__ indptr,
                                  const int32_t* __restrict__ indices,
                                  const T* __restrict__ vals,
                                  const T* __restrict__ x,
                                  T* __restrict__ y) {
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t row = tid / G;
  const int lane = static_cast<int>(tid % G);
  const bool active = row < n_rows;
  const int64_t start = active ? indptr[row] : 0;
  const int64_t end = active ? indptr[row + 1] : 0;
  for (int c = 0; c < k; ++c) {
    T acc = T(0);
    for (int64_t j = start + lane; j < end; j += G) {
      acc += vals[j] * x[static_cast<int64_t>(indices[j]) * k + c];
    }
#pragma unroll
    for (int off = G / 2; off > 0; off >>= 1) {
      acc += __shfl_down_sync(0xffffffffu, acc, off, G);
    }
    if (active && lane == 0) {
      y[row * k + c] = acc;
    }
  }
}

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

template <typename T, int G>
void launch_capped(int64_t n_rows, int k, const int64_t* indptr,
                   const int32_t* indices, const T* vals, const T* x, T* y,
                   cudaStream_t stream) {
  const int64_t threads = n_rows * G;
  const unsigned blocks = static_cast<unsigned>((threads + kThreads - 1) / kThreads);
  csr_capped_kernel<T, G><<<blocks, kThreads, 0, stream>>>(
      n_rows, k, indptr, indices, vals, x, y);
}

template <typename T>
int csr_spmv_capped(int64_t n_rows, int k, int group, const void* indptr,
                    const void* indices, const void* vals, const void* x,
                    void* y, void* stream) {
  if (n_rows > 0) {
    auto ip = static_cast<const int64_t*>(indptr);
    auto ix = static_cast<const int32_t*>(indices);
    auto v = static_cast<const T*>(vals);
    auto xx = static_cast<const T*>(x);
    auto yy = static_cast<T*>(y);
    auto s = static_cast<cudaStream_t>(stream);
    switch (group) {
      case 2: launch_capped<T, 2>(n_rows, k, ip, ix, v, xx, yy, s); break;
      case 4: launch_capped<T, 4>(n_rows, k, ip, ix, v, xx, yy, s); break;
      case 8: launch_capped<T, 8>(n_rows, k, ip, ix, v, xx, yy, s); break;
      case 16: launch_capped<T, 16>(n_rows, k, ip, ix, v, xx, yy, s); break;
      case 32: launch_capped<T, 32>(n_rows, k, ip, ix, v, xx, yy, s); break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
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

int csr_spmv_capped_f64(int64_t n_rows, int k, int group, const void* indptr,
                        const void* indices, const void* vals, const void* x,
                        void* y, void* stream) {
  return csr_spmv_capped<double>(n_rows, k, group, indptr, indices, vals, x, y, stream);
}

int csr_spmv_capped_f32(int64_t n_rows, int k, int group, const void* indptr,
                        const void* indices, const void* vals, const void* x,
                        void* y, void* stream) {
  return csr_spmv_capped<float>(n_rows, k, group, indptr, indices, vals, x, y, stream);
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
